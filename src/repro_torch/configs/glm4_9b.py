"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552, partial RoPE, QKV bias. [hf:THUDM/glm-4-9b; hf]"""

from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=151552,
    act="silu",
    gated=True,
    qkv_bias=True,
    rope_fraction=0.5,               # GLM partial rotary
    rope_theta=10_000.0,
    norm_eps=1.5625e-7,
    microbatches=(("train_4k", 4),),
)

SMOKE = reduced(CONFIG)
