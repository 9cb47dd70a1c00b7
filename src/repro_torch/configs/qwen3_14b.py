"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936, qk_norm. [hf:Qwen/Qwen3-8B family; hf]"""

from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab=151936,
    act="silu",
    gated=True,
    qk_norm=True,
    head_pad=8,   # zero heads: TP-shardable flat head dim (exact)
    qkv_bias=False,
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
    microbatches=(("train_4k", 4),),
)

SMOKE = reduced(CONFIG)
