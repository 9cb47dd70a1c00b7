"""rwkv6-3b (Finch) [ssm] — 32L d_model=2560 (attention-free) d_ff=8960
vocab=65536, data-dependent decay. [arXiv:2404.05892; hf]

Attention-free (O(1) state) => the long_500k cell RUNS for this arch.
"""

from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                       # informational: 2560 / 64
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,                        # channel-mix expansion (3.5x)
    vocab=65536,
    act="relu_sq",
    gated=False,
    pattern=("rwkv",),
    rwkv_head_dim=64,
    norm_eps=1e-5,
    microbatches=(("train_4k", 4),),
)

SMOKE = reduced(CONFIG)
