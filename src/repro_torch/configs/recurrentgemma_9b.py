"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000, RG-LRU + local attention at 1:2 (pattern rec,rec,attn_local).
[arXiv:2402.19427; unverified]

Sub-quadratic (local window 2048 + O(1) recurrent state) => the long_500k
cell RUNS for this arch.
"""

from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,                      # 12 x (rec, rec, attn_local) + 2 rec
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,                     # MQA
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    act="gelu",
    gated=True,                       # GeGLU
    window=2048,
    embed_scale=True,
    pattern=("recurrent", "recurrent", "attn_local"),
    conv_width=4,
    lru_width=4096,
    rope_theta=10_000.0,
    norm_eps=1e-6,
    microbatches=(("train_4k", 8),),
)

SMOKE = reduced(CONFIG)
