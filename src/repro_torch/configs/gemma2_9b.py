"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000, local+global alternating, logit softcap. [arXiv:2408.00118]"""

from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    act="gelu",
    gated=True,                      # GeGLU
    attn_softcap=50.0,
    final_softcap=30.0,
    sandwich_norm=True,
    window=4096,
    embed_scale=True,
    pattern=("attn_local", "attn"),  # alternating local/global
    rope_theta=10_000.0,
    norm_eps=1e-6,
    microbatches=(("train_4k", 4),),
)

SMOKE = reduced(CONFIG)
