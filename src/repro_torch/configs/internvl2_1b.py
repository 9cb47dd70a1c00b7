"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655, InternViT frontend + Qwen2-0.5B-class backbone.
[arXiv:2404.16821; hf]

The ViT frontend is a stub, as in the reference: the caller passes
precomputed patch embeddings (B, n_patches, d_model) as ``patches=``, which
the model prepends to the text embeddings.
"""

from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151655,
    act="silu",
    gated=True,
    qkv_bias=True,                    # qwen2-class backbone
    head_pad=2,   # zero heads: TP-shardable flat head dim (exact)
    rope_theta=1_000_000.0,
    frontend="vision",
    n_patches=256,
    microbatches=(("train_4k", 8),),
    norm_eps=1e-6,
)

SMOKE = reduced(CONFIG)
