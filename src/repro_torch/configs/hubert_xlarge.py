"""hubert-xlarge [audio] — 48L d_model=1280 16H (MHA kv=16) d_ff=5120
vocab=504, encoder-only. [arXiv:2106.07447; unverified]

Encoder-only => no decode step; decode_32k / long_500k cells are N/A.
The CNN waveform frontend is a stub, as in the reference: the caller passes
precomputed frame embeddings (B, T, d_model) as ``lm.forward(frames=...)``.
"""

from repro_torch.configs.base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,                        # k-means target codebook
    act="gelu",
    gated=False,                      # plain GELU MLP
    causal=False,                     # bidirectional encoder
    frontend="audio",
    rope_theta=10_000.0,              # (conv rel-pos in the original; RoPE
    norm_eps=1e-5,                    #  stands in, as in the reference)
    microbatches=(("train_4k", 4),),
)

SMOKE = reduced(CONFIG)
