"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Note (DESIGN.md §Arch-applicability): the HF release interleaves NoPE
layers and fuses vision early; this config reproduces the text tower with
RoPE throughout and MoE on every layer (the pool's stated arity: 16e
top-1), with the early-fusion frontend out of scope for the LM shapes.
"""

from repro_torch.configs.base import ArchConfig, MoESpec, reduced

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,                        # dense-equivalent / shared width
    vocab=202048,
    act="silu",
    gated=True,
    rope_theta=500_000.0,
    head_pad=8,   # zero heads: TP-shardable flat head dim (exact)
    moe=MoESpec(
        n_experts=16,
        top_k=1,
        d_ff_expert=8192,
        shared_d_ff=8192,
        capacity_factor=1.25,
        router_aux_weight=0.01,
    ),
    norm_eps=1e-5,
    microbatches=(("train_4k", 8),),
)

SMOKE = reduced(CONFIG)
