"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (MHA kv=16) d_ff=1408
vocab=151936, 60 routed experts top-4 + 4-expert-wide shared path (5632).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""

from repro_torch.configs.base import ArchConfig, MoESpec, reduced

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=151936,
    act="silu",
    gated=True,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    moe=MoESpec(
        n_experts=60,
        top_k=4,
        d_ff_expert=1408,
        shared_d_ff=5632,             # 4 x 1408 shared path
        capacity_factor=1.25,
        router_aux_weight=0.001,
    ),
    norm_eps=1e-6,
    microbatches=(("train_4k", 8),),
)

SMOKE = reduced(CONFIG)
