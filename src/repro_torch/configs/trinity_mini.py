"""trinity-mini [moe] — arcee-ai Trinity-Mini (model_type ``afmoe``), 26B-A3B:
32L d_model=2048 32H (GQA kv=4) head_dim 128, 3 sliding-window (2048, RoPE)
: 1 global (NoPE) layers, 2 leading dense layers (d_ff 6144), then 128
routed experts of width 1024, top-8, sigmoid-routed, and one shared expert;
vocab 200192, untied head. [hf:arcee-ai/Trinity-Mini config.json]

The layer as the port implements it (dims d 2048, H 32, Hkv 4, hd 128,
W 2048, E 128, k 8, f_e 1024, f 6144, eps 1e-5, theta 10000)::

    x = Embed[ids] * sqrt(d)                                # mup_enabled
    for l in 0..31:  kind = full if l % 4 == 3 else sliding # layer_types
      h = RMSNorm_in(x)                     # x * rsqrt(mean(x^2) + eps) * w
      q, k, v = h Wq (H, hd), h Wk (Hkv, hd), h Wv (Hkv, hd)  # no biases
      q, k = RMSNorm_q(q), RMSNorm_k(k)                       # per head
      if sliding: q, k = RoPE(q, k, theta)                    # full: NoPE
      a = softmax(q k^T / sqrt(hd) + mask) v   # GQA 8:1, causal; sliding:
                                               # q_pos - k_pos < W
      a = a * sigmoid(h Wg)                    # Wg (d, H * hd), elementwise
      x = x + RMSNorm_post_attn(a Wo)
      h = RMSNorm_pre_mlp(x)
      if l < 2:  y = SwiGLU_f(h)                              # dense layers
      else:
        s = sigmoid(float32(h) Wr)             # (E,), the router in f32
        ids = topk(s + b, k)                   # b: selection bias only
        g = s[ids]; g = g / sum(g) * 2.826     # route_norm, route_scale
        y = sum_j g_j SwiGLU_fe^(ids_j)(h) + SwiGLU_fe^shared(h)
      x = x + RMSNorm_post_mlp(y)
    logits = RMSNorm_final(x) W_head                          # V 200192

These are the equations as recalled from the published configuration and
the family's description: no copy of transformers' ``AfmoeForCausalLM`` is
in the repository. Departures and assumptions: the router's scores feed no
auxiliary loss here (the published ``load_balance_coeff`` updates the
selection bias between training steps; serving reads it as a constant);
the shared expert has no gate; RoPE rotates each head's two halves (the
port's layout). Precision: the residual stream, the matrices, their inputs
and their outputs in ``dtype`` (bf16); the norms' arithmetic, the router
(f32 weights, its input cast to f32) and the sum of the routed experts in
f32.
``param_count`` counts the learned weights, the q/k norm scales included
and the selection bias (a buffer) left out: 26,123,970,560.
"""

from repro_torch.configs.base import PortArchConfig, SigmoidMoESpec

PATTERN = ("attn_local", "attn_local", "attn_local", "attn")

CONFIG = PortArchConfig(
    name="trinity-mini",
    family="moe",
    n_layers=32,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=6144,                      # the two leading dense layers
    vocab=200192,
    act="silu",
    gated=True,
    rope_theta=10_000.0,
    qk_norm=True,
    sandwich_norm=True,
    window=2048,
    embed_scale=True,               # muP: the embedding times sqrt(d)
    pattern=PATTERN,
    moe=SigmoidMoESpec(
        n_experts=128,
        top_k=8,
        d_ff_expert=1024,
        shared_d_ff=1024,           # one shared expert
        route_scale=2.826,
        router_aux_weight=0.0,
    ),
    norm_eps=1e-5,
    n_dense_layers=2,
    attn_gate=True,
    rope_local_only=True,
)

# two dense layers, one unit of the pattern (from its third layer) and a
# tail of two: every kind of layer, lead, unit and tail
SMOKE = PortArchConfig(
    name="trinity-mini-smoke",
    family="moe",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab=256,
    act="silu",
    gated=True,
    rope_theta=10_000.0,
    qk_norm=True,
    sandwich_norm=True,
    window=8,
    embed_scale=True,
    pattern=PATTERN,
    moe=SigmoidMoESpec(
        n_experts=8,
        top_k=3,
        d_ff_expert=32,
        shared_d_ff=32,
        route_scale=2.826,
        router_aux_weight=0.0,
    ),
    norm_eps=1e-5,
    n_dense_layers=2,
    attn_gate=True,
    rope_local_only=True,
    block_impl="fused",
    ffn_chunk=32,
    attn_chunk=8,
)
