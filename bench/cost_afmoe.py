"""The benchmark's count of the afmoe LM's work (Trinity-Mini) from shapes.

Model FLOPs count the useful work, matrix products at 2 operations a
multiply-add: per token the q, k, v, o and gate projections, the dense
SwiGLU in the leading layers, and in the MoE layers the router, the k
routed experts and the shared expert; attention at each position's own
context, ``min(pos + 1, window)`` keys on a sliding layer and ``pos + 1`` on
a full one; the head only where a token is produced. ``experts_call``
counts one call of the dropless experts' entry for its roofline.
"""

from __future__ import annotations


def layer_kinds(arch: dict):
    pattern = arch["pattern"]
    return [pattern[i % len(pattern)] for i in range(arch["n_layers"])]


def token_matmul_flops(arch: dict) -> float:
    """FLOPs of one token through every layer's matrix products."""
    d, hd = arch["d_model"], arch["head_dim"]
    h, hkv, m = arch["n_heads"], arch["n_kv_heads"], arch["moe"]
    attn = d * (2 * h + 2 * hkv) * hd + h * hd * d       # q, gate, k, v; o
    dense = 3 * d * arch["d_ff"]
    routed = d * m["n_experts"] + 3 * d * m["d_ff_expert"] * m["top_k"] \
        + 3 * d * m["shared_d_ff"]
    lead = arch["n_dense_layers"]
    return 2 * (arch["n_layers"] * attn + lead * dense
                + (arch["n_layers"] - lead) * routed)


def context(kind: str, window: int, positions: range) -> int:
    """Keys attended over ``positions``, each at its own context."""
    if kind == "attn":
        return sum(p + 1 for p in positions)
    return sum(min(p + 1, window) for p in positions)


def flops(arch: dict, kind: str, batch: int, length: int) -> float:
    """Model FLOPs of a prefill of ``batch`` prompts of ``length`` tokens
    (kind ``prefill``; the head at the last position only) or of one decode
    step whose token sits at position ``length`` (kind ``decode``)."""
    if kind == "prefill":
        positions, tokens = range(length), length
    elif kind == "decode":
        positions, tokens = range(length, length + 1), 1
    else:
        raise ValueError(f"unknown LM call kind {kind!r}")
    per_key = 4 * arch["n_heads"] * arch["head_dim"]
    ctx = sum(context(k, arch["window"], positions)
              for k in layer_kinds(arch))
    head = 2 * arch["d_model"] * arch["vocab"]
    return batch * (token_matmul_flops(arch) * tokens + per_key * ctx + head)


def work_ops(cfg: dict, item: tuple) -> float:
    """Model operations of one LM call ``(kind, batch, length)`` that a
    window records."""
    return flops(cfg["arch"], *item)


def experts_call(shapes) -> tuple:
    """(flops, bytes) of one ``moe.experts`` call: x (n, d), ids (n, k),
    gates, w_gate and w_up (E, d, f), w_down (E, f, d). Every assignment
    is computed; x in and y out once, and the weights of k experts, the
    fewest the call can read whatever the routes."""
    args, _ = shapes
    (n, d), item = args[0]
    (_, k), _ = args[1]
    (e, _, f), w_item = args[3]
    return 2 * 3 * n * k * d * f, item * 2 * n * d + w_item * 3 * min(k, e) \
        * d * f
