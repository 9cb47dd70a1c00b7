"""Plain float32 PyTorch reference of the afmoe decoder LM (Trinity-Mini).

A full forward pass over whole token sequences, one layer at a time, with
no cache, no kernel, no batching trick and TF32 off: the embedding times
sqrt(d); per layer RMSNorm, q/k/v, per-head q/k RMSNorm, RoPE on the
sliding-window layers only (the full layers are NoPE), causal grouped-query
softmax attention (banded to the window on the sliding layers), the
sigmoid output gate, the output projection and its RMSNorm, each around a
residual add; then RMSNorm, the FFN (a dense SwiGLU in the leading layers;
else the router's sigmoid scores in f32, the experts picked by the top-k
of the scores plus the selection bias and weighted by the unbiased scores,
normalized and times ``route_scale``, each expert run over its own tokens
with no capacity, plus the shared expert) and its RMSNorm; then the final
RMSNorm and the head. The equations are those of
``repro_torch/configs/trinity_mini.py``'s docstring.

It reads the weights the program holds (each layer cast to float32 when it
is used) and works out everything else again: where each layer's weights
lie in the tree, its kind, the RoPE tables, the masks and the routes. It
imports nothing of the port and no JAX. ``arch`` is the configuration as a
dict (``dataclasses.asdict`` of the port's config).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

MATRICES = ("wq", "wk", "wv", "wo", "wg", "w_gate", "w_up", "w_down")
Q_BLOCK = 1024         # queries per block of the attention's scores
ROWS = 8192            # tokens per block of a dense FFN's products


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, theta: float):
    """x (L, H, hd) float32, positions (L,) int: the two halves of each
    head rotated."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = (positions.double()[:, None] * inv).float()          # (L, hd/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def swiglu(h, w_gate, w_up, w_down):
    return (F.silu(h @ w_gate) * (h @ w_up)) @ w_down


def attention(h, p, a: dict, local: bool):
    """Causal GQA attention of one sequence h (L, d), gated, projected."""
    n, hkv, hd = a["n_heads"], a["n_kv_heads"], a["head_dim"]
    g, length, eps = n // hkv, h.shape[0], a["norm_eps"]
    pos = torch.arange(length, device=h.device)
    q = rms_norm(torch.einsum("ld,dhk->lhk", h, p["wq"]), p["q_norm"], eps)
    k = rms_norm(torch.einsum("ld,dhk->lhk", h, p["wk"]), p["k_norm"], eps)
    v = torch.einsum("ld,dhk->lhk", h, p["wv"])
    if local:
        q, k = rope(q, pos, a["rope_theta"]), rope(k, pos, a["rope_theta"])
    q = q.reshape(length, hkv, g, hd) * hd ** -0.5
    o = torch.empty_like(q)
    for q0 in range(0, length, Q_BLOCK):
        q1 = min(q0 + Q_BLOCK, length)
        k0 = max(0, q0 - a["window"] + 1) if local else 0
        s = torch.einsum("qngk,tnk->ngqt", q[q0:q1], k[k0:q1])
        diff = pos[q0:q1, None] - pos[None, k0:q1]
        keep = diff >= 0
        if local:
            keep &= diff < a["window"]
        s = s.masked_fill(~keep, float("-inf")).softmax(-1)
        o[q0:q1] = torch.einsum("ngqt,tnk->qngk", s, v[k0:q1])
    o = o.reshape(length, n, hd) * torch.sigmoid(
        torch.einsum("ld,dhk->lhk", h, p["wg"]))
    return torch.einsum("lhk,hkd->ld", o, p["wo"])


def dense_ffn(h, p):
    out = torch.empty_like(h)
    for i in range(0, h.shape[0], ROWS):
        out[i:i + ROWS] = swiglu(h[i:i + ROWS], p["w_gate"], p["w_up"],
                                 p["w_down"])
    return out


def routes(h, p, m: dict):
    """(ids (n, k), gates (n, k)) of tokens h (n, d), all in float32."""
    s = torch.sigmoid(h @ p["router"])
    ids = torch.topk(s + p["route_bias"], m["top_k"], dim=-1).indices
    g = s.gather(-1, ids)
    return ids, g / g.sum(-1, keepdim=True) * m["route_scale"]


def moe(h, p, m: dict):
    """The routed experts, each over its own tokens, and the shared one."""
    ids, gates = routes(h, p, m)
    y = swiglu(h, p["shared"]["w_gate"], p["shared"]["w_up"],
               p["shared"]["w_down"])
    for e in range(m["n_experts"]):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel():
            out = swiglu(h[tok], p["w_gate"][e], p["w_up"][e], p["w_down"][e])
            y.index_add_(0, tok, out * gates[tok, slot, None])
    return y


def layer_kind_local(a: dict, layer: int) -> bool:
    pattern = a["pattern"]
    return pattern[layer % len(pattern)] == "attn_local"


def layer_weights(weights: dict, a: dict, layer: int, cast: Callable):
    """Layer ``layer``'s leaves in float32 (matrices via ``cast``): the
    leading dense layers under ``lead``, then whole units of the pattern,
    stacked, under ``units``, then the rest under ``tail``."""
    lead, period = a["n_dense_layers"], len(a["pattern"])
    units = (a["n_layers"] - lead) // period
    if layer < lead:
        node, index = weights["lead"][str(layer)], None
    else:
        u, i = divmod(layer - lead, period)
        node, index = ((weights["units"][str(i)], u) if u < units
                       else (weights["tail"][str(i)], None))

    def take(n, name=""):
        if isinstance(n, dict):
            return {k: take(v, k) for k, v in n.items()}
        w = (n if index is None else n[index]).float()
        return cast(w, name) if name in MATRICES else w
    return take(node)


def logits(weights: dict, a: dict, tokens: torch.Tensor, positions,
           cast: Optional[Callable] = None) -> torch.Tensor:
    """Float32 logits (N, len(positions), V) of ``tokens`` (N, L) at the
    given positions. ``cast(w, name)`` may change each float32 matrix
    before it is used (the lower-precision control)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cast = cast or (lambda w, name: w)
    eps, m = a["norm_eps"], a["moe"]
    x = weights["embed"][tokens].float() * a["d_model"] ** 0.5  # (N, L, d)
    n_seq, length, d = x.shape
    for layer in range(a["n_layers"]):
        p = layer_weights(weights, a, layer, cast)
        local = layer_kind_local(a, layer)
        for j in range(n_seq):
            h = rms_norm(x[j], p["norm1"], eps)
            x[j] += rms_norm(attention(h, p["sub1"], a, local),
                             p["post_norm1"], eps)
        h = rms_norm(x, p["norm2"], eps).reshape(-1, d)
        y = (dense_ffn(h, p["sub2"]) if layer < a["n_dense_layers"]
             else moe(h, p["sub2"], m))
        x += rms_norm(y.reshape(n_seq, length, d), p["post_norm2"], eps)
        del p, h, y
    x = rms_norm(x[:, positions], weights["final_norm"].float(), eps)
    return x @ cast(weights["lm_head"].float(), "lm_head")


def fp8_matrix(w: torch.Tensor, name: str) -> torch.Tensor:
    """The control's weights: each matrix rounded to float8 e4m3 with one
    scale per output column (the nearest step below the configuration's
    bf16); a stacked expert matrix (E, in, out) per expert."""
    if name == "wo":
        axes = (0, 1)
    elif w.dim() == 3 and name.startswith("w_"):
        axes = (1,)
    else:
        axes = (0,)
    amax = w.abs().amax(dim=axes, keepdim=True)
    scale = amax.clamp_min(1e-12) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's reference logit lies below the reference's best
    at its position: ``ref`` (..., V), ``tokens`` (...)."""
    return ref.amax(-1) - ref.gather(-1, tokens[..., None].long())[..., 0]


def compare(ref: torch.Tensor, tokens: torch.Tensor,
            logits: torch.Tensor) -> dict:
    """The numbers a served sample is judged by: the widest gap of a served
    token below the reference's best, and the largest relative error of a
    position's logits (norm of the difference over the reference's norm).
    ``ref`` and ``logits`` (N, P, V), ``tokens`` (N, P)."""
    err = (logits - ref).norm(dim=-1) / ref.norm(dim=-1)
    return {"token_logit_gap": float(gaps(ref, tokens).max()),
            "logit_rel_err": float(err.max())}
