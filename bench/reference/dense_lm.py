"""Plain float32 PyTorch reference of the dense decoder LM (glm4-9b).

A full forward pass over whole token sequences, one layer at a time, with
no cache, no kernel and TF32 off: embedding, per layer RMSNorm, q/k/v with
their biases, partial RoPE, causal grouped-query softmax attention, the
output projection, RMSNorm and the gated SiLU FFN, each around a residual
add; then the final RMSNorm and the head. It reads the weights the
benchmark drew (cast to float32 one layer at a time) and works out
everything else again, the RoPE tables included. It imports nothing of the
port and no JAX.

RoPE rotates the first ``rope_fraction`` of each head's dimensions as two
halves (the layout the port and the JAX package use); GLM-4's published
code rotates interleaved pairs, a permutation of the same dimensions that
random weights cannot tell apart.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
ROWS = 4096            # tokens per block of the FFN's products


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, positions, fraction: float, theta: float):
    """x (N, L, H, hd) float32, positions (L,) int."""
    hd = x.shape[-1]
    rot = int(hd * fraction) // 2 * 2
    inv = 1.0 / theta ** (torch.arange(0, rot, 2, dtype=torch.float64,
                                       device=x.device) / rot)
    ang = (positions.double()[:, None] * inv).float()         # (L, rot/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :rot // 2], x[..., rot // 2:rot]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x[..., rot:]],
                     dim=-1)


def attention(h, p, a: dict):
    """Causal GQA attention of one sequence h (L, d), all in float32."""
    n, hd, g = a["n_heads"], a["head_dim"], a["n_heads"] // a["n_kv_heads"]
    length = h.shape[0]
    pos = torch.arange(length, device=h.device)
    q = torch.einsum("ld,dhk->lhk", h, p["wq"]) + p["bq"]
    k = torch.einsum("ld,dhk->lhk", h, p["wk"]) + p["bk"]
    v = torch.einsum("ld,dhk->lhk", h, p["wv"]) + p["bv"]
    q = rope(q[None], pos, a["rope_fraction"], a["rope_theta"])[0]
    k = rope(k[None], pos, a["rope_fraction"], a["rope_theta"])[0]
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    s = torch.einsum("qhk,thk->hqt", q, k) * hd ** -0.5
    mask = torch.ones(length, length, dtype=torch.bool,
                      device=h.device).tril()
    s = s.masked_fill(~mask, float("-inf")).softmax(-1)
    o = torch.einsum("hqt,thk->qhk", s, v)
    return torch.einsum("qhk,hkd->qd", o, p["wo"])


def ffn(h, p):
    out = torch.empty_like(h)
    for i in range(0, h.shape[0], ROWS):
        x = h[i:i + ROWS]
        out[i:i + ROWS] = (torch.nn.functional.silu(x @ p["w_gate"])
                           * (x @ p["w_up"])) @ p["w_down"]
    return out


def layer_weights(units: dict, i: int, cast: Callable):
    """Layer ``i``'s leaves of the stacked tree, in float32 via ``cast``."""
    def take(node, name=""):
        if isinstance(node, dict):
            return {k: take(v, k) for k, v in node.items()}
        w = node[i].float()
        return cast(w, name) if name in MATRICES else w
    return take(units["0"])


def logits(weights: dict, a: dict, tokens: torch.Tensor, positions,
           cast: Optional[Callable] = None) -> torch.Tensor:
    """Float32 logits (N, len(positions), V) of ``tokens`` (N, L) at the
    given positions. ``cast(w, name)`` may change each float32 matrix
    before it is used (the lower-precision control)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cast = cast or (lambda w, name: w)
    eps = a["norm_eps"]
    x = weights["embed"][tokens].float()                 # (N, L, d)
    for i in range(a["n_layers"]):
        p = layer_weights(weights["units"], i, cast)
        for j in range(x.shape[0]):
            h = rms_norm(x[j], p["norm1"], eps)
            x[j] += attention(h, p["sub1"], a)
            h = rms_norm(x[j], p["norm2"], eps)
            x[j] += ffn(h, p["sub2"])
        del p
    x = rms_norm(x[:, positions], weights["final_norm"].float(), eps)
    return x @ cast(weights["lm_head"].float(), "lm_head")


def fp8_matrix(w: torch.Tensor, name: str) -> torch.Tensor:
    """The control's weights: each matrix rounded to float8 e4m3 with one
    scale per output column (the nearest step below the configuration's
    bf16)."""
    in_dims = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w_gate": 1, "w_up": 1,
               "w_down": 1, "lm_head": 1}[name]
    amax = w.abs().amax(dim=tuple(range(in_dims)), keepdim=True)
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
