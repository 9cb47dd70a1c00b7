"""Plain PyTorch versions of the hand-written kernels.

Each function is the semantic ground truth its kernel is held against: the
CPU tests compare it with the JAX package, and ``chip_smoke.py`` compares
the CUDA kernel with it on the card. It runs on any device.
``plain_grads`` is the FFN kernel's backward: the gradient of its plain
version (``fused_ffn_ref``) recomputed under grad. ``mha_grads_blocked``
is the flash kernel's: the gradient of ``mha_ref`` in closed form, one
block of queries at a time, so that no (Tq, Tk) matrix exists.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import quant


def fused_dsc_ref(x_q, w_exp, w_dw9, w_proj, b_exp, b_dw, b_proj,
                  m_exp, m_dw, m_proj, *, stride, zps, q6) -> torch.Tensor:
    """int8 (B, H, W, C) -> int8 (B, H2, W2, N), layer by layer, explicit
    padding of F1 with ``zp_f1``. ``w_dw9`` is (9, M), tap-major."""
    _, zp_f1, zp_f2, zp_out = zps
    q6_f1, q6_f2 = q6
    if x_q.dim() != 4:
        raise ValueError(f"x_q must be (B, H, W, C), got {tuple(x_q.shape)}")
    _, h, w, _ = x_q.shape
    s = stride
    h2, w2 = -(-h // s), -(-w // s)

    acc = quant.int8_matmul(x_q, w_exp) + b_exp
    f1 = quant.requantize(acc, m_exp, zp_f1, relu=True, relu6_max_q=q6_f1)
    f1p = F.pad(f1, (0, 0, 1, 1, 1, 1), value=zp_f1)
    w9 = w_dw9.to(torch.int32)
    acc2 = None
    for dy in range(3):
        for dx in range(3):
            win = f1p[:, dy:dy + (h2 - 1) * s + 1:s,
                      dx:dx + (w2 - 1) * s + 1:s, :]
            tap = win.to(torch.int32) * w9[dy * 3 + dx]
            acc2 = tap if acc2 is None else acc2 + tap
    f2 = quant.requantize(acc2 + b_dw, m_dw, zp_f2, relu=True,
                          relu6_max_q=q6_f2)
    acc3 = quant.int8_matmul(f2, w_proj) + b_proj
    return quant.requantize(acc3, m_proj, zp_out)


# ---------------------------------------------------------------------------
# fused FFN plain version
# ---------------------------------------------------------------------------


def _silu(x):
    return x * torch.sigmoid(x)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _relu_sq(x):
    return torch.square(torch.clamp_min(x, 0.0))


def _relu(x):
    return torch.clamp_min(x, 0.0)


ACTS = {"silu": _silu, "gelu": _gelu, "relu_sq": _relu_sq, "relu": _relu}


def _acc(x):
    """``x`` in its accumulation type: float32, or float64 for a float64
    input, so that a float64 call computes the whole function in float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def fused_ffn_ref(x, w_gate, w_up, w_down, *, act: str = "silu"):
    """y = act(x @ w_gate) * (x @ w_up) @ w_down, f32 accumulation (f64 for
    f64 inputs); ``h`` is cast to ``x.dtype`` before the down projection, as
    the kernel does. ``w_gate`` may be None (ungated: y = act(x @ w_up) @
    w_down)."""
    f = ACTS[act]
    xa = _acc(x)
    if w_gate is None:
        h = f(xa @ _acc(w_up))
    else:
        h = f(xa @ _acc(w_gate)) * (xa @ _acc(w_up))
    return (_acc(h.to(x.dtype)) @ _acc(w_down)).to(x.dtype)


# ---------------------------------------------------------------------------
# flash attention plain version: materializes the full (Tq, Tk) scores
# ---------------------------------------------------------------------------


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  sm_scale: Optional[float] = None):
    """(BH, Tq, d) x (BH, Tk, d) -> (BH, Tq, d), in f32 (f64 for f64
    inputs). Rows with no valid key give zeros."""
    _, tq, d = q.shape
    tk = k.shape[1]
    scale = float(sm_scale if sm_scale is not None else d ** -0.5)
    s = torch.einsum("bqd,bkd->bqk", _acc(q), _acc(k)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(tq, device=q.device)[:, None]
    k_pos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    return torch.einsum("bqk,bkd->bqd", p, _acc(v)).to(q.dtype)


def mha_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None,
            softcap: Optional[float] = None,
            sm_scale: Optional[float] = None):
    """GQA attention on (B, Tq, H, d) q and (B, Tk, Hkv, d) k/v: each KV
    head repeated to its ``H // Hkv`` query heads, then ``attention_ref``."""
    b, tq, h, d = q.shape
    group = h // k.shape[2]
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=2)
        v = torch.repeat_interleave(v, group, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, tq, d)
    kf = k.transpose(1, 2).reshape(b * h, -1, d)
    vf = v.transpose(1, 2).reshape(b * h, -1, d)
    o = attention_ref(qf, kf, vf, causal=causal, window=window,
                      softcap=softcap, sm_scale=sm_scale)
    return o.reshape(b, h, tq, d).transpose(1, 2)


def _visible(q_pos, k_pos, causal: bool, window: Optional[int]):
    """``attention_ref``'s mask: query i sees key j where j <= i (causal)
    and i - j < window."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return mask


def mha_grads_blocked(q, k, v, grad_o, *, causal: bool = True,
                      window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      sm_scale: Optional[float] = None, block: int = 1024
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``mha_ref`` (dq, dk, dv in q's dtype) for the output
    gradient ``grad_o``, a block of ``block`` queries at a time, products in
    f32 (f64 for f64 inputs).

    Each block scores its queries against the keys its masks can reach (a
    causal block ends at its last query, a window starts ``window - 1``
    before its first), so no tensor is larger than (B H, block, Tk). The
    query heads of one KV head are scored together against it, so K and V
    are never repeated. Per block, as autograd differentiates
    ``attention_ref``:

        p  = softmax(mask(cap(s))),  s = scale q k^T   (rows with no key: 0)
        dv += p^T dO;  dp = dO v^T;  ds = p (dp - rowsum(p dp))
        ds *= 1 - tanh^2(s / softcap)   (the softcap's chain rule)
        dq = scale ds k;  dk += scale ds^T q
    """
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = float(sm_scale if sm_scale is not None else d ** -0.5)
    acc = torch.promote_types(q.dtype, torch.float32)
    # (B, Hkv, G, T, d): query head h = kv * G + i reads KV head kv
    qf = q.to(acc).reshape(b, tq, hkv, g, d).permute(0, 2, 3, 1, 4)
    of = grad_o.to(acc).reshape(b, tq, hkv, g, d).permute(0, 2, 3, 1, 4)
    kf = k.to(acc).transpose(1, 2)                    # (B, Hkv, Tk, d)
    vf = v.to(acc).transpose(1, 2)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    pos = torch.arange(max(tq, tk), device=q.device)
    for lo in range(0, tq, block):
        hi = min(lo + block, tq)
        k_lo = 0 if window is None else max(0, lo - window + 1)
        k_hi = min(tk, hi) if causal else tk
        if k_lo >= k_hi:                  # no query here sees any key
            continue
        qb, ob = qf[:, :, :, lo:hi], of[:, :, :, lo:hi]
        kb, vb = kf[:, :, k_lo:k_hi], vf[:, :, k_lo:k_hi]
        s = torch.einsum("bngqd,bnkd->bngqk", qb, kb) * scale
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s = softcap * t
        mask = _visible(pos[lo:hi], pos[k_lo:k_hi], causal, window)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        p = torch.softmax(s, dim=-1)
        p = torch.where(mask.any(dim=-1, keepdim=True), p,
                        torch.zeros_like(p))
        dv[:, :, k_lo:k_hi] += torch.einsum("bngqk,bngqd->bnkd", p, ob)
        dp = torch.einsum("bngqd,bnkd->bngqk", ob, vb)
        ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
        if softcap is not None:
            ds = ds * (1.0 - t * t)
        ds = ds * scale
        dq[:, :, :, lo:hi] = torch.einsum("bngqk,bnkd->bngqd", ds, kb)
        dk[:, :, k_lo:k_hi] += torch.einsum("bngqk,bngqd->bnkd", ds, qb)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, tq, h, d)
    return (dq.to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def plain_grads(fn: Callable, inputs: Sequence[Optional[torch.Tensor]],
                needs: Sequence[bool], grad_out: torch.Tensor
                ) -> Tuple[Optional[torch.Tensor], ...]:
    """A kernel's backward: ``fn(*inputs)`` recomputed under grad, and its
    vector-Jacobian product with ``grad_out`` for each input that ``needs``
    it (None for the others, and for None inputs)."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(bool(need))
                  for t, need in zip(inputs, needs)]
        out = fn(*leaves)
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return tuple(next(grads) if t is not None and t.requires_grad else None
                 for t in leaves)
