"""RWKV-6 (Finch) block: time-mix with data-dependent decay + channel-mix
(port of ``repro.models.rwkv6``).

Time-mix recurrence per head (head_dim = K = V dims):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (state: K x V matrix)
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

with w_t in (0, 1) produced from the token (data-dependent decay) and u a
learned per-channel "bonus" for the current token. The channel-mix is the
expand -> ReLU^2 -> project sandwich, served by the fused-FFN dataflow (on a
card the ungated fused-FFN kernel with ``relu_sq``).

Token-shift mixing uses the static-lerp form (mu parameters), as the
reference does. Prefill of more than 8 tokens runs the chunk-parallel WKV,
shorter inputs (decode) the per-token update. The decay LoRA, the decay
base, the bonus and ln_x are f32 leaves (``layers.F32_LEAVES``), and the
WKV state ``S`` stays f32 in the cache.

On a mesh both halves run on local shards: the time-mix whole over
``model`` (its projections are data-sharded only, as the reference lays
them out: 40 heads do not divide 16), the channel-mix with d_ff over
``model``, its output a partial sum reduced at the residual.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.core import fused_ffn as ffnlib
from repro_torch.kernels.ref import ACTS
from repro_torch.models.layers import leaf_dtype, normal_leaf
from repro_torch.runtime.actctx import (local_call, partial_on, placed,
                                        resolve, sharded_on)

Params = Dict[str, Any]
DECAY_LORA = 64


def init_rwkv_block(gen: torch.Generator, cfg: ArchConfig, device=None,
                    dtype=torch.float32) -> Params:
    """Seeded random time-mix and channel-mix weights."""
    d, dff = cfg.d_model, cfg.d_ff
    h, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    s = d ** -0.5

    def normal(name, shape, scale):
        return normal_leaf(gen, name, shape, scale, device, dtype)

    def uniform(name, shape):
        return torch.rand(shape, generator=gen, dtype=torch.float32,
                          device=device).to(leaf_dtype(name, dtype))

    def full(name, shape, value):
        return torch.full(shape, value, dtype=leaf_dtype(name, dtype),
                          device=device)

    return {
        # time-mix
        "mu": uniform("mu", (5, d)),            # r, k, v, g, w lerps
        "w_r": normal("w_r", (d, h * hd), s),
        "w_k": normal("w_k", (d, h * hd), s),
        "w_v": normal("w_v", (d, h * hd), s),
        "w_g": normal("w_g", (d, h * hd), s),
        "w_o": normal("w_o", (h * hd, d), (h * hd) ** -0.5),
        # data-dependent decay: w_t = exp(-exp(base + tanh(x A) B))
        "decay_base": full("decay_base", (h, hd), -2.0),
        "decay_A": normal("decay_A", (d, DECAY_LORA), s),
        "decay_B": normal("decay_B", (DECAY_LORA, h * hd),
                          DECAY_LORA ** -0.5 * 0.1),
        "bonus_u": normal("bonus_u", (h, hd), 0.1),
        "ln_x": full("ln_x", (h * hd,), 1.0),   # per-head group norm scale
        # channel-mix
        "cm_mu": uniform("cm_mu", (2, d)),
        "cm_k": normal("cm_k", (d, dff), s),
        "cm_v": normal("cm_v", (dff, d), dff ** -0.5),
        "cm_r": normal("cm_r", (d, d), s),
    }


def _token_shift(x, x_prev_last=None):
    """shift(x)_t = x_{t-1}; position 0 uses x_prev_last (decode carry),
    else zeros."""
    first = (torch.zeros_like(x[:, :1]) if x_prev_last is None
             else x_prev_last[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _time_mix_inputs(x, xs, p, cfg: ArchConfig):
    """Project token-shift-mixed inputs to r, k, v, g, w (decay)."""
    h, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    dt = x.dtype
    mu = p["mu"].to(dt)

    def mix(i):
        return x + (xs - x) * mu[i]

    b, t, _ = x.shape
    r = (mix(0) @ p["w_r"].to(dt)).reshape(b, t, h, hd)
    k = (mix(1) @ p["w_k"].to(dt)).reshape(b, t, h, hd)
    v = (mix(2) @ p["w_v"].to(dt)).reshape(b, t, h, hd)
    g = mix(3) @ p["w_g"].to(dt)
    dlora = torch.tanh(mix(4).float() @ p["decay_A"]) @ p["decay_B"]
    log_w = -torch.exp(p["decay_base"].reshape(1, 1, h * hd) + dlora)
    w = torch.exp(log_w).reshape(b, t, h, hd)       # decay in (0, 1)
    return r, k, v, g, w


def _group_norm(y, scale, h, hd, eps=64e-5):
    """Per-head LayerNorm (RWKV's ln_x), y: (..., h, hd); the population
    variance, as ``jnp.var``."""
    y32 = y.float()
    mean = y32.mean(dim=-1, keepdim=True)
    var = y32.var(dim=-1, keepdim=True, correction=0)
    yn = (y32 - mean) * torch.rsqrt(var + eps)
    return (yn.reshape(*y.shape[:-2], h * hd) * scale).to(y.dtype)


def _wkv_step(S, r_t, k_t, v_t, w_t, u):
    """(B, H, K) / (B, H, V) inputs of one token -> (S, y)."""
    kv = k_t[..., :, None] * v_t[..., None, :]      # (B, H, K, V)
    y = torch.einsum("bhk,bhkv->bhv", r_t, S + u[None, :, :, None] * kv)
    return w_t[..., :, None] * S + kv, y


def _wkv_scan(r, k, v, w, u, state0):
    """Sequential WKV, one token at a time. r, k, v, w: (B, T, H, K);
    state0: (B, H, K, V) f32 -> (y (B, T, H, V) f32, state).

    The reference pads T to its chunk of 64 with r = k = v = 0 and w = 1.
    Such a step leaves S exactly as it was (1 * S + 0) and its y is
    discarded, so only the real steps run here."""
    r, k, v, w = (a.float() for a in (r, k, v, w))
    S, ys = state0, []
    for i in range(r.shape[1]):
        S, y = _wkv_step(S, r[:, i], k[:, i], v[:, i], w[:, i], u)
        ys.append(y)
    return torch.stack(ys, dim=1), S


def _wkv_chunk_parallel(r, k, v, w, u, state0, *, chunk: int = 32):
    """Chunk-parallel WKV: intra-chunk work as dense einsums, the state
    updated once per chunk of L tokens:

        y_t = (r_t . c_t) @ S_in                        (inter-chunk)
            + sum_{s<t} [sum_d r_td k_sd e^(lc_t - lc_(s+1))_d] v_s (intra)
            + (r_t . u . k_t) @ v_t                     (bonus diagonal)
        S_out = diag(c_end) S_in + sum_t (k_t . c_end/c_(t+1)) v_t^T

    Every exponent is a difference of a nondecreasing log-decay cumsum with
    s < t, so every exp() argument is <= 0. Same arguments and results as
    ``_wkv_scan``.

    Under grad each chunk runs checkpointed, as the reference's
    ``jax.checkpoint`` of its chunk body: the backward keeps only the
    chunk-boundary states and recomputes one chunk's (B, L, L, H, K)
    intermediates at a time."""
    b, t, h, dk = r.shape
    pad = (-t) % chunk
    r, k, v, w = (a.float() for a in (r, k, v, w))
    if pad:
        zeros = r.new_zeros((b, pad, h, dk))
        r, k, v = (torch.cat([a, zeros], dim=1) for a in (r, k, v))
        w = torch.cat([w, torch.ones_like(zeros)], dim=1)  # state passthrough
    before = torch.arange(chunk, device=r.device)
    mask = (before[:, None] > before[None, :])[None, :, :, None, None]
    eye = torch.eye(chunk, device=r.device)[None, :, :, None]

    def chunk_body(S, rc, kc, vc, wc):
        log_w = torch.log(torch.clamp_min(wc, 1e-38))
        lc = torch.cumsum(log_w, dim=1) - log_w      # exclusive cumsum lc_t
        lc_next = lc + log_w                          # inclusive (lc_{t+1})
        lc_end = lc_next[:, -1]                       # (B, H, K): log prod
        # inter-chunk: y_t += (r_t . e^{lc_t}) @ S_in
        y_inter = torch.einsum("blhk,bhkv->blhv", rc * torch.exp(lc), S)
        # intra-chunk: att[t,s] = sum_d r_td k_sd e^{(lc_t - lc_{s+1})_d}
        z = lc[:, :, None] - lc_next[:, None]         # (B, Lt, Ls, H, K)
        z = z.masked_fill(~mask, float("-inf"))
        # one product and a sum over k: torch.einsum of the three operands
        # runs as an f32 batched gemv on CUDA (0.23 ms a chunk at rwkv6-3b's
        # prefill on an H100)
        att = (rc[:, :, None] * kc[:, None] * torch.exp(z)).sum(dim=-1)
        # bonus diagonal (the current token's u-weighted contribution)
        diag = torch.einsum("bthk,bthk->bth", rc * u[None, None], kc)
        att = att + diag[:, :, None] * eye
        y_intra = torch.einsum("btsh,bshv->bthv", att, vc)
        k_dec = kc * torch.exp(lc_end[:, None] - lc_next)
        S_new = torch.exp(lc_end)[..., :, None] * S \
            + torch.einsum("blhk,blhv->bhkv", k_dec, vc)
        return S_new, y_inter + y_intra

    grads = torch.is_grad_enabled() and any(
        a.requires_grad for a in (r, k, v, w, u, state0))
    body = ffnlib.checkpointed(chunk_body) if grads else chunk_body
    S, ys = state0, []
    for lo in range(0, t + pad, chunk):
        S, y = body(S, *(a[:, lo:lo + chunk] for a in (r, k, v, w)))
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :t], S


def init_rwkv_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
                    device=None) -> Params:
    h, hd, d = cfg.n_rwkv_heads, cfg.rwkv_head_dim, cfg.d_model
    return {
        "S": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                         device=device),                 # wkv state: f32
        "x_tm": torch.zeros((batch, d), dtype=dtype, device=device),
        "x_cm": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def time_mix(x, p: Params, cfg: ArchConfig, cache=None):
    """(B, T, D) -> (y, new cache or None)."""
    if isinstance(x, DTensor):
        w = {k: placed(v, *(None,) * v.dim()) for k, v in p.items()
             if k in _TIME_MIX}
        return _sharded(lambda xl, pl, cl: time_mix(xl, pl, cfg, cl),
                        x, w, cache, ("S", "x_tm"), partial=False)
    h, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    xs = _token_shift(x, None if cache is None else cache["x_tm"])
    r, k, v, g, w = _time_mix_inputs(x, xs, p, cfg)
    b = x.shape[0]
    state0 = (torch.zeros((b, h, hd, hd), dtype=torch.float32,
                          device=x.device) if cache is None else cache["S"])
    if x.shape[1] > 8:      # prefill: chunk-parallel form
        y, state = _wkv_chunk_parallel(r, k, v, w, p["bonus_u"], state0)
    else:                   # decode: per-token state update
        y, state = _wkv_scan(r, k, v, w, p["bonus_u"], state0)
    y = _group_norm(y, p["ln_x"], h, hd)
    y = (y * ACTS["silu"](g)).to(x.dtype)
    out = y @ p["w_o"].to(x.dtype)
    new_cache = None if cache is None else {
        **cache, "S": state, "x_tm": x[:, -1].to(cache["x_tm"].dtype)}
    return out, new_cache


def channel_mix(x, p: Params, cfg: ArchConfig, cache=None):
    """Expand -> ReLU^2 -> project (+ receptance gate): the ungated FFN of
    ``core/fused_ffn.ffn_apply`` under ``cfg.block_impl``."""
    if isinstance(x, DTensor):
        dt = x.dtype
        w = {"cm_mu": placed(p["cm_mu"], None, None),
             "cm_r": placed(p["cm_r"].to(dt), None, None),
             "cm_k": placed(p["cm_k"].to(dt), None, "M"),
             "cm_v": placed(p["cm_v"].to(dt), "M", None)}
        return _sharded(lambda xl, pl, cl: channel_mix(xl, pl, cfg, cl),
                        x, w, cache, ("x_cm",),
                        partial=sharded_on(w["cm_k"]))
    xs = _token_shift(x, None if cache is None else cache["x_cm"])
    dt = x.dtype
    mu = p["cm_mu"].to(dt)
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    recept = torch.sigmoid(xr @ p["cm_r"].to(dt))
    y = ffnlib.ffn_apply(xk, {"w_up": p["cm_k"], "w_down": p["cm_v"]},
                         gated=False, act_name="relu_sq",
                         impl=cfg.block_impl, chunk=cfg.ffn_chunk)
    new_cache = None if cache is None else {
        **cache, "x_cm": x[:, -1].to(cache["x_cm"].dtype)}
    return recept * y, new_cache


_TIME_MIX = ("mu", "w_r", "w_k", "w_v", "w_g", "w_o", "decay_A", "decay_B",
             "decay_base", "bonus_u", "ln_x")


def _sharded(fn, x, w, cache, keys, *, partial: bool):
    """``fn(x, w, cache) -> (y, new cache or None)`` on this rank's shards:
    x batch-sharded and whole over ``model``, ``w`` already placed, the
    cache leaves ``keys`` batch-sharded. ``partial``: y is a sum over
    ``model`` (the channel-mix's d_ff), all-reduced here."""
    x = placed(x, "B", None, None)
    mesh = x.device_mesh
    state = {} if cache is None else {
        k: placed(cache[k], "B", *(None,) * (cache[k].dim() - 1))
        for k in keys}
    out_pl = (partial_on(x) if partial else list(x.placements),) + tuple(
        resolve(mesh, state[k].shape, ("B",) + (None,) * (state[k].dim() - 1))
        for k in state)

    def local(xl, wl, cl):
        y, new = fn(xl, wl, cl or None)
        return (y,) + tuple(new[k] for k in state)

    out = local_call(local, out_pl, x, w, state)
    y = placed(out[0], "B", None, None)
    if cache is None:
        return y, None
    return y, {**cache, **dict(zip(state, out[1:]))}
