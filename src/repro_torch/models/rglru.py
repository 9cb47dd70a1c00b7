"""RG-LRU recurrent block, RecurrentGemma / Griffin (port of
``repro.models.rglru``).

Structure of one recurrent block (De et al., arXiv:2402.19427):

    x -> [W_gate branch: GeLU]----------------------\\
    x -> [W_in] -> temporal conv1d(w=4) -> RG-LRU -> * -> [W_out] -> y

The temporal conv1d is a depthwise convolution over time, the paper's
depthwise stage between two pointwise projections.

RG-LRU recurrence (per channel):

    r_t = sigmoid(x_t W_a + b_a)               recurrence gate
    i_t = sigmoid(x_t W_x + b_x)               input gate
    log a_t = -c * softplus(Lambda) * r_t      (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

It is a linear recurrence, so prefill runs a log-depth scan and decode the
O(1) per-token update. The gates, the conv and Lambda are f32 leaves
(``layers.F32_LEAVES``), and the hidden state ``h`` stays f32 in the cache.

On a mesh the block runs on local shards (``_sharded``): the LRU width,
the conv and the per-head gate blocks over ``model`` (each channel's
recurrence is its own), ``w_out``'s product a partial sum over ``model``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import leaf_dtype, normal_leaf
from repro_torch.runtime.actctx import (local_call, partial_on, placed,
                                        resolve, sharded_on)

Params = Dict[str, Any]
_C = 8.0


def init_rglru_block(gen: torch.Generator, cfg: ArchConfig, device=None,
                     dtype=torch.float32) -> Params:
    """Seeded random weights; Lambda such that a^c is uniform in [0.9,
    0.999], as the reference draws it."""
    d, w, nh = cfg.d_model, cfg.lru_width_, cfg.n_heads
    blk = w // nh

    def normal(name, shape, scale):
        return normal_leaf(gen, name, shape, scale, device, dtype)

    def zeros(name):
        return torch.zeros((w,), dtype=leaf_dtype(name, dtype), device=device)

    u = 0.9 + 0.099 * torch.rand((w,), generator=gen, dtype=torch.float32,
                                 device=device)
    root = u ** (1.0 / _C)
    return {
        "w_gate_br": normal("w_gate_br", (d, w), d ** -0.5),
        "w_in": normal("w_in", (d, w), d ** -0.5),
        "w_out": normal("w_out", (w, d), w ** -0.5),
        "conv_w": normal("conv_w", (cfg.conv_width, w),
                         cfg.conv_width ** -0.5),
        "conv_b": zeros("conv_b"),
        # block-diagonal per head (w/h x w/h per block), as in Griffin
        "w_a": normal("w_a", (nh, blk, blk), blk ** -0.5),
        "b_a": zeros("b_a"),
        "w_x": normal("w_x", (nh, blk, blk), blk ** -0.5),
        "b_x": zeros("b_x"),
        "lambda": torch.log(root / (1.0 - root)).to(
            leaf_dtype("lambda", dtype)),
    }


def _blockdiag(x32, w):
    """x: (..., W) @ block-diagonal (H, W/H, W/H) -> (..., W)."""
    h, blk, _ = w.shape
    xs = x32.reshape(x32.shape[:-1] + (h, blk))
    return torch.einsum("...hb,hbc->...hc", xs, w).reshape(x32.shape)


def _gates(x, p):
    """a_t (decay) and gated input for the recurrence; all f32."""
    x32 = x.float()
    r = torch.sigmoid(_blockdiag(x32, p["w_a"]) + p["b_a"])
    i = torch.sigmoid(_blockdiag(x32, p["w_x"]) + p["b_x"])
    lam = p["lambda"]
    # softplus without F.softplus's linear branch past 20: jax.nn.softplus
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))
    log_a = -_C * softplus * r
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                         1e-12)) * (i * x32)
    return a, gated_x


def _linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t over axis 1 from h_{-1} = 0, for (B, T, W)
    f32 ``a`` and ``b``: Hillis-Steele, ceil(log2 T) passes of elementwise
    ops with the reference's ``combine``. Its tree of products differs from
    ``jax.lax.associative_scan``'s, so f32 results agree to rounding, not
    bit for bit."""
    t, d = a.shape[1], 1
    while d < t:
        # combine(left = element t - d, right = element t)
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rg_lru_scan(x, p) -> torch.Tensor:
    """(B, T, W) -> (B, T, W) by a log-depth scan over the linear RNN."""
    return _linear_scan(*_gates(x, p)).to(x.dtype)


def rg_lru_step(x_t, h_prev, p) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step: x_t (B, W), h_prev (B, W) f32 -> (y, h)."""
    a, bx = _gates(x_t, p)
    h = a * h_prev + bx
    return h.to(x_t.dtype), h


def conv1d_causal(x, w, b):
    """Depthwise causal temporal conv: (B, T, W), w (K, W)."""
    k, t = w.shape[0], x.shape[1]
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        shift = k - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :t]
        acc = acc + xi.float() * w[i]
    return (acc + b).to(x.dtype)


def conv1d_step(x_t, conv_state, w, b):
    """x_t (B, W); conv_state (B, K-1, W) holds the previous inputs."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)      # (B, K, W)
    y = (window.float() * w[None]).sum(dim=1) + b
    return y.to(x_t.dtype), window[:, 1:]


def init_rglru_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
                     device=None) -> Params:
    w = cfg.lru_width_
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                            device=device),
    }


def _gate_branch(x, p):
    return F.gelu(x @ p["w_gate_br"].to(x.dtype), approximate="tanh")


def rglru_block(x, p: Params, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence recurrent block (prefill without a cache)."""
    if isinstance(x, DTensor):
        return _sharded(lambda xl, pl, _: (rglru_block(xl, pl, cfg), None),
                        x, p)[0]
    rec = conv1d_causal(x @ p["w_in"].to(x.dtype), p["conv_w"], p["conv_b"])
    rec = rg_lru_scan(rec, p)
    return (_gate_branch(x, p) * rec) @ p["w_out"].to(x.dtype)


def rglru_prefill(x, p: Params, cfg: ArchConfig, cache: Params):
    """Prefill: the full-sequence block and the final recurrent and conv
    state (a new cache)."""
    if isinstance(x, DTensor):
        return _sharded(lambda xl, pl, cl: rglru_prefill(xl, pl, cfg, cl),
                        x, p, cache)
    gate = _gate_branch(x, p)
    rec_in = x @ p["w_in"].to(x.dtype)
    rec = conv1d_causal(rec_in, p["conv_w"], p["conv_b"])
    h_all = _linear_scan(*_gates(rec, p))
    y = (gate * h_all.to(x.dtype)) @ p["w_out"].to(x.dtype)
    km1 = cfg.conv_width - 1
    return y, {"h": h_all[:, -1].float(),
               "conv": rec_in[:, -km1:].to(cache["conv"].dtype)}


def rglru_decode(x, p: Params, cfg: ArchConfig, cache: Params):
    """One-token step: x (B, 1, D) -> (y, new cache)."""
    if isinstance(x, DTensor):
        return _sharded(lambda xl, pl, cl: rglru_decode(xl, pl, cfg, cl),
                        x, p, cache)
    xt = x[:, 0]
    gate = _gate_branch(xt, p)
    rec = xt @ p["w_in"].to(x.dtype)
    rec, conv_state = conv1d_step(rec, cache["conv"].to(x.dtype),
                                  p["conv_w"], p["conv_b"])
    y_rec, h = rg_lru_step(rec, cache["h"], p)
    y = (gate * y_rec) @ p["w_out"].to(x.dtype)
    return y[:, None], {"h": h, "conv": conv_state.to(cache["conv"].dtype)}


# LRU-width dim of each leaf, as ``sharding.py`` places it on ``model``
_WIDTH_SPECS = {
    "w_gate_br": (None, "M"), "w_in": (None, "M"), "w_out": ("M", None),
    "conv_w": (None, "M"), "conv_b": ("M",), "w_a": ("M", None, None),
    "b_a": ("M",), "w_x": ("M", None, None), "b_x": ("M",), "lambda": ("M",),
}


def _sharded(fn, x, p: Params, cache=None):
    """``fn(x, p, cache) -> (y, new cache or None)`` on this rank's shards:
    x batch-sharded and whole over ``model``, each weight's FSDP dim
    gathered and its LRU width over ``model`` where every leaf's width
    divides (else whole on every rank), the cache in the same layout. The
    output is all-reduced over ``model``; the new cache stays sharded."""
    dt = x.dtype
    x = placed(x, "B", None, None)
    w = {k: placed(v.to(dt) if k in ("w_gate_br", "w_in", "w_out") else v,
                   *_WIDTH_SPECS[k]) for k, v in p.items()}
    split = all(sharded_on(v) for v in w.values())
    if not split:
        w = {k: placed(v, *(None,) * v.dim()) for k, v in w.items()}
    mesh = x.device_mesh
    keys = () if cache is None else ("conv", "h")
    state = {k: placed(cache[k], "B", *(None,) * (cache[k].dim() - 2),
                       "M" if split else None) for k in keys}
    out_pl = (partial_on(x) if split else list(x.placements),) + tuple(
        resolve(mesh, cache[k].shape, ("B",) + (None,) * (cache[k].dim() - 2)
                + ("M" if split else None,)) for k in keys)

    def local(xl, pl, cl):
        y, new = fn(xl, pl, cl if cache is not None else None)
        return (y,) + tuple(new[k] for k in keys)

    out = local_call(local, out_pl, x, w, state)
    y = placed(out[0], "B", None, None)
    return y, (dict(zip(keys, out[1:])) if cache is not None else None)
