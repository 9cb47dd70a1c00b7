"""Shared transformer layer machinery: norms, RoPE, attention (port of
``repro.models.layers``, single device).

Attention ships in three disciplines, mirroring the DSC block:

* ``reference`` — materializes the (Tq, Tk) score matrix (the layer-by-layer
  baseline; the attention analogue of storing F1/F2).
* ``fused``     — chunked online softmax over K/V blocks: the score matrix
  exists only one (Tq, block) tile at a time. Plain torch.
* ``kernel``    — ``kernels/ops.mha``: the hand-written CUDA flash-attention
  kernel on a CUDA tensor, its plain version on a CPU tensor. The
  counterpart of the reference's ``pallas``.

Decode attention is plain torch in every discipline, as in the reference.
Weights are plain nested dicts of tensors.

On a mesh (DTensor activations and weights, ``runtime/sharding.py``) each
attention entry point runs on local shards (``_sharded_attention``): the
weights' FSDP dim gathered (the all-gather XLA inserts at the reference's
``constrain`` pins), heads over ``model`` where they divide, the output a
partial sum over ``model`` reduced at the residual. A decode step whose KV
heads do not divide the ``model`` axis takes the reference's
sequence-sharded branch: the cache is sharded along its sequence, each rank
scores its own slots in the grouped-GQA form (no KV repeat), and the
softmax and PV combine across ranks by three small all-reduces.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.core import fused_ffn as ffnlib
from repro_torch.kernels import ops as kops
from repro_torch.kernels.build import on_card
from repro_torch.runtime.actctx import (grad_dtype_guard, local_call,
                                        local_rank, mesh_size, partial_on,
                                        placed, sharded_on)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, *, eps: float = 1e-6, zero_centered: bool = False,
             dtype=None):
    """RMSNorm in f32 (gemma-style optional (1+scale) parameterization),
    returned in ``dtype`` (default x's). On a DTensor whose last dim is
    whole, on local shards: one ``local_map`` in place of seven DTensor
    ops."""
    if isinstance(x, DTensor) and not any(
            p.is_shard(x.dim() - 1) for p in x.placements):
        return local_call(
            lambda xl, sl: (rms_norm(xl, sl, eps=eps,
                                     zero_centered=zero_centered,
                                     dtype=dtype),),
            (list(x.placements),), x, placed(scale, None))[0]
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    s = (1.0 + scale.float()) if zero_centered else scale.float()
    return (y * s).to(dtype or x.dtype)


def init_rms(d: int, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Parameter leaves
# ---------------------------------------------------------------------------

# Leaves the reference uses at their f32 masters also when it computes in
# bf16 (it never casts them to the compute dtype), so the port stores them
# in f32 whatever the model's dtype, as it does every norm scale: the MoE
# router (``moe.py:74``: in bf16 it would change which experts a token goes
# to), RG-LRU's gates, temporal conv and Lambda, RWKV6's decay, bonus and
# ln_x.
F32_LEAVES = frozenset({
    "router", "route_bias",
    "conv_w", "conv_b", "w_a", "b_a", "w_x", "b_x", "lambda",
    "decay_A", "decay_B", "decay_base", "bonus_u", "ln_x"})


def leaf_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype a parameter leaf named ``name`` is stored in: f32 for norm
    scales and ``F32_LEAVES``, ``dtype`` for every other leaf."""
    return torch.float32 if "norm" in name or name in F32_LEAVES else dtype


def normal_leaf(gen, name: str, shape, scale: float, device, dtype):
    """Seeded normal weights drawn in f32 from ``gen``, times ``scale``,
    stored in ``leaf_dtype(name, dtype)``."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(scale).to(leaf_dtype(name, dtype))


# ---------------------------------------------------------------------------
# RoPE (with partial-rotary fraction, glm4-style)
# ---------------------------------------------------------------------------


def _rotated(head_dim: int, fraction: float) -> int:
    return int(head_dim * fraction) // 2 * 2


def rope_freqs(head_dim: int, fraction: float, theta: float):
    rot = _rotated(head_dim, fraction)
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    return rot, torch.from_numpy(np.asarray(inv, np.float32))  # (rot/2,)


# Constants the LM step multiplies by, each kept on its device once made:
# a copy from host memory on every call would stop the host, since PyTorch
# ends a blocking copy from pageable memory with a stream synchronise.
_ON_DEVICE: Dict[tuple, torch.Tensor] = {}
ROPE_TABLES = 0     # RoPE tables built: one per key and device in a process


def on_device(key: tuple, like: torch.Tensor, make) -> torch.Tensor:
    """``make()``, a host tensor, on ``like``'s device: copied once per
    ``(key, like.device)`` and kept. On a fake ``like`` (the dry run's
    ``FakeTensorMode``) it is made anew: a fake tensor belongs to its
    mode."""
    if isinstance(like, FakeTensor):
        return make().to(like.device)
    k = key + (like.device,)
    if k not in _ON_DEVICE:
        _ON_DEVICE[k] = make().to(like.device)
    return _ON_DEVICE[k]


def rope_table(head_dim: int, fraction: float, theta: float,
               like: torch.Tensor) -> torch.Tensor:
    """``rope_freqs``'s inverse frequencies on ``like``'s device, built
    once per (head_dim, fraction, theta, device); ``ROPE_TABLES`` counts
    the builds."""
    def make():
        global ROPE_TABLES
        ROPE_TABLES += 1
        return rope_freqs(head_dim, fraction, theta)[1]
    return on_device(("rope", head_dim, fraction, theta), like, make)


def apply_rope(x, positions, *, head_dim: int, fraction: float, theta: float):
    """x: (..., T, H, hd); positions: (..., T) integer."""
    rot = _rotated(head_dim, fraction)
    if rot == 0:
        return x
    inv = rope_table(head_dim, fraction, theta, x)
    ang = positions[..., None].float() * inv                 # (..., T, rot/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., T, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]        # half-split layout
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Attention math (three disciplines)
# ---------------------------------------------------------------------------


def _mask(q_pos, k_pos, *, causal, window, kv_len=None):
    m = torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= q_pos >= k_pos
    if window is not None:
        m &= (q_pos - k_pos) < window
    if kv_len is not None:
        m &= k_pos < kv_len
    return m


def repeat_kv(k, n_heads: int):
    """(B, T, Hkv, d) -> (B, T, H, d) by repeating each kv head."""
    hkv = k.shape[2]
    if hkv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // hkv, dim=2)


def attention_reference(q, k, v, q_pos, k_pos, *, causal, window,
                        softcap, sm_scale, kv_len=None):
    """(B, Tq, H, d) x (B, Tk, Hkv, d); materializes (Tq, Tk) scores."""
    h = q.shape[2]
    k = repeat_kv(k, h)
    v = repeat_kv(v, h)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    m = _mask(q_pos[:, None], k_pos[None, :], causal=causal, window=window,
              kv_len=kv_len)
    s = torch.where(m[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    p = torch.where(m.any(-1)[None, None, :, None], p, torch.zeros_like(p))
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def attention_fused(q, k, v, q_pos, k_pos, *, causal, window, softcap,
                    sm_scale, block_k: int = 1024, kv_len=None):
    """Chunked online-softmax attention (zero-buffer scores), plain torch.

    Loops over K/V blocks; the running (max, denom, acc) triple is the
    output-stationary accumulator. q is pre-scaled in its own dtype, scores
    run in f32, and the P tile is cast back to the compute dtype for the PV
    product, as in the reference.
    """
    b, tq, h, d = q.shape
    tk = k.shape[1]
    k = repeat_kv(k, h)
    v = repeat_kv(v, h)
    # the reference's guard: the f32 online-softmax cotangents stay out of
    # the bf16 projections' backward (torch's casts already give a bf16
    # tensor a bf16 gradient; the guard states it)
    q, k, v = (grad_dtype_guard(t) for t in (q, k, v))
    block_k = min(block_k, tk)
    qs = (q.float() * sm_scale).to(q.dtype).float()
    m_run = torch.full((b, h, tq, 1), -1e30, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, h, tq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device)
    for lo in range(0, tk, block_k):
        hi = min(lo + block_k, tk)
        s = torch.einsum("bqhd,bkhd->bhqk", qs, k[:, lo:hi].float())
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        msk = _mask(q_pos[:, None], k_pos[None, lo:hi], causal=causal,
                    window=window, kv_len=kv_len)
        s = torch.where(msk[None, None], s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m_run - m_new)
        l_run = alpha * l_run + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                          v[:, lo:hi].float())
        acc = alpha * acc + pv
        m_run = m_new
    denom = torch.where(l_run == 0.0, torch.ones_like(l_run), l_run)
    return (acc / denom).transpose(1, 2).to(q.dtype)


def attention_kernel(q, k, v, q_pos, k_pos, *, causal, window, softcap,
                     sm_scale, kv_len=None, block: int = 1024):
    """The flash-attention kernel (contiguous positions only — the
    prefill path); its backward takes ``block`` queries at a time."""
    del q_pos, k_pos, kv_len
    return kops.mha(q, k, v, n_kv_heads=k.shape[2], causal=causal,
                    window=window, softcap=softcap, sm_scale=sm_scale,
                    block=block)


ATTN_IMPLS = {
    "reference": attention_reference,
    "fused": attention_fused,
    "kernel": attention_kernel,
}


# ---------------------------------------------------------------------------
# Attention layer (projections + rope + cache)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ArchConfig, device=None,
                   dtype=torch.float32) -> Params:
    """Seeded random q/k/v/o weights (normal, fan-in scaled), drawn in f32
    from ``gen`` and stored in ``dtype``. Pad heads are zero."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    hp = cfg.n_heads_padded
    scale = d ** -0.5

    def normal(shape, s):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * s
        return w.to(dtype)

    def padh(w, axis):
        """Zero-init padded heads, inserted PER KV GROUP so every real
        q-head keeps its original kv assignment: head = kv*g_pad + i with
        i < g real, i >= g zero."""
        if hp == h:
            return w
        if (hp - h) % hkv:
            raise ValueError("head_pad must be a multiple of kv heads")
        g, gp = h // hkv, hp // hkv
        shape = list(w.shape)
        shape[axis:axis + 1] = [hkv, g]
        wg = w.reshape(shape)
        pad_shape = list(wg.shape)
        pad_shape[axis + 1] = gp - g
        wg = torch.cat([wg, torch.zeros(pad_shape, dtype=w.dtype,
                                        device=w.device)], dim=axis + 1)
        shape[axis:axis + 2] = [hp]
        return wg.reshape(shape)

    p = {
        "wq": padh(normal((d, h, hd), scale), 1),
        "wk": normal((d, hkv, hd), scale),
        "wv": normal((d, hkv, hd), scale),
        "wo": padh(normal((h, hd, d), (h * hd) ** -0.5), 0),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hp, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((hkv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((hkv, hd), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rms(hd, device)
        p["k_norm"] = init_rms(hd, device)
    if cfg.attn_gate:
        p["wg"] = padh(normal((d, h, hd), scale), 1)
    return p


def _rotates(cfg: ArchConfig, local: bool) -> bool:
    """Whether a layer applies RoPE: every layer, or with
    ``rope_local_only`` the ``attn_local`` layers alone (global NoPE)."""
    return local or not cfg.rope_local_only


def _output(o, x, p, cfg: ArchConfig):
    """The attention's output projection of o (B, T, H, hd); with
    ``attn_gate`` each head's output first times sigmoid(x W_g), x the
    attention's input."""
    if cfg.attn_gate:
        o = o * torch.sigmoid(torch.einsum("btd,dhk->bthk", x,
                                           p["wg"].to(x.dtype)))
    return torch.einsum("bthk,hkd->btd", o, p["wo"].to(x.dtype))


def _project_qkv(x, p, cfg: ArchConfig, positions, rope: bool = True):
    dt = x.dtype
    q = torch.einsum("btd,dhk->bthk", x, p["wq"].to(dt))
    k = torch.einsum("btd,dhk->bthk", x, p["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], eps=cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], eps=cfg.norm_eps)
    if not rope:
        return q, k, v
    hd = cfg.head_dim_
    q = apply_rope(q, positions, head_dim=hd, fraction=cfg.rope_fraction,
                   theta=cfg.rope_theta)
    k = apply_rope(k, positions, head_dim=hd, fraction=cfg.rope_fraction,
                   theta=cfg.rope_theta)
    return q, k, v


def _attend(q, k, v, positions, cfg: ArchConfig, *, local: bool):
    window = cfg.window if local else None
    impl = ATTN_IMPLS[cfg.attn_impl]
    kw = dict(causal=cfg.causal, window=window, softcap=cfg.attn_softcap,
              sm_scale=cfg.head_dim_ ** -0.5)
    if cfg.attn_impl == "fused":
        kw["block_k"] = cfg.attn_chunk
    elif cfg.attn_impl == "kernel":
        kw["block"] = cfg.attn_chunk
    return impl(q, k, v, positions[0], positions[0], **kw)


def attention_layer(x, p, cfg: ArchConfig, *, local: bool,
                    positions=None, remat: str = "none",
                    heads: Optional["Heads"] = None) -> torch.Tensor:
    """Full-sequence attention (prefill without cache). ``remat``: the
    unit's remat mode; under ``zero_buffer`` the attention core (scores,
    softmax, PV) is recomputed in the backward pass, not stored. ``heads``:
    which heads this rank holds, on a mesh (None: all)."""
    if isinstance(x, DTensor):
        return _sharded_attention(
            lambda xl, pl, _, heads: (attention_layer(
                xl, pl, cfg, local=local, positions=positions, remat=remat,
                heads=heads),), x, p, cfg)
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)[None].repeat(b, 1)
    q, k, v = _project_qkv(x, p, cfg, positions, _rotates(cfg, local))
    k, v = _kv_for(k, v, cfg, heads)
    o = ffnlib.remat_core(_attend, remat)(q, k, v, positions, cfg,
                                          local=local)
    return _output(o, x, p, cfg)


# --- KV cache ---------------------------------------------------------------


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, *, local: bool,
                  dtype=torch.bfloat16, device=None) -> Params:
    size = min(max_len, cfg.window) if (local and cfg.window) else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_prefill(x, p, cfg: ArchConfig, cache, *, local: bool,
                      heads: Optional["Heads"] = None):
    """Prefill: full-sequence attention + populate the KV cache in place.

    Local layers keep only the trailing ``window`` keys (ring buffer); the
    write offset is chosen so subsequent decode steps continue the ring.
    """
    if isinstance(x, DTensor):
        out = _sharded_attention(
            lambda xl, pl, cl, heads: (attention_prefill(
                xl, pl, cfg, cl, local=local, heads=heads)[0],),
            x, p, cfg, cache)
        return out, cache
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)[None].repeat(b, 1)
    q, k, v = _project_qkv(x, p, cfg, positions, _rotates(cfg, local))
    size = heads.cache_len if heads is not None else cache["k"].shape[1]
    if t >= size:   # keep last `size` keys, aligned to the ring phase
        start = t - size
        # ring slot of absolute position p is p % size; roll so slot matches
        shift = (t - size) % size
        rows_k = torch.roll(k[:, start:], shift, dims=1)
        rows_v = torch.roll(v[:, start:], shift, dims=1)
    else:
        rows_k, rows_v = k, v
    seq_off = heads.seq_off if heads is not None else 0
    _write_rows(cache["k"], rows_k, 0, seq_off)
    _write_rows(cache["v"], rows_v, 0, seq_off)
    k, v = _kv_for(k, v, cfg, heads)
    o = _attend(q, k, v, positions, cfg, local=local)
    return _output(o, x, p, cfg), cache


def attention_decode(x, p, cfg: ArchConfig, cache, pos: int, *, local: bool,
                     heads: Optional["Heads"] = None):
    """One-token decode step against the cache, which it updates in place.

    ``pos``: the absolute position of the incoming token. The cache is a
    ring buffer for local layers (slot = pos % size) and a flat buffer for
    global layers. The attention is the grouped-GQA form
    (``_decode_grouped``): the cache is read once, in its own dtype, with
    no per-head repeat; scores and the PV product accumulate in f32, as
    the reference's ``preferred_element_type`` does. On a mesh whose
    ``model`` axis the KV heads do not divide, the sequence-sharded branch
    (``_decode_seq_sharded``).
    """
    if isinstance(x, DTensor):
        out = _sharded_attention(
            lambda xl, pl, cl, heads: (attention_decode(
                xl, pl, cfg, cl, pos, local=local, heads=heads)[0],),
            x, p, cfg, cache)
        return out, cache
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = _project_qkv(x, p, cfg, positions, _rotates(cfg, local))
    ck, cv = cache["k"], cache["v"]
    size = heads.cache_len if heads is not None else ck.shape[1]
    seq_off = heads.seq_off if heads is not None else 0
    is_ring = bool(local and cfg.window and size == cfg.window)
    slot = (pos % size) if is_ring else pos
    _write_rows(ck, k, slot, seq_off)
    _write_rows(cv, v, slot, seq_off)
    # Positions of cached slots.
    idx = torch.arange(seq_off, seq_off + ck.shape[1], device=x.device)
    if is_ring:
        # slot i holds the most recent position p' <= pos with p' % size == i
        k_pos = pos - torch.remainder(pos - idx, size)
    else:
        k_pos = idx
    valid = (k_pos >= 0) & (k_pos <= pos)
    if local and cfg.window:
        valid &= (pos - k_pos) < cfg.window
    if heads is not None and heads.seq_sharded:
        o = _decode_seq_sharded(q, ck, cv, valid, cfg, heads)
    else:
        o = _decode_grouped(q, *_kv_for(ck, cv, cfg, heads), valid, cfg)
    return _output(o, x, p, cfg), cache


# ---------------------------------------------------------------------------
# Attention on a mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Heads:
    """What one rank holds of an attention layer on a mesh: query heads
    [q_off, q_off + n_q) of ``n_heads_padded``, the cache's slots
    [seq_off, seq_off + local) of ``cache_len``, the ``model`` group where
    the cache is sharded along its sequence, and whether the layer takes
    the sequence-sharded decode branch."""

    q_off: int
    n_q: int
    cache_len: int = 0
    seq_off: int = 0
    group: Any = None
    seq_sharded: bool = False


def _attn_weights(p, dt):
    """The attention weights at their compute placements: each cast to the
    compute dtype, then its FSDP dim gathered (the reference pins (D, M) and
    XLA gathers D there); heads stay on ``model`` where they divide."""
    out = {}
    for name, leaf in p.items():
        if name in ("wq", "wk", "wv"):
            out[name] = placed(leaf.to(dt), None, "M", None)
        elif name == "wo":
            out[name] = placed(leaf.to(dt), "M", None, None)
        elif name in ("bq", "bk", "bv"):
            out[name] = placed(leaf.to(dt), "M", None)
        else:
            out[name] = placed(leaf, *(None,) * leaf.dim())
    return out


def _sharded_attention(fn, x, p, cfg: ArchConfig, cache=None):
    """``fn(x, p, cache, heads)`` (a one-device attention entry point, its
    output in a 1-tuple) on this rank's shards: x batch-sharded and whole
    over ``model``, the weights as ``_attn_weights`` places them, the cache
    as it is placed (``sharding.cache_specs``). Returns the output, a
    partial sum over ``model`` where the heads are sharded, reduced
    here."""
    mesh = x.device_mesh
    x = placed(x, "B", None, None)
    w = _attn_weights(p, x.dtype)
    q_sharded = sharded_on(w["wq"])
    m = mesh_size(mesh, "model")
    n_q = cfg.n_heads_padded // (m if q_sharded else 1)
    cache_len = 0 if cache is None else cache["k"].shape[1]
    seq_cut = cache is not None and sharded_on(cache["k"]) and \
        not sharded_on(w["wk"])
    r = local_rank(mesh, "model")
    heads = Heads(r * n_q if q_sharded else 0, n_q, cache_len,
                  r * (cache_len // m) if seq_cut else 0,
                  mesh.get_group("model") if seq_cut else None,
                  # the reference's branch: KV heads that do not divide
                  # the model axis
                  seq_sharded=cfg.n_kv_heads % m != 0)
    out_pl = (partial_on(x) if q_sharded else list(x.placements),)
    out = local_call(lambda xl, pl, cl: fn(xl, pl, cl, heads), out_pl,
                     x, w, cache)
    return placed(out[0], "B", None, None)


def _kv_for(k, v, cfg: ArchConfig, heads: Optional[Heads]):
    """The KV heads this rank's query heads read: all of them off a mesh
    or where the KV heads are sharded alike; else the slice of the whole
    set that query heads [q_off, q_off + n_q) map to (head h reads KV head
    h // (H / Hkv))."""
    if heads is None or k.shape[2] != cfg.n_kv_heads or \
            heads.n_q == cfg.n_heads_padded:
        return k, v
    g = cfg.n_heads_padded // cfg.n_kv_heads
    if heads.n_q % g and g % heads.n_q:
        raise ValueError(f"{heads.n_q} local query heads split a KV group "
                         f"of {g}")
    lo = heads.q_off // g
    hi = (heads.q_off + heads.n_q - 1) // g + 1
    return k[:, :, lo:hi], v[:, :, lo:hi]


def _write_rows(leaf, rows, start: int, seq_off: int) -> None:
    """Write ``rows`` (B, n, H, d), the cache's slots [start, start + n),
    into ``leaf``, which holds slots [seq_off, seq_off + leaf's length)."""
    lo = max(start, seq_off)
    hi = min(start + rows.shape[1], seq_off + leaf.shape[1])
    if lo < hi:
        leaf[:, lo - seq_off:hi - seq_off] = rows[:, lo - start:hi - start]


def _f32_bmm(a, b):
    """a @ b for the cache's dtype with an f32 result and no f32 copy of
    ``b`` on the card (``out_dtype``: the reference's
    ``preferred_element_type``). The CPU has no such product, and there the
    operands are upcast: a copy of this rank's cache slice, per KV head."""
    if on_card(b):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _decode_grouped(q, ck, cv, valid, cfg: ArchConfig, group=None):
    """Decode attention in the grouped-GQA form: query heads q (B, 1, H,
    hd), head h reading KV head h // (H / Hkv) of ck, cv (B, S, Hkv, hd),
    over the slots ``valid`` marks. The cache is read once, in its own
    dtype: no KV repeat, no f32 copy on the card. q is scaled and rounded
    to the cache's dtype, scores and PV accumulate in f32 (``_f32_bmm``),
    softcap, mask and softmax run in f32 and the probabilities are rounded
    to the cache's dtype, as in the reference. Where ``group`` holds the
    ranks that share the sequence, the softmax max and sum and the PV
    product are all-reduced over it. Returns o (B, 1, H, hd) in q's
    dtype."""
    b, _, h, hd = q.shape
    hkv = ck.shape[2]
    qg = (q.float() * hd ** -0.5).to(ck.dtype).reshape(b, hkv, h // hkv, hd)
    # (B, Hkv, g, S) scores, one KV head at a time: every product reads
    # its head of the cache in place
    s = torch.stack([_f32_bmm(qj, kj.transpose(1, 2))
                     for qj, kj in zip(qg.unbind(1), ck.unbind(2))], dim=1)
    if cfg.attn_softcap is not None:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    s = torch.where(valid, s, -1e30)
    if group is None:
        pattn = torch.softmax(s, dim=-1)
    else:
        m = funcol.all_reduce(s.amax(dim=-1, keepdim=True), "max", group)
        e = torch.exp(s - m)
        denom = funcol.all_reduce(e.sum(dim=-1, keepdim=True), "sum", group)
        pattn = e / denom
    pattn = pattn.to(cv.dtype)
    o = torch.stack([_f32_bmm(pj, vj) for pj, vj in          # (B, Hkv, g, hd)
                     zip(pattn.unbind(1), cv.unbind(2))], dim=1)
    if group is not None:
        o = funcol.all_reduce(o, "sum", group)
    return o.reshape(b, 1, h, hd).to(q.dtype)


def _decode_seq_sharded(q, ck, cv, valid, cfg: ArchConfig, heads: Heads):
    """The reference's sequence-sharded decode attention: every query head
    (gathered over ``model``) against this rank's cache slots, in the
    grouped-GQA form (``_decode_grouped``), its softmax and PV reduced over
    the ranks that share the sequence. Returns this rank's query heads of
    o (B, 1, n_q, hd) in q's dtype."""
    group = heads.group
    off, n_q = 0, q.shape[2]
    if group is None:               # the whole sequence here
        ck, cv = _kv_for(ck, cv, cfg, heads)
    elif n_q < cfg.n_heads_padded:
        q = funcol.all_gather_tensor(q.contiguous(), 2, group)
        off = heads.q_off
    o = _decode_grouped(q, ck, cv, valid, cfg, group)
    return o[:, :, off:off + n_q]
