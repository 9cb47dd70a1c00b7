"""Public entry points for the kernels: one call per fused block, FFN or
attention.

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the kernel's plain PyTorch version. Model code calls
these wrappers, never the kernels directly. The flash and FFN launches are
differentiable: under grad the kernel still runs the forward, and the
backward goes through the plain version (``fused_ffn.FusedFFN``,
``flash_attention.FlashAttention``, the latter ``block`` queries at a
time). The DSC kernel is int8 inference and has no gradient.

``ffn``, ``attention`` and ``mha`` also take DTensors (a mesh): each rank
runs the same call on its local shards through ``local_map``, so the
inputs must be placed for that (``_local``): an FFN's rows on the batch
axes and its d_ff on ``model`` (the output then a partial sum over
``model``), attention's heads split alike over q, k and v (GQA's KV heads
with their query heads).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_dsc as _dsc
from repro_torch.kernels import fused_ffn as _ffn
from repro_torch.kernels import ref


def dsc_block(x_q: torch.Tensor, w_exp, w_dw9, w_proj, b_exp, b_dw, b_proj,
              m_exp, m_dw, m_proj, *, stride: int, zps, q6,
              tile_rows: Optional[int] = None) -> torch.Tensor:
    """One fused Ex->Dw->Pr inverted-residual block (no residual add) on a
    (B, H, W, C) int8 batch. ``tile_rows`` None lets the kernel's plan pick
    the rows per unit."""
    args = (x_q, w_exp, w_dw9, w_proj, b_exp, b_dw, b_proj, m_exp, m_dw,
            m_proj)
    if x_q.device.type == "cuda":
        return _dsc.fused_dsc_cuda(*args, stride=stride, zps=zps, q6=q6,
                                   tile_rows=tile_rows)
    if x_q.device.type == "cpu":
        return ref.fused_dsc_ref(*args, stride=stride, zps=zps, q6=q6)
    raise ValueError(f"dsc_block: unsupported device {x_q.device}")


def ffn(x: torch.Tensor, w_gate: Optional[torch.Tensor], w_up: torch.Tensor,
        w_down: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    """Fused gated (or, with ``w_gate`` None, ungated) FFN on a (T, d)
    token tile."""
    if isinstance(x, DTensor):
        return _local(lambda *a: ffn(*a, act=act), x, w_up,
                      x, w_gate, w_up, w_down)
    if _dsc.on_card(x):
        return _ffn.fused_ffn(x, w_gate, w_up, w_down, act=act)
    if x.device.type == "cpu":
        return ref.fused_ffn_ref(x, w_gate, w_up, w_down, act=act)
    raise ValueError(f"ffn: unsupported device {x.device}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None,
              sm_scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention on (BH, Tq, d) tensors."""
    kw = dict(causal=causal, window=window, softcap=softcap,
              sm_scale=sm_scale)
    if isinstance(q, DTensor):
        return _local(lambda *a: attention(*a, **kw), q, None, q, k, v)
    if _dsc.on_card(q):
        return _fa.flash_attention(q[:, :, None], k[:, :, None],
                                   v[:, :, None], **kw)[:, :, 0]
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, **kw)
    raise ValueError(f"attention: unsupported device {q.device}")


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        n_kv_heads: int, causal: bool = True, window: Optional[int] = None,
        softcap: Optional[float] = None,
        sm_scale: Optional[float] = None, block: int = 1024) -> torch.Tensor:
    """Multi-head GQA attention: (B, T, H, d) q, (B, T, Hkv, d) k/v.

    Query head ``h`` attends with KV head ``h // (H // Hkv)``. The kernel
    indexes that head in place; the plain version repeats K and V.
    ``block``: the queries a block of the kernel's backward takes (the
    config's ``attn_chunk``).
    """
    if k.shape[2] != n_kv_heads or v.shape[2] != n_kv_heads:
        raise ValueError(f"k/v have {k.shape[2]}/{v.shape[2]} heads, "
                         f"expected n_kv_heads={n_kv_heads}")
    kw = dict(causal=causal, window=window, softcap=softcap,
              sm_scale=sm_scale)
    if isinstance(q, DTensor):
        return _local(lambda q, k, v: mha(q, k, v, n_kv_heads=k.shape[2],
                                          block=block, **kw), q, None,
                      q, k, v)
    if _dsc.on_card(q):
        return _fa.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), block=block, **kw)
    if q.device.type == "cpu":
        return ref.mha_ref(q, k, v, **kw)
    raise ValueError(f"mha: unsupported device {q.device}")


def _local(fn, like: DTensor, reduced, *args):
    """``fn`` on each rank's shards of ``args``; the output placed as
    ``like``, a partial sum over ``model`` where ``reduced`` (the FFN's
    d_ff) is sharded there."""
    from repro_torch.runtime.actctx import local_call, partial_on, sharded_on
    pl = (partial_on(like) if reduced is not None and sharded_on(reduced)
          else list(like.placements))
    return local_call(lambda *a: (fn(*a),), (pl,), *args)[0]
