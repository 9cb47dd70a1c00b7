"""FusedBlock: the paper's zero-buffer dataflow generalized to LM blocks
(port of ``repro.core.fused_ffn``).

A transformer FFN is the same expand -> mix -> project sandwich as the
MobileNetV2 inverted residual:

    x --[W_gate/W_up: d -> d_ff]--> h --[elementwise act·gate]--> h'
      --[W_down: d_ff -> d]--> y

``ffn_reference`` materializes the (tokens, d_ff) intermediates, the paper's
v0. ``ffn_fused`` streams d_ff in chunks with an f32 output-stationary
accumulator, so no (tokens, d_ff) tensor exists. ``ffn_apply(impl="fused")``
on a CUDA tensor runs the same function as the hand-written fused-FFN kernel
(``kernels/ops.ffn``), which keeps each h chunk in shared memory.

For training, the remat modes carry the idea to the backward pass
(``apply_remat``, ``remat_core``): under ``zero_buffer`` the FFN and
attention cores are recomputed in the backward pass instead of storing
their (tokens, d_ff) hidden or (T, T) scores, recompute-over-store, the
trade the paper makes.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops as kops
from repro_torch.kernels.build import on_card
from repro_torch.kernels.ref import ACTS
from repro_torch.runtime.actctx import local_call, partial_on, placed, sharded_on

Act = Callable[[torch.Tensor], torch.Tensor]


# ---------------------------------------------------------------------------
# Reference (layer-by-layer): intermediates materialized.
# ---------------------------------------------------------------------------


def ffn_reference(x, w_gate, w_up, w_down, *, act: Act = ACTS["silu"]):
    """Gated FFN with the (tokens, d_ff) intermediates materialized."""
    return (act(x @ w_gate) * (x @ w_up)) @ w_down


def ffn_reference_ungated(x, w_up, w_down, *, act: Act = ACTS["gelu"]):
    return act(x @ w_up) @ w_down


# ---------------------------------------------------------------------------
# Fused: d_ff streamed in chunks, output-stationary f32 accumulator.
# ---------------------------------------------------------------------------


def _chunks(d_ff: int, chunk: int):
    if d_ff % chunk:
        chunk = _pick_chunk(d_ff, chunk)
    return [(c, c + chunk) for c in range(0, d_ff, chunk)]


def ffn_fused(x, w_gate, w_up, w_down, *, act: Act = ACTS["silu"],
              chunk: int = 1024):
    """Zero-buffer gated FFN: each chunk's products in x's dtype, the sum
    over chunks in f32. Peak intermediate: (tokens, chunk)."""
    acc = torch.zeros(x.shape[:-1] + (w_down.shape[1],), dtype=torch.float32,
                      device=x.device)
    for lo, hi in _chunks(w_gate.shape[1], chunk):
        h = act(x @ w_gate[:, lo:hi]) * (x @ w_up[:, lo:hi])
        acc = acc + (h @ w_down[lo:hi]).float()
    return acc.to(x.dtype)


def ffn_fused_ungated(x, w_up, w_down, *, act: Act = ACTS["gelu"],
                      chunk: int = 1024):
    acc = torch.zeros(x.shape[:-1] + (w_down.shape[1],), dtype=torch.float32,
                      device=x.device)
    for lo, hi in _chunks(w_up.shape[1], chunk):
        acc = acc + (act(x @ w_up[:, lo:hi]) @ w_down[lo:hi]).float()
    return acc.to(x.dtype)


def _pick_chunk(d_ff: int, want: int) -> int:
    """Largest divisor of d_ff that is <= want (fall back to d_ff)."""
    for c in range(min(want, d_ff), 0, -1):
        if d_ff % c == 0:
            return c
    return d_ff


# ---------------------------------------------------------------------------
# Remat modes: the zero-buffer idea applied to the backward pass.
# ---------------------------------------------------------------------------


REMAT_MODES = ("none", "zero_buffer", "full")


def _check_mode(mode: str) -> None:
    if mode not in REMAT_MODES:
        raise ValueError(
            f"unknown remat mode {mode!r}; one of {REMAT_MODES} (the "
            f"reference's 'dots' is an XLA policy and is not ported)")


def checkpointed(fn: Callable) -> Callable:
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant): its forward
    keeps only its inputs for the backward pass, which runs it again. The
    model draws no random numbers, so no RNG state is carried."""
    def run(*args, **kwargs):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False,
            **kwargs)
    return run


def apply_remat(fn: Callable, mode: str) -> Callable:
    """A pattern unit's function under remat ``mode``, the reference's
    per-unit ``jax.checkpoint``:

    * ``none``: every activation autograd needs is stored;
    * ``zero_buffer``: the unit as is; inside it ``remat_core`` recomputes
      the FFN and attention cores (the reference's policy that refuses to
      save the ``ffn_hidden`` and ``attn_scores`` tensors);
    * ``full``: the whole unit is recomputed from its input (the reference's
      ``nothing_saveable``).

    The reference's ``dots`` (save only matmul outputs without batch dims)
    is an XLA policy with no counterpart here; it raises.
    """
    _check_mode(mode)
    return checkpointed(fn) if mode == "full" else fn


def remat_core(fn: Callable, mode: str) -> Callable:
    """An FFN or attention core under ``mode``: checkpointed under
    ``zero_buffer``, so that its d_ff-wide hidden and its score matrix are
    recomputed rather than stored; as is otherwise. On the kernel paths the
    core is an ``autograd.Function`` that saves only its inputs, so there the
    checkpoint drops only those inputs, and the backward runs the kernel's
    forward once more."""
    _check_mode(mode)
    return checkpointed(fn) if mode == "zero_buffer" else fn


# ---------------------------------------------------------------------------
# Dispatch used by the model
# ---------------------------------------------------------------------------


def ffn_apply(x, params, *, gated: bool, act_name: str, impl: str = "fused",
              chunk: int = 1024):
    """impl: 'reference' (materialize) | 'fused' (zero-buffer).

    ``params``: dict with w_gate/w_up/w_down (gated) or w_up/w_down, cast to
    x's dtype here (a no-op for weights already stored in it). ``fused`` on
    a CUDA tensor launches the fused-FFN kernel on the (tokens, d) rows; on
    a CPU tensor it runs the chunked plain dataflow. On a mesh (DTensors),
    ``_ffn_sharded``.
    """
    if impl not in ("reference", "fused"):
        raise ValueError(f"unknown FFN impl {impl!r} (reference | fused)")
    if isinstance(x, DTensor):
        return _ffn_sharded(x, params, gated=gated, act_name=act_name,
                            impl=impl, chunk=chunk)
    act = ACTS[act_name]
    dt = x.dtype
    w_up = params["w_up"].to(dt)
    w_down = params["w_down"].to(dt)
    w_gate = params["w_gate"].to(dt) if gated else None
    if impl == "fused" and on_card(x):
        lead = x.shape[:-1]
        y = kops.ffn(x.reshape(-1, x.shape[-1]).contiguous(), w_gate, w_up,
                     w_down, act=act_name)
        return y.reshape(*lead, y.shape[-1])
    if gated:
        if impl == "reference":
            return ffn_reference(x, w_gate, w_up, w_down, act=act)
        return ffn_fused(x, w_gate, w_up, w_down, act=act, chunk=chunk)
    if impl == "reference":
        return ffn_reference_ungated(x, w_up, w_down, act=act)
    return ffn_fused_ungated(x, w_up, w_down, act=act, chunk=chunk)


def _ffn_sharded(x, params, *, gated: bool, act_name: str, impl: str,
                 chunk: int):
    """The FFN on a mesh, Megatron-style, as the reference's pins lay it
    out: each weight cast to x's dtype, then its FSDP dim gathered (the
    reference pins (D, M) / (M, D) on the bf16 copies, so XLA gathers bf16
    there); d_ff stays on ``model``. Each rank runs the one-device FFN (on
    a card the kernel) on its tokens and its d_ff columns, a partial sum
    over ``model`` that is all-reduced here."""
    dt = x.dtype
    lead = (None,) * (x.dim() - 1)
    x = placed(x, "B", *lead)
    w = {"w_up": placed(params["w_up"].to(dt), None, "M"),
         "w_down": placed(params["w_down"].to(dt), "M", None)}
    if gated:
        w["w_gate"] = placed(params["w_gate"].to(dt), None, "M")
    out_pl = (partial_on(x) if sharded_on(w["w_up"]) else list(x.placements),)
    y = local_call(lambda xl, wl: (ffn_apply(xl, wl, gated=gated,
                                             act_name=act_name, impl=impl,
                                             chunk=chunk),),
                   out_pl, x, w)[0]
    return placed(y, "B", *lead)
