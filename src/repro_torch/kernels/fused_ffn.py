"""Launcher for the hand-written fused-FFN kernel (``csrc/fused_ffn.cu``).

Port of ``repro.kernels.fused_ffn.fused_ffn_pallas``: y = act(x @ Wg) *
(x @ Wu) @ Wd (or ungated act(x @ Wu) @ Wd) in one launch, the (T, d_ff)
intermediate kept in shared memory. The kernel splits d_ff over thread
blocks; each writes an f32 partial output to a workspace this wrapper
allocates, and a second kernel of the same launch sums the partials in a
fixed order. The plain PyTorch version is ``ref.fused_ffn_ref``.

``LAUNCHES`` counts the launches this wrapper made, so a run can show that
its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_dsc import check_tensor

LAUNCHES = 0

_vp, _int = ctypes.c_void_p, ctypes.c_int
# 6 pointers, 7 ints, the stream: the order of fused_ffn_launch's
# parameters in csrc/fused_ffn.cu.
_ARGTYPES = [_vp] * 6 + [_int] * 7 + [_vp]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ACT_CODES = {"silu": 0, "gelu": 1, "relu_sq": 2, "relu": 3}
CHUNK = 128                 # d_ff columns per expansion sub-block
H_SMEM_BYTES = 128 * 1024   # shared memory for the block's h tile


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one launch tiles its work."""

    block_t: int     # token rows per thread block
    fr: int          # d_ff columns per split (a multiple of CHUNK)
    splits: int      # thread blocks along d_ff = workspace slices
    t_pad: int       # T rounded up to block_t


def plan(t: int, d_ff: int, dtype: torch.dtype, n_sm: int) -> Plan:
    """Token tile and d_ff split for T tokens: as few splits as the h tile
    allows, but at least two thread blocks per SM where d_ff has room."""
    if dtype == torch.bfloat16:
        block_t = 16 if t <= 16 else 64
    else:
        block_t = 16
    item = 2 if dtype == torch.bfloat16 else 4
    max_chunks = H_SMEM_BYTES // (block_t * item * CHUNK)
    chunks = -(-d_ff // CHUNK)
    tiles = -(-t // block_t)
    splits = min(chunks, max(-(-chunks // max_chunks), -(-2 * n_sm // tiles)))
    per = -(-chunks // splits)
    return Plan(block_t=block_t, fr=per * CHUNK, splits=-(-chunks // per),
                t_pad=tiles * block_t)


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_ffn").lib
    if lib.fused_ffn_launch.argtypes is None:
        lib.fused_ffn_launch.argtypes = _ARGTYPES
        lib.fused_ffn_launch.restype = _int
        lib.fused_ffn_error_string.argtypes = [_int]
        lib.fused_ffn_error_string.restype = ctypes.c_char_p
    return lib


def fused_ffn_cuda(x: torch.Tensor, w_gate: Optional[torch.Tensor],
                   w_up: torch.Tensor, w_down: torch.Tensor, *,
                   act: str = "silu") -> torch.Tensor:
    """Launch the fused FFN kernel on CUDA tensors.

    Args:
      x: (T, d_model). w_gate, w_up: (d_model, d_ff); w_gate None for an
        ungated FFN. w_down: (d_ff, d_model). All contiguous, one dtype,
        float32 or bfloat16; d_model and d_ff multiples of 16.
      act: silu | gelu (tanh) | relu_sq | relu.
    Returns: (T, d_model) in x's dtype, on x's device and current stream.
    """
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn_cuda needs CUDA tensors, got {x.device}")
    if x.dim() != 2 or w_up.dim() != 2:
        raise ValueError(f"x must be (T, d_model) and w_up (d_model, d_ff), "
                         f"got {tuple(x.shape)}, {tuple(w_up.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused FFN takes float32 or bfloat16, got {x.dtype}")
    if act not in ACT_CODES:
        raise ValueError(f"unknown act {act!r}; one of {sorted(ACT_CODES)}")
    t, d = x.shape
    f = w_up.shape[1]
    if t < 1 or d % 16 or f % 16:
        raise ValueError(f"need T >= 1 and d_model, d_ff multiples of 16, got "
                         f"T {t}, d_model {d}, d_ff {f}")
    dev = x.device
    check_tensor(x, "x", x.dtype, (t, d), dev)
    if w_gate is not None:
        check_tensor(w_gate, "w_gate", x.dtype, (d, f), dev)
    check_tensor(w_up, "w_up", x.dtype, (d, f), dev)
    check_tensor(w_down, "w_down", x.dtype, (f, d), dev)
    pl = plan(t, f, x.dtype, torch.cuda.get_device_properties(dev)
              .multi_processor_count)
    ws = torch.empty((pl.splits, pl.t_pad, d), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_ffn_launch(
            x.data_ptr(), None if w_gate is None else w_gate.data_ptr(),
            w_up.data_ptr(), w_down.data_ptr(), ws.data_ptr(), out.data_ptr(),
            _DTYPES[x.dtype], t, d, f, ACT_CODES[act], pl.block_t, pl.fr,
            stream)
    if err != 0:
        msg = lib.fused_ffn_error_string(err).decode()
        raise RuntimeError(f"fused_ffn kernel launch failed: {msg} ({err})")
    LAUNCHES += 1
    return out
