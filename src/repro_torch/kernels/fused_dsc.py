"""Launcher for the hand-written fused DSC kernel (``csrc/fused_dsc.cu``).

Port of ``repro.kernels.fused_dsc.fused_dsc_pallas``: one launch computes an
entire inverted-residual block (Expansion -> Depthwise -> Projection, no
residual add) for a batch of NHWC int8 maps, with F1 and F2 kept in shared
memory. The plain PyTorch version is ``ref.fused_dsc_ref``.

``LAUNCHES`` counts the kernel launches this wrapper made, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

LAUNCHES = 0

_vp, _int = ctypes.c_void_p, ctypes.c_int
# 11 pointers, 13 ints, the stream: the order of fused_dsc_launch's
# parameters in csrc/fused_dsc.cu.
_ARGTYPES = [_vp] * 11 + [_int] * 13 + [_vp]


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_dsc").lib
    if lib.fused_dsc_launch.argtypes is None:
        lib.fused_dsc_launch.argtypes = _ARGTYPES
        lib.fused_dsc_launch.restype = _int
        lib.fused_dsc_error_string.argtypes = [_int]
        lib.fused_dsc_error_string.restype = ctypes.c_char_p
    return lib


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
                 device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what every launcher checks before it passes a pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_dsc_cuda(x_q, w_exp, w_dw9, w_proj, b_exp, b_dw, b_proj,
                   m_exp, m_dw, m_proj, *, stride: int,
                   zps: Tuple[int, int, int, int], q6: Tuple[int, int],
                   tile_rows: int = 4) -> torch.Tensor:
    """Launch the fused DSC kernel on CUDA tensors.

    Args:
      x_q: (B, H, W, C) int8. w_exp: (C, M), w_dw9: (9, M) tap-major,
        w_proj: (M, N), all int8. b_*: int32 biases (zero-point folded).
        m_*: float32 requant multipliers.
      zps: (zp_in, zp_f1, zp_f2, zp_out). q6: quantized ReLU6 caps (f1, f2).
      tile_rows: output rows per thread block (clamped to H2).
    Returns: (B, H2, W2, N) int8, on x_q's device and current stream.
    """
    global LAUNCHES
    if x_q.device.type != "cuda":
        raise ValueError(f"fused_dsc_cuda needs CUDA tensors, got {x_q.device}")
    if x_q.dim() != 4:
        raise ValueError(f"x_q must be (B, H, W, C), got {tuple(x_q.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    b, h, w, cin = x_q.shape
    cmid, cout = w_exp.shape[1], w_proj.shape[1]
    dev = x_q.device
    for t, name, dtype, shape in (
            (x_q, "x_q", torch.int8, (b, h, w, cin)),
            (w_exp, "w_exp", torch.int8, (cin, cmid)),
            (w_dw9, "w_dw9", torch.int8, (9, cmid)),
            (w_proj, "w_proj", torch.int8, (cmid, cout)),
            (b_exp, "b_exp", torch.int32, (cmid,)),
            (b_dw, "b_dw", torch.int32, (cmid,)),
            (b_proj, "b_proj", torch.int32, (cout,)),
            (m_exp, "m_exp", torch.float32, (cmid,)),
            (m_dw, "m_dw", torch.float32, (cmid,)),
            (m_proj, "m_proj", torch.float32, (cout,))):
        check_tensor(t, name, dtype, shape, dev)
    h2, w2 = -(-h // stride), -(-w // stride)
    out = torch.empty((b, h2, w2, cout), dtype=torch.int8, device=dev)
    lib = _lib()
    _, zp_f1, zp_f2, zp_out = (int(z) for z in zps)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_dsc_launch(
            x_q.data_ptr(), w_exp.data_ptr(), w_dw9.data_ptr(),
            w_proj.data_ptr(), b_exp.data_ptr(), b_dw.data_ptr(),
            b_proj.data_ptr(), m_exp.data_ptr(), m_dw.data_ptr(),
            m_proj.data_ptr(), out.data_ptr(),
            b, h, w, cin, cmid, cout, stride, min(tile_rows, h2),
            zp_f1, zp_f2, zp_out, int(q6[0]), int(q6[1]), stream)
    if err != 0:
        msg = lib.fused_dsc_error_string(err).decode()
        raise RuntimeError(f"fused_dsc kernel launch failed: {msg} ({err})")
    LAUNCHES += 1
    return out
