"""Launcher for the hand-written flash-attention kernel
(``csrc/flash_attention.cu``).

Port of ``repro.kernels.flash_attention.flash_attention``: online-softmax
attention with causal, sliding-window and logit-softcap masking, the score
matrix never in device memory. The kernel takes the model's (B, T, H, d)
layout and reads KV head ``h // (H // Hkv)`` for query head ``h``, so GQA
needs no repeated K and V. The plain PyTorch versions are
``ref.attention_ref`` and ``ref.mha_ref``.

``LAUNCHES`` counts the kernel launches this wrapper made, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_dsc import check_tensor

LAUNCHES = 0

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# 4 pointers, 10 ints, 2 floats, the stream: the order of
# flash_attention_launch's parameters in csrc/flash_attention.cu.
_ARGTYPES = [_vp] * 4 + [_int] * 10 + [_float] * 2 + [_vp]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention").lib
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = _ARGTYPES
        lib.flash_attention_launch.restype = _int
        lib.flash_attention_error_string.argtypes = [_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Launch the flash-attention kernel on CUDA tensors.

    Args:
      q: (B, Tq, H, d); k, v: (B, Tk, Hkv, d), H a multiple of Hkv; all
        contiguous, float32 or bfloat16, d a multiple of 16 and <= 256.
      causal: query i sees keys j <= i. window: keys with i - j < window
        (None: all). softcap: s -> softcap * tanh(s / softcap).
      sm_scale: score scale after the dot (default d ** -0.5).
    Returns: (B, Tq, H, d) in q's dtype, on q's device and current stream.
    """
    global LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q, k, v must be (B, T, H, d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got {q.dtype}")
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if hkv < 1 or h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} KV heads")
    if d % 16 or d > 256:
        raise ValueError(f"head dim must be a multiple of 16 and <= 256, got {d}")
    if tq < 1 or tk < 1:
        raise ValueError(f"empty sequence: Tq {tq}, Tk {tk}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")
    dev = q.device
    check_tensor(q, "q", q.dtype, (b, tq, h, d), dev)
    check_tensor(k, "k", q.dtype, (b, tk, hkv, d), dev)
    check_tensor(v, "v", q.dtype, (b, tk, hkv, d), dev)
    scale = float(sm_scale if sm_scale is not None else d ** -0.5)
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, h, hkv, tq, tk, d, int(causal),
            -1 if window is None else int(window), int(softcap is not None),
            float(softcap or 0.0), scale, stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} ({err})")
    LAUNCHES += 1
    return out
