"""INT8 quantization arithmetic (TFLite-style), on torch tensors.

Port of ``repro.core.quant``: 32-bit accumulate -> bias add -> requantize
(float32 effective scale, round half to even) -> ReLU6 -> 8-bit output.
Weights are symmetric per-channel int8 (zero point 0), activations are
asymmetric per-tensor int8. The fixed-point oracle and the zero-point fold
stay in numpy, as in the reference.

Integer GEMMs run as float32 matmuls (``int8_matmul``): torch has no int32
matmul on CUDA, and float32 sums of int8 products are exact integers while
``K * 2**14 < 2**24``, in any summation order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

INT8_MIN = -128
INT8_MAX = 127

# |int8 * int8| <= 2**14; a float32 sum of K such products is exact while
# every partial sum stays below 2**24.
_EXACT_F32_LIMIT = 1 << 24
_I8_PRODUCT_MAX = 1 << 14


@dataclasses.dataclass(frozen=True)
class QParams:
    """Quantization parameters for one tensor.

    ``scale`` is a python float for per-tensor quantization or a 1-D float32
    numpy array (per output channel) for weights; ``zero_point`` is always
    per-tensor.
    """

    scale: object  # float | np.ndarray
    zero_point: int = 0

    def scale_arr(self) -> np.ndarray:
        return np.asarray(self.scale, dtype=np.float32)


def choose_qparams(x, *, symmetric: bool = False,
                   channel_axis: Optional[int] = None) -> QParams:
    """Pick scale/zero-point covering the value range of ``x`` (numpy)."""
    x = np.asarray(x)
    if channel_axis is not None:
        axes = tuple(i for i in range(x.ndim) if i != channel_axis)
        amax = np.maximum(np.abs(x).max(axis=axes), 1e-8)
        return QParams(scale=(amax / 127.0).astype(np.float32), zero_point=0)
    lo, hi = float(x.min()), float(x.max())
    if symmetric:
        amax = max(abs(lo), abs(hi), 1e-8)
        return QParams(scale=amax / 127.0, zero_point=0)
    lo, hi = min(lo, 0.0), max(hi, 0.0)
    scale = max((hi - lo) / 255.0, 1e-8)
    zp = int(round(INT8_MIN - lo / scale))
    return QParams(scale=scale, zero_point=int(np.clip(zp, INT8_MIN, INT8_MAX)))


def _scale_tensor(qp: QParams, ndim: int, channel_axis: Optional[int],
                  device) -> torch.Tensor:
    # A tensor on the data's device, never a python scalar: CUDA divides by
    # a CPU scalar as a multiply by its reciprocal, which is not exact.
    scale = qp.scale_arr()
    if channel_axis is not None and scale.ndim == 1:
        shape = [1] * ndim
        shape[channel_axis] = -1
        scale = scale.reshape(shape)
    return torch.as_tensor(scale, device=device)


def quantize(x, qp: QParams, *,
             channel_axis: Optional[int] = None) -> torch.Tensor:
    """float -> int8. ``x`` is a tensor, or an array (quantized on the CPU)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))   # writable copy
    x = x.to(torch.float32)
    q = torch.round(x / _scale_tensor(qp, x.ndim, channel_axis, x.device))
    return torch.clamp(q + qp.zero_point, INT8_MIN, INT8_MAX).to(torch.int8)


def dequantize(q: torch.Tensor, qp: QParams, *,
               channel_axis: Optional[int] = None) -> torch.Tensor:
    scale = _scale_tensor(qp, q.ndim, channel_axis, q.device)
    return (q.to(torch.float32) - qp.zero_point) * scale


def effective_scale(s_in, s_w, s_out) -> np.ndarray:
    """The requantization multiplier  M = s_in * s_w / s_out  (per-channel)."""
    return (np.asarray(s_in, np.float64) * np.asarray(s_w, np.float64)
            / np.asarray(s_out, np.float64)).astype(np.float32)


def relu6_max_q(qp: QParams) -> int:
    """The quantized value of 6.0 in ``qp``'s domain (ReLU6 clamp), <= 127."""
    return int(min(INT8_MAX,
                   qp.zero_point + round(6.0 / float(np.asarray(qp.scale)))))


def requantize(acc_i32: torch.Tensor, eff_scale, zp_out: int, *,
               relu: bool = False,
               relu6_max_q: Optional[int] = None) -> torch.Tensor:
    """int32 accumulator -> int8 output (bias must already be added).

    ``eff_scale`` broadcasts over the trailing (channel) dimension; ``relu``
    clamps at the output zero point, ``relu6_max_q`` caps at quantized 6.0.
    """
    m = torch.as_tensor(eff_scale, dtype=torch.float32, device=acc_i32.device)
    y = torch.round(acc_i32.to(torch.float32) * m).to(torch.int32) + zp_out
    lo = zp_out if relu else INT8_MIN
    hi = INT8_MAX if relu6_max_q is None else min(relu6_max_q, INT8_MAX)
    return torch.clamp(y, lo, hi).to(torch.int8)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8-valued ``a`` (..., K) and ``b`` (K, N).

    Runs one float32 matmul and returns int32. Raises where float32 would not
    be exact: ``K * 2**14 >= 2**24``, or TF32 matmuls enabled.
    """
    k = a.shape[-1]
    if k * _I8_PRODUCT_MAX >= _EXACT_F32_LIMIT:
        raise ValueError(f"int8_matmul: K={k} makes float32 sums inexact "
                         f"(needs K * 2**14 < 2**24, i.e. K < 1024)")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("int8_matmul: torch.backends.cuda.matmul.allow_tf32"
                           " is True; TF32 rounds the operands and the "
                           "integer product is no longer exact")
    out = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return out.to(torch.int32)


# ---------------------------------------------------------------------------
# Fixed-point oracle (the paper's silicon implementation), exact in numpy.
# ---------------------------------------------------------------------------

def quantize_multiplier(real: float) -> Tuple[int, int]:
    """real ~ qm * 2**(shift - 31)  with qm an int32 in [2^30, 2^31)."""
    if real == 0.0:
        return 0, 0
    mant, exp = math.frexp(real)  # real = mant * 2**exp, mant in [0.5, 1)
    qm = int(round(mant * (1 << 31)))
    if qm == (1 << 31):
        qm //= 2
        exp += 1
    return qm, exp


def requantize_fixedpoint_np(acc: np.ndarray, qm, shift, zp_out: int,
                             *, relu: bool = False) -> np.ndarray:
    """Exact gemmlowp-style rounding-doubling-high-mul + rounding right shift.

    Matches TFLite's MultiplyByQuantizedMultiplier. ``qm``/``shift`` may be
    scalars or per-channel arrays broadcast over the trailing dim.
    """
    acc = acc.astype(np.int64)
    qm = np.asarray(qm, np.int64)
    shift = np.asarray(shift, np.int64)
    prod = acc * qm
    nudge = np.where(prod >= 0, 1 << 30, 1 - (1 << 30)).astype(np.int64)
    srdhm = (prod + nudge) >> 31
    total_shift = -shift  # right shift amount when shift <= 0
    mask = total_shift > 0
    rounded = np.where(
        mask,
        (srdhm + np.where(mask, (1 << np.maximum(total_shift, 1)) >> 1, 0))
        >> np.maximum(total_shift, 0),
        srdhm << np.maximum(-total_shift, 0),
    )
    y = rounded + zp_out
    lo = zp_out if relu else INT8_MIN
    return np.clip(y, lo, INT8_MAX).astype(np.int8)


def fold_zero_point_correction(w_q: np.ndarray, zp_in: int,
                               reduce_axes: Tuple[int, ...]) -> np.ndarray:
    """Precomputed   - zp_in * sum_k(w_q)   term folded into the bias.

    acc = sum_k (x_q - zp_in) * w_q = sum_k x_q * w_q - zp_in * sum_k w_q,
    so the MACs stream raw int8 x_q and this correction is added once.
    """
    w_q = np.asarray(w_q)
    return (-int(zp_in) * w_q.astype(np.int64).sum(axis=reduce_axes)).astype(np.int32)
