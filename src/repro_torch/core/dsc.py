"""The paper's core technique: fused dataflow for DSC blocks (torch port).

A MobileNetV2 inverted-residual block is the three-stage sandwich

    Expansion (1x1 conv, C -> M) -> Depthwise (3x3, per-channel, stride s)
                                 -> Projection (1x1 conv, M -> N) [-> +residual]

Port of ``repro.core.dsc`` with two execution disciplines:

* ``dsc_block_reference``     -- v0, layer by layer: F1 and F2 are
      materialized at full size and F1 is padded explicitly.
* ``dsc_block_fused_rowtile`` -- v3, the row-tile dataflow: per tile of
      output rows, the haloed F1 strip is computed once and consumed by the
      depthwise and projection. Here all tiles run at once as a tensor axis.

Both give bit-identical int8 outputs. Layout is HWC, with any number of
leading batch axes (NHWC for a batch). Weights:
    w_exp  : (C, M)      int8, per-output-channel scale
    w_dw   : (3, 3, M)   int8, per-channel scale
    w_proj : (M, N)      int8, per-output-channel scale
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core.quant import QParams

# ---------------------------------------------------------------------------
# Block specification & parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DSCBlockSpec:
    """Static shape/arity description of one inverted-residual block."""

    cin: int
    cmid: int          # = cin * expansion_factor
    cout: int
    stride: int = 1
    kernel: int = 3    # depthwise kernel (paper: 3x3)

    @property
    def has_residual(self) -> bool:
        return self.stride == 1 and self.cin == self.cout

    def out_hw(self, h: int, w: int) -> Tuple[int, int]:
        # SAME padding semantics (TFLite): ceil division by stride.
        return (-(-h // self.stride), -(-w // self.stride))

    def macs(self, h: int, w: int) -> Dict[str, int]:
        """Layer-by-layer MAC counts (the paper's Section II formulas)."""
        h2, w2 = self.out_hw(h, w)
        return {
            "expansion": h * w * self.cin * self.cmid,
            "depthwise": h2 * w2 * self.kernel * self.kernel * self.cmid,
            "projection": h2 * w2 * self.cmid * self.cout,
        }


@dataclasses.dataclass
class QuantizedDSCParams:
    """All tensors + quantization constants for one int8 block.

    Biases are int32 and include the zero-point correction (-zp_in * sum_k w)
    so the MAC loops stream raw int8 activations.
    """

    spec: DSCBlockSpec
    # int8 weights
    w_exp: torch.Tensor
    w_dw: torch.Tensor
    w_proj: torch.Tensor
    # int32 biases (zero-point-folded)
    b_exp: torch.Tensor
    b_dw: torch.Tensor
    b_proj: torch.Tensor
    # activation qparams (per-tensor)
    qp_in: QParams
    qp_f1: QParams
    qp_f2: QParams
    qp_out: QParams
    # requant multipliers (float32 effective scales, per-channel)
    m_exp: torch.Tensor
    m_dw: torch.Tensor
    m_proj: torch.Tensor
    # quantized ReLU6 clamp value in F1/F2 domains
    q6_f1: int = 127
    q6_f2: int = 127
    qp_res_out: Optional[QParams] = None

    def to(self, device) -> "QuantizedDSCParams":
        """A copy with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    @property
    def zps(self) -> Tuple[int, int, int, int]:
        return (self.qp_in.zero_point, self.qp_f1.zero_point,
                self.qp_f2.zero_point, self.qp_out.zero_point)


def init_dsc_block_f32(rng: np.random.Generator,
                       spec: DSCBlockSpec) -> Dict[str, torch.Tensor]:
    """He-initialized float32 weights for one block (calibration)."""
    def normal(shape, fan_in):
        w = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(w * np.float32(np.sqrt(2.0 / fan_in)))

    zeros = torch.zeros
    return {
        "w_exp": normal((spec.cin, spec.cmid), spec.cin),
        "b_exp": zeros(spec.cmid),
        "w_dw": normal((spec.kernel, spec.kernel, spec.cmid),
                       spec.kernel * spec.kernel),
        "b_dw": zeros(spec.cmid),
        "w_proj": normal((spec.cmid, spec.cout), spec.cmid),
        "b_proj": zeros(spec.cout),
    }


def _depthwise_taps(f1_pad: torch.Tensor, rows: int, cols: int, stride: int,
                    k: int = 3):
    """(dy, dx, window) for each tap of a stride-s kxk depthwise over the
    padded map's last three axes (rows, cols, channels)."""
    for dy in range(k):
        for dx in range(k):
            yield dy, dx, f1_pad[..., dy:dy + (rows - 1) * stride + 1:stride,
                                 dx:dx + (cols - 1) * stride + 1:stride, :]


def dsc_block_f32(x: torch.Tensor, p: Dict[str, torch.Tensor],
                  spec: DSCBlockSpec) -> torch.Tensor:
    """Float reference semantics (HWC). Used to calibrate the int8 path."""
    f1 = torch.clamp(x @ p["w_exp"] + p["b_exp"], 0.0, 6.0)  # ReLU6
    f1p = F.pad(f1, (0, 0, 1, 1, 1, 1))
    h2, w2 = spec.out_hw(x.shape[-3], x.shape[-2])
    acc = torch.zeros(x.shape[:-3] + (h2, w2, spec.cmid))
    for dy, dx, win in _depthwise_taps(f1p, h2, w2, spec.stride, spec.kernel):
        acc = acc + win * p["w_dw"][dy, dx]
    f2 = torch.clamp(acc + p["b_dw"], 0.0, 6.0)
    y = f2 @ p["w_proj"] + p["b_proj"]  # linear
    if spec.has_residual:
        y = y + x
    return y


def quantize_dsc_block(params_f32, spec: DSCBlockSpec,
                       calib_x) -> QuantizedDSCParams:
    """Post-training quantization of a float block, TFLite-style.

    ``calib_x`` is a float activation sample (H, W, C) that picks the
    activation ranges. Returns CPU tensors; ``.to(device)`` moves them.
    """
    p = {k: np.asarray(v) for k, v in params_f32.items()}
    # --- activation ranges from a float forward pass (numpy) ----------------
    x = np.asarray(calib_x, np.float32)
    f1 = np.clip(np.einsum("hwc,cm->hwm", x, p["w_exp"]) + p["b_exp"], 0, 6)
    f1p = np.pad(f1, ((1, 1), (1, 1), (0, 0)))
    s, k = spec.stride, spec.kernel
    h2, w2 = spec.out_hw(x.shape[0], x.shape[1])
    acc = np.zeros((h2, w2, spec.cmid), np.float32)
    for dy in range(k):
        for dx in range(k):
            acc += (f1p[dy:dy + (h2 - 1) * s + 1:s,
                        dx:dx + (w2 - 1) * s + 1:s] * p["w_dw"][dy, dx])
    f2 = np.clip(acc + p["b_dw"], 0, 6)
    y = np.einsum("hwm,mn->hwn", f2, p["w_proj"]) + p["b_proj"]

    qp_in = quant.choose_qparams(x)
    qp_f1 = quant.choose_qparams(f1)   # ReLU6 output: range ~[0, 6]
    qp_f2 = quant.choose_qparams(f2)
    qp_out = quant.choose_qparams(y)

    # --- weights: per-output-channel symmetric -----------------------------
    qp_wexp = quant.choose_qparams(p["w_exp"], channel_axis=1)
    qp_wdw = quant.choose_qparams(p["w_dw"], channel_axis=2)
    qp_wproj = quant.choose_qparams(p["w_proj"], channel_axis=1)
    w_exp_q = quant.quantize(p["w_exp"], qp_wexp, channel_axis=1)
    w_dw_q = quant.quantize(p["w_dw"], qp_wdw, channel_axis=2)
    w_proj_q = quant.quantize(p["w_proj"], qp_wproj, channel_axis=1)

    # --- int32 biases with zero-point folding ------------------------------
    def qbias(b, s_in, s_w):
        return np.round(b / (np.asarray(s_in) * np.asarray(s_w))).astype(np.int64)

    b_exp = (qbias(p["b_exp"], qp_in.scale, qp_wexp.scale)
             + quant.fold_zero_point_correction(w_exp_q.numpy(),
                                                qp_in.zero_point, (0,)))
    b_dw = (qbias(p["b_dw"], qp_f1.scale, qp_wdw.scale)
            + quant.fold_zero_point_correction(w_dw_q.numpy(),
                                               qp_f1.zero_point, (0, 1)))
    b_proj = (qbias(p["b_proj"], qp_f2.scale, qp_wproj.scale)
              + quant.fold_zero_point_correction(w_proj_q.numpy(),
                                                 qp_f2.zero_point, (0,)))

    m_exp = quant.effective_scale(qp_in.scale, qp_wexp.scale, qp_f1.scale)
    m_dw = quant.effective_scale(qp_f1.scale, qp_wdw.scale, qp_f2.scale)
    m_proj = quant.effective_scale(qp_f2.scale, qp_wproj.scale, qp_out.scale)

    i32 = lambda a: torch.from_numpy(np.asarray(a).astype(np.int32))
    return QuantizedDSCParams(
        spec=spec, w_exp=w_exp_q, w_dw=w_dw_q, w_proj=w_proj_q,
        b_exp=i32(b_exp), b_dw=i32(b_dw), b_proj=i32(b_proj),
        qp_in=qp_in, qp_f1=qp_f1, qp_f2=qp_f2, qp_out=qp_out,
        m_exp=torch.from_numpy(m_exp), m_dw=torch.from_numpy(m_dw),
        m_proj=torch.from_numpy(m_proj),
        q6_f1=quant.relu6_max_q(qp_f1), q6_f2=quant.relu6_max_q(qp_f2),
    )


# ---------------------------------------------------------------------------
# Shared int8 stage arithmetic (identical ops in every discipline).
# ---------------------------------------------------------------------------


def _expansion_acc(x_q: torch.Tensor, p: QuantizedDSCParams) -> torch.Tensor:
    """Raw int8 activations -> int32 accumulator (+folded bias)."""
    return quant.int8_matmul(x_q, p.w_exp) + p.b_exp


def _projection_acc(f2_q: torch.Tensor, p: QuantizedDSCParams) -> torch.Tensor:
    return quant.int8_matmul(f2_q, p.w_proj) + p.b_proj


def _f32_scalar(v, device) -> torch.Tensor:
    # A float32 tensor on the data's device: CUDA divides by a CPU scalar as
    # a multiply by its reciprocal, which would break bit-exactness.
    return torch.tensor(float(np.asarray(v)), dtype=torch.float32,
                        device=device)


def residual_add_q(y_q: torch.Tensor, x_q: torch.Tensor,
                   p: QuantizedDSCParams) -> torch.Tensor:
    """TFLite quantized ADD: rescale both operands into the output domain.

    Separate float32 ops, so no product is contracted into an FMA.
    """
    s_y = _f32_scalar(p.qp_out.scale, y_q.device)
    s_x = _f32_scalar(p.qp_in.scale, y_q.device)
    acc = (s_y * (y_q.to(torch.float32) - p.qp_out.zero_point)
           + s_x * (x_q.to(torch.float32) - p.qp_in.zero_point))
    out = torch.round(acc / s_y) + p.qp_out.zero_point
    return torch.clamp(out, quant.INT8_MIN, quant.INT8_MAX).to(torch.int8)


def _depthwise_requant(f1_pad: torch.Tensor, rows: int, cols: int,
                       p: QuantizedDSCParams) -> torch.Tensor:
    """Nine int32 tap products over a padded F1 -> requantized F2."""
    w_dw = p.w_dw.to(torch.int32)
    acc = None
    for dy, dx, win in _depthwise_taps(f1_pad, rows, cols, p.spec.stride,
                                       p.spec.kernel):
        tap = win.to(torch.int32) * w_dw[dy, dx]
        acc = tap if acc is None else acc + tap
    return quant.requantize(acc + p.b_dw, p.m_dw, p.qp_f2.zero_point,
                            relu=True, relu6_max_q=p.q6_f2)


# ---------------------------------------------------------------------------
# v0: layer-by-layer reference (explicit padding, full F1/F2 materialized)
# ---------------------------------------------------------------------------


def dsc_block_reference(x_q: torch.Tensor,
                        p: QuantizedDSCParams) -> torch.Tensor:
    """The paper's baseline: each stage completes over the whole feature map,
    with F1 padded by an explicit allocation (Fig. 13a)."""
    spec = p.spec
    f1_q = quant.requantize(_expansion_acc(x_q, p), p.m_exp,
                            p.qp_f1.zero_point, relu=True,
                            relu6_max_q=p.q6_f1)
    f1_pad = F.pad(f1_q, (0, 0, 1, 1, 1, 1), value=p.qp_f1.zero_point)
    h2, w2 = spec.out_hw(x_q.shape[-3], x_q.shape[-2])
    # zero-point folding makes padding-with-zp equivalent to the explicit
    # (f1 - zp) * w formulation: sum((f1-zp)w) = sum(f1*w) - zp*sum(w).
    f2_q = _depthwise_requant(f1_pad, h2, w2, p)
    y_q = quant.requantize(_projection_acc(f2_q, p), p.m_proj,
                           p.qp_out.zero_point, relu=False)
    if spec.has_residual:
        y_q = residual_add_q(y_q, x_q, p)
    return y_q


# ---------------------------------------------------------------------------
# v3: fused row-tile dataflow, every tile at once
# ---------------------------------------------------------------------------


def dsc_block_fused_rowtile(x_q: torch.Tensor, p: QuantizedDSCParams,
                            tile_rows: int = 4) -> torch.Tensor:
    """Zero-buffer fusion at row-tile granularity.

    For each tile of ``tile_rows`` output rows the expansion computes the
    ((tile_rows-1)*s + 3)-row haloed F1 strip; out-of-map halo positions are
    set to ``zp_f1`` after the expansion (on-the-fly padding, Fig. 13b). The
    tiles form one tensor axis instead of the reference's ``lax.scan``.
    """
    spec = p.spec
    h, w = x_q.shape[-3], x_q.shape[-2]
    h2, w2 = spec.out_hw(h, w)
    s, k = spec.stride, spec.kernel
    n_tiles = -(-h2 // tile_rows)
    in_rows = (tile_rows - 1) * s + k
    dev = x_q.device
    rows = (torch.arange(n_tiles, device=dev)[:, None] * (tile_rows * s) - 1
            + torch.arange(in_rows, device=dev)[None, :])      # (T, R)
    cols = torch.arange(-1, w + 1, device=dev)                  # (W+2,)
    valid = (((rows >= 0) & (rows < h))[:, :, None]
             & ((cols >= 0) & (cols < w))[None, None, :])       # (T, R, W+2)
    strip = x_q[..., rows.clamp(0, h - 1)[:, :, None],
                cols.clamp(0, w - 1)[None, None, :], :]         # (..,T,R,W+2,C)
    f1 = quant.requantize(_expansion_acc(strip, p), p.m_exp,
                          p.qp_f1.zero_point, relu=True, relu6_max_q=p.q6_f1)
    f1 = f1.masked_fill(~valid[..., None], p.qp_f1.zero_point)
    f2 = _depthwise_requant(f1, tile_rows, w2, p)               # (..,T,t,W2,M)
    y = quant.requantize(_projection_acc(f2, p), p.m_proj,
                         p.qp_out.zero_point, relu=False)
    y_q = y.reshape(y.shape[:-4] + (n_tiles * tile_rows, w2, spec.cout))
    y_q = y_q[..., :h2, :, :]
    if spec.has_residual:
        y_q = residual_add_q(y_q, x_q, p)
    return y_q
