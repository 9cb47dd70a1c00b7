"""MobileNetV2-class int8 network built from the paper's DSC blocks (torch).

Port of ``repro.models.mobilenetv2``: a 3x3 s2 int8 stem, the seven paper
blocks at the paper's feature-map sizes, a 1x1 head, global average pooling
and a 2-class FC, all in TFLite int8 arithmetic. The blocks run under the
v0 or v3 discipline, or through the fused DSC kernel (``use_kernel``); all
give bit-identical int8 outputs.

The int8 GEMMs outside the kernel (stem as im2col, head, FC) are exact
float32 matmuls (``quant.int8_matmul``, K = 27, 56 and 128). The stem is not
an ``F.conv2d``: cuDNN convolutions default to TF32.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import dsc as dsc_mod
from repro_torch.core import quant
from repro_torch.core.dsc import DSCBlockSpec, QuantizedDSCParams
from repro_torch.core.fusion import Schedule, run_block
from repro_torch.kernels import ops as kops
from repro_torch.runtime import trace

# (name, cin, cmid, cout, stride) at the paper's feature-map sizes;
# input feature map is 40x40x8 (stem output).
PAPER_BLOCKS: Tuple[Tuple[str, int, int, int, int], ...] = (
    ("3rd", 8, 48, 8, 1),        # 40x40 -> 40x40   (paper Fig. 14 layer 3)
    ("b2", 8, 48, 16, 2),        # 40x40 -> 20x20
    ("5th", 16, 96, 16, 1),      # 20x20 -> 20x20   (paper layer 5)
    ("b4", 16, 96, 24, 2),       # 20x20 -> 10x10
    ("8th", 24, 144, 24, 1),     # 10x10 -> 10x10   (paper layer 8)
    ("b6", 24, 144, 56, 2),      # 10x10 -> 5x5
    ("15th", 56, 336, 56, 1),    # 5x5  -> 5x5      (paper layer 15)
)


@dataclasses.dataclass
class MobileNetV2Params:
    """Quantized network: stem + DSC blocks + head + classifier."""

    stem_w: torch.Tensor         # (3, 3, 3, C0) int8
    stem_b: torch.Tensor         # int32 (zp-folded)
    stem_m: torch.Tensor         # f32 per-channel requant
    qp_img: quant.QParams
    qp_stem: quant.QParams
    blocks: List[QuantizedDSCParams]
    head_w: torch.Tensor         # (C_last, C_head) int8
    head_b: torch.Tensor
    head_m: torch.Tensor
    qp_head: quant.QParams
    fc_w: torch.Tensor           # (C_head, n_classes) int8
    fc_b: torch.Tensor
    fc_m: torch.Tensor
    qp_logits: quant.QParams

    @property
    def device(self) -> torch.device:
        return self.stem_w.device

    def to(self, device) -> "MobileNetV2Params":
        """A copy with every tensor on ``device``."""
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(
            self, blocks=[b.to(device) for b in self.blocks], **moved)


def block_specs() -> List[Tuple[str, DSCBlockSpec]]:
    return [(name, DSCBlockSpec(cin=ci, cmid=cm, cout=co, stride=s))
            for name, ci, cm, co, s in PAPER_BLOCKS]


def _im2col3x3(x: torch.Tensor, stride: int) -> torch.Tensor:
    """(..., Hp, Wp, C) already padded -> (..., Ho, Wo, 9*C), taps ordered
    (dy, dx, c) to match an HWIO weight reshaped to (9*C, O)."""
    ho = (x.shape[-3] - 3) // stride + 1
    wo = (x.shape[-2] - 3) // stride + 1
    return torch.cat([x[..., dy:dy + (ho - 1) * stride + 1:stride,
                        dx:dx + (wo - 1) * stride + 1:stride, :]
                      for dy in range(3) for dx in range(3)], dim=-1)


def _conv2d_f32(x: np.ndarray, w: np.ndarray, stride: int = 1) -> np.ndarray:
    """SAME 3x3 conv, float (calibration only, on the CPU). x: (H, W, Cin)."""
    pads = []
    for n in x.shape[:2]:
        total = max((-(-n // stride) - 1) * stride + 3 - n, 0)
        pads += [total // 2, total - total // 2]   # XLA/TF SAME convention
    xp = F.pad(torch.from_numpy(x), (0, 0, pads[2], pads[3], pads[0], pads[1]))
    cols = _im2col3x3(xp, stride)
    return (cols @ torch.from_numpy(w).reshape(-1, w.shape[-1])).numpy()


def init_and_quantize(seed: int = 0, *, img_hw: int = 80, head_ch: int = 128,
                      n_classes: int = 2, device="cuda") -> MobileNetV2Params:
    """Random float network -> post-training int8 quantization (TFLite
    workflow), calibrated on one random image, all from a numpy seed.

    Calibration runs in float on the CPU; the result lies on ``device``.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((img_hw, img_hw, 3)).astype(np.float32)

    # --- stem: 3x3 s2 standard conv ----------------------------------------
    c0 = PAPER_BLOCKS[0][1]
    stem_w = rng.standard_normal((3, 3, 3, c0)).astype(np.float32) * 0.3
    stem_b = np.zeros(c0, np.float32)
    x = np.clip(_conv2d_f32(img, stem_w, stride=2) + stem_b, 0, 6)
    qp_img = quant.choose_qparams(img)
    qp_stem = quant.choose_qparams(x)
    qpw = quant.choose_qparams(stem_w, channel_axis=3)
    stem_wq = quant.quantize(stem_w, qpw, channel_axis=3)
    stem_bq = (np.round(stem_b / (np.float32(qp_img.scale) * qpw.scale_arr()))
               .astype(np.int64)
               + quant.fold_zero_point_correction(stem_wq.numpy(),
                                                  qp_img.zero_point,
                                                  (0, 1, 2)))
    stem_m = quant.effective_scale(qp_img.scale, qpw.scale, qp_stem.scale)

    # --- DSC blocks ----------------------------------------------------------
    blocks: List[QuantizedDSCParams] = []
    for _, spec in block_specs():
        p32 = dsc_mod.init_dsc_block_f32(rng, spec)
        blocks.append(dsc_mod.quantize_dsc_block(p32, spec, x))
        x = dsc_mod.dsc_block_f32(torch.from_numpy(x), p32, spec).numpy()

    # --- head 1x1 + GAP + fc -------------------------------------------------
    c_last = PAPER_BLOCKS[-1][3]
    head_w = rng.standard_normal((c_last, head_ch)).astype(np.float32) * 0.1
    h = np.clip(np.einsum("hwc,cm->hwm", x, head_w), 0, 6)
    qp_in_head = blocks[-1].qp_out
    qp_head = quant.choose_qparams(h)
    qpw_h = quant.choose_qparams(head_w, channel_axis=1)
    head_wq = quant.quantize(head_w, qpw_h, channel_axis=1)
    head_bq = quant.fold_zero_point_correction(head_wq.numpy(),
                                               qp_in_head.zero_point, (0,))
    head_m = quant.effective_scale(qp_in_head.scale, qpw_h.scale,
                                   qp_head.scale)
    g = h.mean(axis=(0, 1))
    fc_w = rng.standard_normal((head_ch, n_classes)).astype(np.float32) * 0.1
    qp_logits = quant.choose_qparams(g @ fc_w)
    qpw_fc = quant.choose_qparams(fc_w, channel_axis=1)
    fc_wq = quant.quantize(fc_w, qpw_fc, channel_axis=1)
    fc_bq = quant.fold_zero_point_correction(fc_wq.numpy(),
                                             qp_head.zero_point, (0,))
    fc_m = quant.effective_scale(qp_head.scale, qpw_fc.scale, qp_logits.scale)

    i32 = lambda a: torch.from_numpy(np.asarray(a).astype(np.int32))
    return MobileNetV2Params(
        stem_w=stem_wq, stem_b=i32(stem_bq), stem_m=torch.from_numpy(stem_m),
        qp_img=qp_img, qp_stem=qp_stem, blocks=blocks,
        head_w=head_wq, head_b=i32(head_bq), head_m=torch.from_numpy(head_m),
        qp_head=qp_head,
        fc_w=fc_wq, fc_b=i32(fc_bq), fc_m=torch.from_numpy(fc_m),
        qp_logits=qp_logits).to(dev)


# ---------------------------------------------------------------------------
# Carrying parameters across from numpy
# ---------------------------------------------------------------------------


def _has(obj, name: str) -> bool:
    return name in obj if isinstance(obj, Mapping) else hasattr(obj, name)


def _get(obj, name: str):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _qparams_from(q) -> quant.QParams:
    scale = np.asarray(_get(q, "scale"))
    return quant.QParams(
        scale=float(scale) if scale.ndim == 0 else scale.astype(np.float32),
        zero_point=int(_get(q, "zero_point")))


def _block_from(t, device) -> QuantizedDSCParams:
    s = _get(t, "spec")
    spec = DSCBlockSpec(cin=int(_get(s, "cin")), cmid=int(_get(s, "cmid")),
                        cout=int(_get(s, "cout")),
                        stride=int(_get(s, "stride")),
                        kernel=int(_get(s, "kernel")))
    arr = lambda name, dtype: torch.tensor(np.asarray(_get(t, name)),
                                           dtype=dtype, device=device)
    return QuantizedDSCParams(
        spec=spec,
        w_exp=arr("w_exp", torch.int8), w_dw=arr("w_dw", torch.int8),
        w_proj=arr("w_proj", torch.int8),
        b_exp=arr("b_exp", torch.int32), b_dw=arr("b_dw", torch.int32),
        b_proj=arr("b_proj", torch.int32),
        qp_in=_qparams_from(_get(t, "qp_in")),
        qp_f1=_qparams_from(_get(t, "qp_f1")),
        qp_f2=_qparams_from(_get(t, "qp_f2")),
        qp_out=_qparams_from(_get(t, "qp_out")),
        m_exp=arr("m_exp", torch.float32), m_dw=arr("m_dw", torch.float32),
        m_proj=arr("m_proj", torch.float32),
        q6_f1=int(_get(t, "q6_f1")), q6_f2=int(_get(t, "q6_f2")))


def params_from_numpy(tree, device="cuda"):
    """Carry parameters given as numpy arrays, ints and floats across.

    ``tree`` holds the fields of a network (``MobileNetV2Params``: it has
    ``blocks``) or of one block (``QuantizedDSCParams``), as attributes or
    mapping keys, with nested ``spec`` and ``QParams`` the same way. Returns
    the port's ``MobileNetV2Params`` or ``QuantizedDSCParams`` on ``device``.
    """
    dev = resolve_device(device)
    if not _has(tree, "blocks"):
        return _block_from(tree, dev)
    arr = lambda name, dtype: torch.tensor(np.asarray(_get(tree, name)),
                                           dtype=dtype, device=dev)
    return MobileNetV2Params(
        stem_w=arr("stem_w", torch.int8), stem_b=arr("stem_b", torch.int32),
        stem_m=arr("stem_m", torch.float32),
        qp_img=_qparams_from(_get(tree, "qp_img")),
        qp_stem=_qparams_from(_get(tree, "qp_stem")),
        blocks=[_block_from(b, dev) for b in _get(tree, "blocks")],
        head_w=arr("head_w", torch.int8), head_b=arr("head_b", torch.int32),
        head_m=arr("head_m", torch.float32),
        qp_head=_qparams_from(_get(tree, "qp_head")),
        fc_w=arr("fc_w", torch.int8), fc_b=arr("fc_b", torch.int32),
        fc_m=arr("fc_m", torch.float32),
        qp_logits=_qparams_from(_get(tree, "qp_logits")))


# ---------------------------------------------------------------------------
# int8 inference
# ---------------------------------------------------------------------------


def _stem_int8(img_q: torch.Tensor, p: MobileNetV2Params) -> torch.Tensor:
    """int8 3x3 s2 conv: zero-point padding (pad_top = pad_left = 1) +
    zp-folded bias on raw int8 taps + requant + ReLU6, as im2col + one
    exact float32 GEMM (K = 27)."""
    img_p = F.pad(img_q, (0, 0, 1, 1, 1, 1), value=p.qp_img.zero_point)
    cols = _im2col3x3(img_p, stride=2)
    acc = quant.int8_matmul(cols, p.stem_w.reshape(-1, p.stem_w.shape[-1]))
    return quant.requantize(acc + p.stem_b, p.stem_m, p.qp_stem.zero_point,
                            relu=True,
                            relu6_max_q=quant.relu6_max_q(p.qp_stem))


def _block_int8(x: torch.Tensor, qp: QuantizedDSCParams, schedule: Schedule,
                use_kernel: bool) -> torch.Tensor:
    if not use_kernel:
        return run_block(x, qp, schedule)
    y = kops.dsc_block(
        x, qp.w_exp, qp.w_dw.reshape(9, qp.spec.cmid), qp.w_proj, qp.b_exp,
        qp.b_dw, qp.b_proj, qp.m_exp, qp.m_dw, qp.m_proj,
        stride=qp.spec.stride, zps=qp.zps, q6=(qp.q6_f1, qp.q6_f2))
    if qp.spec.has_residual:
        y = dsc_mod.residual_add_q(y, x, qp)
    return y


def forward_stages(imgs, p: MobileNetV2Params,
                   schedule: Schedule = Schedule.V3_INTRA_STAGE,
                   use_kernel: bool = False) -> List[torch.Tensor]:
    """int8 outputs of every stage for a batch (B, H, W, 3) of float images:
    the stem, each of the seven blocks, then the int8 logits (B, classes).
    Spans (``runtime.trace``): ``mbv2.input``, ``mbv2.stem``, one
    ``mbv2.block`` a block (the block and its residual add), ``mbv2.head``
    (the 1x1 head, GAP and FC)."""
    with trace.span("mbv2.input"):
        imgs = torch.as_tensor(imgs, dtype=torch.float32, device=p.device)
        x = quant.quantize(imgs, p.qp_img)
    with trace.span("mbv2.stem"):
        x = _stem_int8(x, p)
    stages = [x]
    for i, qp in enumerate(p.blocks):
        with trace.span("mbv2.block") as rec:
            if rec is not None:
                rec.args.update(index=i, stride=qp.spec.stride,
                                residual=qp.spec.has_residual)
            x = _block_int8(x, qp, schedule, use_kernel)
        stages.append(x)
    with trace.span("mbv2.head"):
        # head 1x1 + ReLU6
        acc = quant.int8_matmul(x, p.head_w) + p.head_b
        h = quant.requantize(acc, p.head_m, p.qp_head.zero_point, relu=True,
                             relu6_max_q=quant.relu6_max_q(p.qp_head))
        # global average pool (int32 sum / hw in float32, rounded half to
        # even)
        hw = torch.tensor(h.shape[-3] * h.shape[-2], dtype=torch.float32,
                          device=h.device)
        g = torch.round(h.to(torch.int32).sum(dim=(-3, -2)).to(torch.float32)
                        / hw)
        g = torch.clamp(g, -128, 127).to(torch.int8)
        # fc
        acc = quant.int8_matmul(g, p.fc_w) + p.fc_b
        stages.append(quant.requantize(acc, p.fc_m, p.qp_logits.zero_point))
    return stages


def forward_batch(imgs, p: MobileNetV2Params,
                  schedule: Schedule = Schedule.V3_INTRA_STAGE,
                  use_kernel: bool = False,
                  return_quantized: bool = False) -> torch.Tensor:
    """Full int8 inference for a batch (B, H, W, 3) float32 -> logits.

    Runs on the parameters' device. ``use_kernel`` sends each block through
    ``ops.dsc_block`` (the CUDA kernel for CUDA tensors). ``return_quantized``
    returns the raw int8 logits instead of their dequantized floats. The
    whole call is the span ``mbv2.forward_batch``.
    """
    with trace.span("mbv2.forward_batch") as rec:
        if rec is not None:
            rec.args["batch"] = len(imgs)
        logits_q = forward_stages(imgs, p, schedule, use_kernel)[-1]
        if return_quantized:
            return logits_q
        return quant.dequantize(logits_q, p.qp_logits)


def forward_int8(img, p: MobileNetV2Params, **kw) -> torch.Tensor:
    """Full int8 inference for one image (H, W, 3) float32 -> logits."""
    img = torch.as_tensor(img, dtype=torch.float32, device=p.device)
    return forward_batch(img[None], p, **kw)[0]
