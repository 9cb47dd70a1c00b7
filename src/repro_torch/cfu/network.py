"""Full-network weight binding for the CFU: stem / head / FC records.

The golden executor binds weights through ``LD_WGT.block``, an index into a
host-side params sequence. DSC blocks use ``core.dsc.QuantizedDSCParams``
directly; the three non-DSC stages of a VWW network get the duck-typed
records below, which expose EXACTLY the attribute subset of
``QuantizedDSCParams`` that their instructions touch:

* ``CFUStemParams``  — CONV_MAC + REQUANT F1: conv weights on the CONV
  port, the stem requant constants under the F1-stage names (``m_exp`` /
  ``qp_f1`` / ``q6_f1``), and ``qp_in`` for the window gather's on-the-fly
  padding.
* ``CFUHeadParams``  — EXP_MAC VEC + REQUANT F1: a 1x1 conv IS the
  expansion engine's layer-by-layer mode, so the head weights ride the EXP
  port unmodified.
* ``CFUFCParams``    — PROJ_MAC + REQUANT OUT: the classifier rides the
  projection port; no ReLU, plain int8 clamp into the logits domain.

``vww_cfu_params`` packs a quantized ``models.mobilenetv2`` network into
the params list ``compile_vww_network`` expects (stem, blocks..., head,
FC) — the biases are already zero-point-folded by ``init_and_quantize``,
so the engines stream raw int8 exactly as for the DSC blocks.

``random_chain_params`` builds a coherently-chained quantized parameter
list for a bare DSC chain (block i+1 is calibrated on block i's float
output, so the activation domains line up the way a really-trained
network's would) — the weight set ``compile_network`` streams in chain
mode, shared by the CLI and the tests.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cfu.executor import host_array
from repro_torch.core import dsc, quant
from repro_torch.core.dsc import DSCBlockSpec, QuantizedDSCParams
from repro_torch.core.quant import QParams


@dataclasses.dataclass
class CFUStemParams:
    """3x3 stride-2 standard conv (CONV engine + F1-stage requant)."""

    w_conv: np.ndarray          # (3, 3, Cin, C0) int8
    b_conv: np.ndarray          # (C0,) int32, zero-point-folded
    m_exp: np.ndarray           # f32 per-channel requant multiplier
    qp_in: QParams              # image domain (window padding zero point)
    qp_f1: QParams              # stem output domain
    q6_f1: int                  # quantized ReLU6 clamp


@dataclasses.dataclass
class CFUHeadParams:
    """1x1 conv + ReLU6 (EXP engine in VEC mode + F1-stage requant)."""

    w_exp: np.ndarray           # (C_last, C_head) int8
    b_exp: np.ndarray           # (C_head,) int32, zero-point-folded
    m_exp: np.ndarray
    qp_in: QParams              # last block's output domain
    qp_f1: QParams              # head output domain
    q6_f1: int


@dataclasses.dataclass
class CFUFCParams:
    """Classifier (PROJ engine + OUT-stage requant, no activation)."""

    w_proj: np.ndarray          # (C_head, n_classes) int8
    b_proj: np.ndarray          # (n_classes,) int32, zero-point-folded
    m_proj: np.ndarray
    qp_out: QParams             # logits domain


def vww_cfu_params(p) -> List[object]:
    """MobileNetV2Params -> the CFU weight list (stem, blocks..., head, FC).

    Index convention matches ``compiler.compile_vww_network``: params[0] is
    the stem, params[1..N] the DSC blocks, params[N+1] the head, params[N+2]
    the FC. ``p`` is the port's network on the CPU; the records hold numpy
    copies, the blocks stay the network's own.
    """
    stem = CFUStemParams(
        w_conv=host_array(p.stem_w, "stem_w", np.int8),
        b_conv=host_array(p.stem_b, "stem_b", np.int32),
        m_exp=host_array(p.stem_m, "stem_m", np.float32),
        qp_in=p.qp_img, qp_f1=p.qp_stem,
        q6_f1=quant.relu6_max_q(p.qp_stem))
    head = CFUHeadParams(
        w_exp=host_array(p.head_w, "head_w", np.int8),
        b_exp=host_array(p.head_b, "head_b", np.int32),
        m_exp=host_array(p.head_m, "head_m", np.float32),
        qp_in=p.blocks[-1].qp_out, qp_f1=p.qp_head,
        q6_f1=quant.relu6_max_q(p.qp_head))
    fc = CFUFCParams(
        w_proj=host_array(p.fc_w, "fc_w", np.int8),
        b_proj=host_array(p.fc_b, "fc_b", np.int32),
        m_proj=host_array(p.fc_m, "fc_m", np.float32),
        qp_out=p.qp_logits)
    return [stem] + list(p.blocks) + [head, fc]


def random_chain_params(key, specs: Sequence[Tuple[str, DSCBlockSpec]],
                        hw: int, seed: int = 0
                        ) -> List[QuantizedDSCParams]:
    """Random quantized weights for a bare DSC chain, calibrated in chain
    order: each block's activation ranges come from the previous block's
    float output, exactly the TinyML post-training-quantization workflow.

    ``key`` is the integer seed of the weights (one numpy generator drawn
    block after block) and ``seed`` that of the calibration input. The
    weights differ from the reference's, which draws them from its own
    generator.
    """
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((hw, hw, specs[0][1].cin)).astype(np.float32)
    wrng = np.random.default_rng(key)
    params = []
    for _, spec in specs:
        p32 = dsc.init_dsc_block_f32(wrng, spec)
        qp = dsc.quantize_dsc_block(p32, spec, x)
        params.append(qp)
        x = dsc.dsc_block_f32(torch.from_numpy(x), p32, spec).numpy()
    return params
