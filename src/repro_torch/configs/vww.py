"""Visual Wake Words deployment config (the paper's CFU-Playground target).

The LLM-side configs in this package describe transformer stacks; this one
describes the TinyML deployment the CFU simulator executes: a
MobileNetV2-class VWW classifier (80x80x3 person/no-person, int8) plus the
PE-count design points the scaling bench sweeps.

``PE_SWEEP`` scales the paper's engine arrays (9 expansion window engines,
9 depthwise lanes, 56 projection engines) jointly from 1/3x to 4x — the
area/throughput knob of Bai et al. (arXiv:1809.01536). The paper point is
``PAPER_PE`` (scale 1).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.cfu.timing import PEConfig


@dataclasses.dataclass(frozen=True)
class VWWConfig:
    img_hw: int = 80          # input resolution (stem halves it)
    img_ch: int = 3
    head_ch: int = 128        # 1x1 head width
    n_classes: int = 2        # person / no-person
    batch: int = 4            # default multi-stream batch for simulation


VWW = VWWConfig()

PAPER_PE = PEConfig(exp_pes=9, dw_lanes=9, proj_engines=56)

PE_SWEEP: Tuple[PEConfig, ...] = (
    PEConfig(exp_pes=3, dw_lanes=3, proj_engines=14),     # 1/3x
    PEConfig(exp_pes=6, dw_lanes=6, proj_engines=28),     # 2/3x
    PAPER_PE,                                             # 1x (paper)
    PEConfig(exp_pes=18, dw_lanes=18, proj_engines=112),  # 2x
    PEConfig(exp_pes=36, dw_lanes=36, proj_engines=224),  # 4x
)
