"""Visual Wake Words deployment config (the paper's CFU-Playground target):
a MobileNetV2-class VWW classifier, 80x80x3 person/no-person, int8."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VWWConfig:
    img_hw: int = 80          # input resolution (stem halves it)
    img_ch: int = 3
    head_ch: int = 128        # 1x1 head width
    n_classes: int = 2        # person / no-person
    batch: int = 4            # default multi-stream batch for simulation


VWW = VWWConfig()
