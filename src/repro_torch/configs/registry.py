"""Registry of the LM architectures the port runs: all ten of the
reference's (``ARCH_NAMES``, the grid of ``cells()``), and those the port
runs beyond them (``PORT_ONLY``), which ``get`` and ``get_smoke`` resolve
alike.

``cells()`` enumerates the (arch x input-shape) grid with per-cell
applicability, as the reference's registry does:

* encoder-only archs (hubert) have no decode step -> decode shapes N/A;
* long_500k needs sub-quadratic attention -> N/A for full-attention archs.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import List, Optional, Tuple

from repro_torch.configs.base import ArchConfig, InputShape, LM_SHAPES

_MODULES = {
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a27b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
}

ARCH_NAMES: Tuple[str, ...] = tuple(_MODULES)

# architectures the reference has not: off the (arch x shape) grid
_PORT_ONLY = {
    "trinity-mini": "repro_torch.configs.trinity_mini",
}
PORT_ONLY: Tuple[str, ...] = tuple(_PORT_ONLY)

# archs whose every layer is O(T) or windowed => long_500k runnable
SUBQUADRATIC = ("recurrentgemma-9b", "rwkv6-3b")
# encoder-only => no decode step
ENCODER_ONLY = ("hubert-xlarge",)


def _module(name: str):
    path = _MODULES.get(name) or _PORT_ONLY.get(name)
    if path is None:
        raise KeyError(f"unknown arch {name!r}; one of "
                       f"{ARCH_NAMES + PORT_ONLY}")
    return importlib.import_module(path)


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: InputShape
    runnable: bool
    skip_reason: Optional[str] = None

    @property
    def key(self) -> str:
        return f"{self.arch}/{self.shape.name}"


def cell_for(arch: str, shape: InputShape) -> Cell:
    if shape.kind == "decode" and arch in ENCODER_ONLY:
        return Cell(arch, shape, False,
                    "encoder-only: no decode step exists")
    if shape.name == "long_500k" and arch not in SUBQUADRATIC:
        return Cell(arch, shape, False,
                    "full quadratic attention at 512k seq: skipped per brief"
                    " (needs sub-quadratic attention)")
    return Cell(arch, shape, True)


def cells() -> List[Cell]:
    return [cell_for(a, s) for a in ARCH_NAMES for s in LM_SHAPES]


def runnable_cells() -> List[Cell]:
    return [c for c in cells() if c.runnable]
