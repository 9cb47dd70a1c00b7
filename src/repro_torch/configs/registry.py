"""Registry of the LM architectures the port runs.

Only ported architectures are listed. The reference's other archs raise on
``get``/``get_smoke`` and name the ROADMAP item that ports them.
"""

from __future__ import annotations

import importlib
from typing import Tuple

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
}

ARCH_NAMES: Tuple[str, ...] = tuple(_MODULES)

# The reference's archs that the port does not run yet.
NOT_PORTED: Tuple[str, ...] = (
    "recurrentgemma-9b", "internvl2-1b", "qwen2-72b", "qwen3-14b",
    "glm4-9b", "llama4-scout-17b-a16e", "qwen2-moe-a2.7b", "hubert-xlarge",
    "rwkv6-3b")


def _module(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ROADMAP.md Queue 1, item 5: "
            "the LM path after gemma2-9b)")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {ARCH_NAMES}")
    return importlib.import_module(_MODULES[name])


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE
