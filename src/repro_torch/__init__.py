"""PyTorch/CUDA port of the int8 DSC-accelerator reproduction.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``kernels/``, ``models/``, ``configs/``, ``launch/``) and names,
imports ``torch`` and numpy only, and runs its hot path through a CUDA
kernel written for Hopper (``kernels/csrc/fused_dsc.cu``).

Entry points take an explicit ``device`` and default to ``"cuda"``. With no
card present they raise unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on; never a silent CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
