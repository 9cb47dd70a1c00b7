"""Published peaks of the card, the yardstick of every roofline and MFU.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit.
"""

from __future__ import annotations

H100 = {
    "bf16_flops": 989e12,
    "int8_ops": 1979e12,
    "hbm_bytes": 3.35e12,
}


def for_device(name: str) -> dict:
    """The peak table of the card named ``name`` (as
    ``torch.cuda.get_device_name`` gives it)."""
    if "H100" in name:
        return H100
    raise ValueError(f"no table of peaks for the card {name!r}")
