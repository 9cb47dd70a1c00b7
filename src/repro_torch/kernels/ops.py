"""Public entry points for the kernels: one call per fused block.

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the kernel's plain PyTorch version. Model code calls
these wrappers, never the kernels directly.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import fused_dsc as _dsc
from repro_torch.kernels import ref


def dsc_block(x_q: torch.Tensor, w_exp, w_dw9, w_proj, b_exp, b_dw, b_proj,
              m_exp, m_dw, m_proj, *, stride: int, zps, q6,
              tile_rows: int = 4) -> torch.Tensor:
    """One fused Ex->Dw->Pr inverted-residual block (no residual add) on a
    (B, H, W, C) int8 batch."""
    args = (x_q, w_exp, w_dw9, w_proj, b_exp, b_dw, b_proj, m_exp, m_dw,
            m_proj)
    if x_q.device.type == "cuda":
        return _dsc.fused_dsc_cuda(*args, stride=stride, zps=zps, q6=q6,
                                   tile_rows=tile_rows)
    if x_q.device.type == "cpu":
        return ref.fused_dsc_ref(*args, stride=stride, zps=zps, q6=q6)
    raise ValueError(f"dsc_block: unsupported device {x_q.device}")
