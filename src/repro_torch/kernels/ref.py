"""Plain PyTorch versions of the hand-written kernels.

Each function is the semantic ground truth its kernel is held against: the
CPU tests compare it with the JAX package, and ``chip_smoke.py`` compares
the CUDA kernel with it on the card. It runs on any device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import quant


def fused_dsc_ref(x_q, w_exp, w_dw9, w_proj, b_exp, b_dw, b_proj,
                  m_exp, m_dw, m_proj, *, stride, zps, q6) -> torch.Tensor:
    """int8 (B, H, W, C) -> int8 (B, H2, W2, N), layer by layer, explicit
    padding of F1 with ``zp_f1``. ``w_dw9`` is (9, M), tap-major."""
    _, zp_f1, zp_f2, zp_out = zps
    q6_f1, q6_f2 = q6
    if x_q.dim() != 4:
        raise ValueError(f"x_q must be (B, H, W, C), got {tuple(x_q.shape)}")
    _, h, w, _ = x_q.shape
    s = stride
    h2, w2 = -(-h // s), -(-w // s)

    acc = quant.int8_matmul(x_q, w_exp) + b_exp
    f1 = quant.requantize(acc, m_exp, zp_f1, relu=True, relu6_max_q=q6_f1)
    f1p = F.pad(f1, (0, 0, 1, 1, 1, 1), value=zp_f1)
    w9 = w_dw9.to(torch.int32)
    acc2 = None
    for dy in range(3):
        for dx in range(3):
            win = f1p[:, dy:dy + (h2 - 1) * s + 1:s,
                      dx:dx + (w2 - 1) * s + 1:s, :]
            tap = win.to(torch.int32) * w9[dy * 3 + dx]
            acc2 = tap if acc2 is None else acc2 + tap
    f2 = quant.requantize(acc2 + b_dw, m_dw, zp_f2, relu=True,
                          relu6_max_q=q6_f2)
    acc3 = quant.int8_matmul(f2, w_proj) + b_proj
    return quant.requantize(acc3, m_proj, zp_out)
