"""Learning-rate schedules (pure functions of the step counter; port of
``repro.optim.schedule``)."""

from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup -> cosine decay to final_frac * peak, as an f32 scalar
    tensor on ``step``'s device (the CPU for a Python int)."""
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac + (1.0 - final_frac) * 0.5 * (
        1.0 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)
