"""int8 gradient compression with error feedback (port of
``repro.optim.compression``).

The reference quantizes the gradient tensor that its pod-axis all-reduce
would carry (per-tensor absmax scale, int8 on the wire, 4x fewer bytes than
f32) and carries the quantization error to the next step (Karimireddy et
al., 2019). On one device there is no reduce; the transform is the same
arithmetic, so a run with it converges as the reference's does.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree

Tree = Any


def compress_state_init(params: Tree) -> Tree:
    """Error-feedback residuals, one f32 tensor per parameter."""
    return tree.map_leaves(
        lambda p: torch.zeros_like(p, dtype=torch.float32,
                                   requires_grad=False), params)


def _q_dq(x: torch.Tensor) -> torch.Tensor:
    """Quantize to int8 (per-tensor absmax) and back: the wire format."""
    amax = torch.clamp(torch.max(torch.abs(x)), min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def compress_decompress(grads: Tree, residuals: Tree) -> Tuple[Tree, Tree]:
    """g_hat = QDQ(g + residual); new_residual = (g + residual) - g_hat."""
    out = []
    for g, r in zip(tree.leaves(grads), tree.leaves(residuals)):
        g32 = g.float() + r
        ghat = _q_dq(g32)
        out.append((ghat.to(g.dtype), g32 - ghat))
    return (tree.unflatten(grads, [o[0] for o in out]),
            tree.unflatten(grads, [o[1] for o in out]))
