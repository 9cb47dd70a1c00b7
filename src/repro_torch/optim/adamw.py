"""AdamW (decoupled weight decay) on nested dicts of tensors (port of
``repro.optim.adamw``).

The update reproduces the reference term for term: the moments, the bias
correction from the f32 step count, the step ``mhat / (sqrt(vhat) + eps) +
wd * p`` and the parameter update are computed in f32, and a parameter keeps
its dtype. Unlike the reference, whose arrays are immutable, ``adamw_update``
writes the new parameters and moments into the tensors it is given, so a
step holds no second copy of the optimizer state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch

from repro_torch import tree

Tree = Any


@dataclasses.dataclass
class OptState:
    m: Tree
    v: Tree
    count: torch.Tensor          # int32, shape ()


def adamw_init(params: Tree) -> OptState:
    first = tree.leaves(params)[0]
    zeros = lambda p: torch.zeros_like(p, requires_grad=False)
    return OptState(m=tree.map_leaves(zeros, params),
                    v=tree.map_leaves(zeros, params),
                    count=torch.zeros((), dtype=torch.int32,
                                      device=first.device))


def global_norm(grads: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.leaves(grads)))


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """(clipped grads, the norm before clipping); ``grads`` is left as is."""
    flat = tree.leaves(grads)
    gn = clip_by_global_norm_(flat, max_norm)
    return tree.unflatten(grads, flat), gn


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """``clip_by_global_norm`` on a list, each gradient replaced in it by
    its clipped one, so that a leaf's unclipped gradient is freed as soon
    as its clipped one exists. Returns the norm before clipping."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for i, g in enumerate(grads):
        grads[i] = (g.float() * scale).to(g.dtype)
    return gn


def adamw_update(grads: Tree, state: OptState, params: Tree, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Tree, OptState]:
    """Returns (params, state) after one step; ``params``, ``state.m`` and
    ``state.v`` are updated in place, the count is a new tensor. ``lr`` is
    a float or an f32 scalar tensor."""
    count = state.count + 1
    c = count.float()
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c
    with torch.no_grad():
        for p, g, m, v in zip(tree.leaves(params), tree.leaves(grads),
                              tree.leaves(state.m), tree.leaves(state.v)):
            g = g.float()
            m.mul_(b1).add_((1.0 - b1) * g)
            v.mul_(b2).add_((1.0 - b2) * torch.square(g))
            # mhat / (sqrt(vhat) + eps) + wd * p, then p - lr * step, with
            # the reference's operations in its order, in place where a
            # temporary the size of the leaf would otherwise stay alive
            denom = (v / bc2).sqrt_().add_(eps)
            step = (m / bc1).div_(denom)
            del denom
            step.add_(weight_decay * p.float()).mul_(lr)
            p.copy_((p.float() - step).to(p.dtype))
    return params, OptState(m=state.m, v=state.v, count=count)
