"""The train step on one device (port of ``repro.runtime.steps``).

``build_train_step(cfg, train, shape, device)`` returns a function

    (state, batch) -> (state, metrics)

that moves the host batch to the device, takes the gradient of
``lm.loss_fn`` (accumulated in f32 over ``cfg.microbatch_for(shape.name)``
microbatches, the metrics averaged over them), then applies the optional
int8 gradient compression with error feedback, global-norm clipping, the
cosine warmup schedule and AdamW, in the reference's order. Parameters are
f32 masters that the model casts to ``cfg.dtype`` at every use, as in the
reference, so the state holds only f32 and int32 tensors.

The reference's step is a jitted function with explicit in/out shardings
over a mesh and donation of the state; on one device there is no mesh or
sharding, and the port updates the parameters and moments in place
(``optim.adamw_update``), which is what donation buys the reference. The
serving builders (``build_prefill_step`` etc.) are not ported:
``launch.serve`` drives ``lm.prefill`` and ``lm.decode_step`` directly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import resolve_device, tree
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import lm
from repro_torch.optim import (OptState, adamw_init, adamw_update,
                               clip_by_global_norm_, compress_decompress,
                               compress_state_init, cosine_warmup)

Tree = Any


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    clip_norm: float = 1.0
    grad_compression: bool = False   # int8 + error feedback


@dataclasses.dataclass
class TrainState:
    params: Tree
    opt: OptState
    step: torch.Tensor                    # int32, shape ()
    grad_residual: Optional[Tree] = None  # error feedback (compression)


def train_state(params: Tree, train: TrainSpec) -> TrainState:
    """A fresh state around ``params`` (f32 leaves, marked to require
    grad): zero moments, step 0, zero residuals under compression."""
    for p in tree.leaves(params):
        p.requires_grad_(True)
    return TrainState(
        params=params, opt=adamw_init(params),
        step=torch.zeros((), dtype=torch.int32,
                         device=tree.leaves(params)[0].device),
        grad_residual=(compress_state_init(params)
                       if train.grad_compression else None))


def init_train_state(cfg: ArchConfig, seed: int, train: TrainSpec,
                     device="cuda") -> TrainState:
    """Seeded f32 parameters (``lm.init_params``) on ``device`` and a fresh
    state."""
    return train_state(lm.init_params(cfg, seed, device, torch.float32),
                       train)


def abstract_train_state(cfg: ArchConfig, train: TrainSpec) -> TrainState:
    """The state's shapes and dtypes on the meta device: the template
    ``checkpoint.restore_checkpoint`` restores into."""
    return train_state(lm.abstract_params(cfg, torch.float32), train)


def build_train_step(cfg: ArchConfig, train: TrainSpec, shape: InputShape,
                     device="cuda") -> Callable:
    """Returns (state, batch) -> (state, metrics): ``batch`` a dict of host
    arrays of ``shape``'s global batch, ``metrics`` f32 scalar tensors
    (loss, nll, aux, grad_norm, lr) on the device. The state is updated in
    place and returned with its step advanced."""
    dev = resolve_device(device)
    n_micro = max(1, min(cfg.microbatch_for(shape.name), shape.global_batch))
    if shape.global_batch % n_micro:
        raise ValueError(f"batch {shape.global_batch} does not split into "
                         f"{n_micro} microbatches")
    size = shape.global_batch // n_micro

    def grads_of(params, batch):
        flat = tree.leaves(params)
        loss, met = lm.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return grads, {k: v.detach() for k, v in met.items()}

    def step_fn(state: TrainState, batch: Dict[str, Any]):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        params = state.params
        if n_micro == 1:
            flat, metrics = grads_of(params, batch)
        else:
            flat = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                    for p in tree.leaves(params)]
            mets = []
            for i in range(n_micro):
                part = {k: v[i * size:(i + 1) * size]
                        for k, v in batch.items()}
                g, met = grads_of(params, part)
                for acc, gi in zip(flat, g):
                    acc.add_(gi.float())
                del g
                mets.append(met)
            for acc in flat:
                acc.div_(n_micro)
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}

        # --- gradient compression (int8 + error feedback) -------------------
        residual = state.grad_residual
        if train.grad_compression:
            ghat, residual = compress_decompress(tree.unflatten(params, flat),
                                                 residual)
            flat = tree.leaves(ghat)
            del ghat

        # --- clip + AdamW ----------------------------------------------------
        # clipped leaf by leaf in the list: the step never holds a second
        # gradient-sized tree
        gnorm = clip_by_global_norm_(flat, train.clip_norm)
        lr = cosine_warmup(state.step, peak_lr=train.peak_lr,
                           warmup_steps=train.warmup_steps,
                           total_steps=train.total_steps)
        new_params, new_opt = adamw_update(
            tree.unflatten(params, flat), state.opt, params, lr=lr,
            b1=train.b1, b2=train.b2, weight_decay=train.weight_decay)
        new_state = TrainState(params=new_params, opt=new_opt,
                               step=state.step + 1, grad_residual=residual)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return new_state, metrics

    return step_fn
