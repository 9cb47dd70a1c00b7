"""Step builders: the train step, and the serving steps on a mesh (port of
``repro.runtime.steps``).

``build_train_step(cfg, train, shape, device, mesh=None)`` returns a
function

    (state, batch) -> (state, metrics)

that moves the host batch to the device, takes the gradient of
``lm.loss_fn`` (accumulated in f32 over ``cfg.microbatch_for(shape.name)``
microbatches, the metrics averaged over them), then applies the optional
int8 gradient compression with error feedback, global-norm clipping, the
cosine warmup schedule and AdamW, in the reference's order. Parameters are
f32 masters that the model casts to ``cfg.dtype`` at every use, as in the
reference, so the state holds only f32 and int32 tensors. The state is
updated in place (``optim.adamw_update``), which is what donation buys the
reference.

With a ``mesh`` (a ``DeviceMesh`` over ("pod",) "data", "model") the state
is DTensors placed by ``train_state_shardings`` (``shard_train_state``),
the batch is sharded on its leading dim (``sharding.batch_specs``), the
model runs inside ``activation_mesh``, and each rank splits its own rows
into the microbatches, so every microbatch stays batch-sharded (the
reference pins the same). Without one, the one-device step.

``build_prefill_step``, ``build_encode_step`` and ``build_decode_step``
are the serving steps of a cell on a mesh: params placed by
``shard_params``, the batch and cache by the sharding rules, the model in
``activation_mesh``; the cache of a decode step is updated in place (the
reference donates it). ``abstract_batch`` and ``decode_inputs`` give a
cell's inputs as meta tensors (shapes and dtypes, the reference's
``ShapeDtypeStruct``s).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from torch.distributed.tensor import DTensor

from repro_torch import resolve_device, tree
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import lm
from repro_torch.optim import (OptState, adamw_init, adamw_update,
                               clip_by_global_norm_, compress_decompress,
                               compress_state_init, cosine_warmup)
from repro_torch.roofline import op_cost
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.actctx import activation_mesh

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


def train_state_shardings(cfg: ArchConfig, mesh, train: TrainSpec,
                          abstract: Optional[TrainState] = None
                          ) -> TrainState:
    """The state's spec tree: params, moments and residuals by
    ``sharding.param_specs``, the counters replicated."""
    shd.check_meshable(cfg)
    abstract = abstract or abstract_train_state(cfg, train)
    pspecs = shd.param_specs(abstract.params, mesh)
    return TrainState(
        params=pspecs, opt=OptState(m=pspecs, v=pspecs, count=()),
        step=(), grad_residual=pspecs if train.grad_compression else None)


def shard_train_state(state: TrainState, mesh, cfg: ArchConfig,
                      train: TrainSpec) -> TrainState:
    """``state`` (the same full tensors on every rank) as DTensors placed by
    ``train_state_shardings``; each rank keeps its shard."""
    specs = train_state_shardings(cfg, mesh, train)
    params = shd.distribute(state.params, specs.params, mesh)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    return TrainState(
        params=params,
        opt=OptState(m=shd.distribute(state.opt.m, specs.opt.m, mesh),
                     v=shd.distribute(state.opt.v, specs.opt.v, mesh),
                     count=state.opt.count),
        step=state.step,
        grad_residual=(shd.distribute(state.grad_residual,
                                      specs.grad_residual, mesh)
                       if state.grad_residual is not None else None))


def init_sharded_train_state(cfg: ArchConfig, seed: int, train: TrainSpec,
                             mesh) -> TrainState:
    """``shard_train_state(init_train_state(...))`` without the whole state
    on any rank: each rank draws the parameters one layer (or one top-level
    leaf) at a time on the mesh's device, keeps only its shard of each
    (``lm.init_params(local=)``), and makes the moments as shards. The same
    numbers as ``init_train_state`` on that device."""
    specs = train_state_shardings(cfg, mesh, train)
    abstract = lm.abstract_params(cfg, torch.float32)

    def local(path, leaf):
        spec = shd.spec_at(specs.params, path)
        if path.startswith(f"units{tree.SEP}"):   # a unit, before stacking
            spec = spec[1:]
        return shd.local_part(leaf, spec, mesh).clone()

    parts = lm.init_params(cfg, seed, mesh.device_type, torch.float32,
                           local=local)
    params = tree.unflatten(parts, [
        shd.from_local(part, shd.spec_at(specs.params, path), mesh,
                       shd.spec_at(abstract, path).shape)
        for path, part in tree.flatten_with_path(parts)])
    return train_state(params, train)


def micro_count(cfg: ArchConfig, shape: InputShape, mesh=None) -> int:
    """Microbatches per step: the config's, at most one row per batch shard
    (each microbatch must stay sharded over every batch axis)."""
    rows = shape.global_batch
    if mesh is not None:
        rows //= shd.mesh_axis_size(mesh, shd.data_axes(mesh))
    return max(1, min(cfg.microbatch_for(shape.name), max(rows, 1)))


def build_train_step(cfg: ArchConfig, train: TrainSpec, shape: InputShape,
                     device="cuda", mesh=None, *,
                     count_one_micro: bool = False) -> Callable:
    """Returns (state, batch) -> (state, metrics): ``batch`` a dict of host
    arrays of ``shape``'s global batch (every rank the same, on a mesh),
    ``metrics`` f32 scalar tensors (loss, nll, aux, grad_norm, lr) on the
    device. The state is updated in place and returned with its step
    advanced. ``count_one_micro`` (the dry run): run the first microbatch
    only and have ``op_cost`` count it once per microbatch, the gradient
    that of the first."""
    dev = resolve_device(device) if mesh is None else None
    n_micro = micro_count(cfg, shape, mesh)
    if shape.global_batch % n_micro:
        raise ValueError(f"batch {shape.global_batch} does not split into "
                         f"{n_micro} microbatches")
    size = shape.global_batch // n_micro
    runs = 1 if count_one_micro else n_micro

    def grads_of(params, batch):
        flat = tree.leaves(params)
        loss, met = lm.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return grads, {k: v.detach() for k, v in met.items()}

    def micro(batch, i):
        if mesh is None:
            return {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        return {k: _local_rows(v, i, n_micro) for k, v in batch.items()}

    def step_fn(state: TrainState, batch: Dict[str, Any]):
        params = state.params
        if mesh is None:
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in batch.items()}
        else:
            batch = shard_batch(cfg, mesh, batch)
        with activation_mesh(mesh):
            if n_micro == 1:
                flat, metrics = grads_of(params, batch)
            else:
                flat = [torch.zeros_like(p, dtype=torch.float32,
                                         requires_grad=False)
                        for p in tree.leaves(params)]
                mets = []
                for i in range(runs):
                    with op_cost.trips(n_micro // runs):
                        g, met = grads_of(params, micro(batch, i))
                        for acc, gi in zip(flat, g):
                            acc.add_(gi.float())
                    del g
                    mets.append(met)
                for acc in flat:
                    acc.div_(runs)
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


def _local_rows(v: DTensor, i: int, n: int) -> DTensor:
    """Microbatch ``i`` of ``n`` of a batch-sharded DTensor: the i-th n-th
    of every rank's own rows, still sharded as ``v`` is."""
    local = v.to_local()
    rows = local.shape[0] // n
    if rows * n != local.shape[0]:
        raise ValueError(f"{local.shape[0]} rows per rank do not split into "
                         f"{n} microbatches")
    return DTensor.from_local(local[i * rows:(i + 1) * rows], v.device_mesh,
                              v.placements, run_check=False)


# ---------------------------------------------------------------------------
# Placing params and inputs on a mesh
# ---------------------------------------------------------------------------


def shard_params(params: Tree, mesh) -> Tree:
    """Params (the same full tensors on every rank) as DTensors placed by
    ``sharding.param_specs``."""
    return shd.distribute(params, shd.param_specs(params, mesh), mesh)


def shard_batch(cfg: ArchConfig, mesh, batch: Dict[str, Any]
                ) -> Dict[str, DTensor]:
    """A batch (host arrays or tensors, the whole global batch on every
    rank) as DTensors placed by ``sharding.batch_specs``; DTensors pass."""
    dev = mesh.device_type
    out = {k: v if isinstance(v, DTensor) else torch.as_tensor(v, device=dev)
           for k, v in batch.items()}
    plain = {k: v for k, v in out.items() if not isinstance(v, DTensor)}
    placed = shd.distribute(plain, shd.batch_specs(cfg, mesh, plain), mesh)
    return {**out, **placed}


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------


def build_prefill_step(cfg: ArchConfig, mesh, shape: InputShape,
                       cache_dtype=torch.bfloat16) -> Callable:
    """(params, batch) -> (last logits (B, Vp), cache): the vocab over
    ``model``, the cache (``cache_dtype``, the reference's bf16 by default)
    placed by ``sharding.cache_specs``. Params as ``shard_params`` places
    them."""
    def fn(params, batch):
        batch = shard_batch(cfg, mesh, batch)
        with torch.no_grad(), activation_mesh(mesh):
            return lm.prefill(params, cfg, tokens=batch.get("tokens"),
                              patches=batch.get("patches"),
                              frames=batch.get("frames"),
                              max_len=shape.seq_len, cache_dtype=cache_dtype)
    return fn


def build_encode_step(cfg: ArchConfig, mesh, shape: InputShape) -> Callable:
    """Encoder-only archs: (params, batch) -> full-sequence logits (B, T,
    Vp)."""
    def fn(params, batch):
        batch = shard_batch(cfg, mesh, batch)
        with torch.no_grad(), activation_mesh(mesh):
            return lm.forward(params, cfg, tokens=batch.get("tokens"),
                              patches=batch.get("patches"),
                              frames=batch.get("frames"))
    return fn


def build_decode_step(cfg: ArchConfig, mesh, shape: InputShape) -> Callable:
    """(params, cache, token, pos) -> (logits (B, Vp), cache), the cache
    updated in place. ``token`` (B,) ints, batch-sharded where B divides;
    ``pos`` the absolute position, a Python int."""
    def fn(params, cache, token, pos: int):
        token = shard_batch(cfg, mesh, {"token": token})["token"]
        with torch.no_grad(), activation_mesh(mesh):
            return lm.decode_step(params, cfg, cache, token, int(pos))
    return fn


# ---------------------------------------------------------------------------
# Abstract inputs (meta tensors: the dry run's stand-ins)
# ---------------------------------------------------------------------------


def abstract_batch(cfg: ArchConfig, shape: InputShape,
                   device="meta") -> Dict[str, torch.Tensor]:
    """Every model input of one cell as empty tensors on ``device`` (meta:
    shapes and dtypes only), the reference's dtypes."""
    b, t = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        raise ValueError("use decode_inputs() for decode shapes")
    out: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "audio":
        out["frames"] = torch.empty((b, t, cfg.d_model), dtype=torch.bfloat16,
                                    device=device)
    else:
        out["tokens"] = torch.empty((b, t), dtype=torch.int32, device=device)
        if cfg.frontend == "vision":
            out["patches"] = torch.empty((b, cfg.n_patches, cfg.d_model),
                                         dtype=torch.bfloat16, device=device)
    if shape.kind == "train":
        out["labels"] = torch.empty((b, t), dtype=torch.int32, device=device)
    return out


def decode_inputs(cfg: ArchConfig, shape: InputShape, device="meta"):
    """(cache, token, pos) stand-ins for a decode cell: the cache as
    ``lm.init_cache`` lays it out, (B,) int32 tokens, and the position of
    the token after a full cache."""
    cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                          device=torch.device(device))
    token = torch.empty((shape.global_batch,), dtype=torch.int32,
                        device=device)
    return cache, token, shape.seq_len - 1
