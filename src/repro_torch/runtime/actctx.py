"""Activation-placement context (port of ``repro.runtime.actctx``).

Model code is mesh-agnostic; the step builders run the model inside
``activation_mesh(mesh)`` so that its ``constrain()`` calls resolve to real
placements. Outside the context, or on a plain tensor (one device, the
smoke tests), ``constrain`` returns its input.

The reference's ``constrain`` is a GSPMD hint that pins the layout XLA
picks at a layer boundary. Here it is a DTensor ``redistribute`` to the
resolved placements, and so a collective where the layout changes: the
pins sit where the reference's do, so the collectives are the ones XLA
inserts there.

Placeholders:
    "B"  -> the batch axes ("pod","data") / ("data",)   (dropped if the
            dim does not divide)
    "D"  -> the FSDP axis "data" (dropped if the dim does not divide)
    "M"  -> the "model" axis (dropped if the dim does not divide)
    None -> unsharded
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

_TLS = threading.local()


@contextlib.contextmanager
def activation_mesh(mesh):
    prev = getattr(_TLS, "mesh", None)
    _TLS.mesh = mesh
    try:
        yield
    finally:
        _TLS.mesh = prev


def current_mesh():
    return getattr(_TLS, "mesh", None)


def mesh_size(mesh, name: str) -> int:
    """Size of mesh axis ``name``; 1 where the mesh has no such axis."""
    names = mesh.mesh_dim_names
    return mesh.shape[names.index(name)] if name in names else 1


def batch_axes(mesh):
    return (("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",))


def resolve(mesh, shape, spec):
    """The placements ``constrain`` gives a tensor of ``shape``: one per
    mesh dim, ``Replicate`` on an axis of one rank (so a (1, 1) mesh runs
    no collective)."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, (dim, s) in enumerate(zip(shape, spec)):
        if s == "B":
            axes = batch_axes(mesh)
        elif s == "M":
            axes = ("model",)
        elif s == "D":
            axes = ("data",)
        else:
            continue
        size = 1
        for a in axes:
            size *= mesh_size(mesh, a)
        if dim % size == 0 and dim >= size:
            for a in axes:
                if mesh_size(mesh, a) > 1:   # a 1-rank axis: whole anyway
                    out[names.index(a)] = Shard(d)
    return out


def constrain(x, *spec):
    """Redistribute a DTensor to ``spec`` (placeholders above) inside
    ``activation_mesh``; any other input is returned as is."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    if any(d <= 0 for d in x.shape):
        return x
    want = resolve(mesh, x.shape, spec)
    if list(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


# --- backward-pass dtype guard ----------------------------------------------
# f32 accumulators inside fused attention/losses are correct, but their
# cotangents must not leak f32 into the (bf16) residual stream: one f32
# cotangent at a matmul boundary turns every downstream gradient tensor and
# all-reduce into f32, 2x the bytes of the whole backward pass.


class _GradDtypeGuard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def grad_dtype_guard(x: torch.Tensor) -> torch.Tensor:
    """Identity whose backward casts the cotangent to x's dtype."""
    return _GradDtypeGuard.apply(x)


# --- the block helpers the sharded model paths share ------------------------


def placed(x: DTensor, *spec) -> DTensor:
    """``x`` redistributed to ``spec`` on its own mesh, in or out of
    ``activation_mesh``: the layout a block needs to run on local shards
    (for a weight, its FSDP dim gathered: ``None`` where the reference pins
    "D")."""
    mesh = x.device_mesh
    want = resolve(mesh, x.shape, spec)
    return x if list(x.placements) == want else x.redistribute(mesh, want)


def sharded_on(x: DTensor, axis: str = "model") -> bool:
    """Whether some dim of ``x`` is sharded over mesh axis ``axis``."""
    names = x.device_mesh.mesh_dim_names
    return axis in names and x.placements[names.index(axis)].is_shard()


def partial_on(x: DTensor, axis: str = "model") -> list:
    """``x``'s placements with ``axis`` a pending sum: the layout of a
    block's output whose contraction ran over local shards of ``axis``."""
    names = x.device_mesh.mesh_dim_names
    out = list(x.placements)
    if axis in names:
        out[names.index(axis)] = Partial()
    return out


def local_call(fn: Callable, out_placements, *args):
    """``fn`` on the local shards of the DTensors in ``args`` (nested dicts
    and lists included), through ``local_map``; each output a DTensor with
    the given placements (a tuple of them, one per output; None for a
    non-tensor output). Inputs are taken as they are placed.

    Gradients: on a mesh axis where the call is split (an input sharded or
    an output partial or sharded there), the ranks compute disjoint parts
    of the function, so an input replicated on that axis gets a partial
    gradient there (its ranks' contributions add up). An output that every
    rank of a split axis computes alike must therefore be stated as a
    partial of its share, or its gradient is counted once per rank."""
    flat = pytree.tree_leaves(args)
    dts = [a for a in flat if isinstance(a, DTensor)]
    mesh = dts[0].device_mesh
    split = set()
    for a in dts:
        split |= {i for i, p in enumerate(a.placements) if p.is_shard()}
    for pl in out_placements:
        if pl is not None:
            split |= {i for i, p in enumerate(pl)
                      if p.is_shard() or p.is_partial()}
    grads = [None if not isinstance(a, DTensor) else tuple(
        Partial() if i in split and p.is_replicate() else p
        for i, p in enumerate(a.placements)) for a in flat]
    return local_map(fn, out_placements=out_placements,
                     in_grad_placements=grads, device_mesh=mesh)(*args)


def local_rank(mesh, name: str) -> int:
    """This rank's coordinate on mesh axis ``name`` (0 where the mesh has no
    such axis)."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(name)
