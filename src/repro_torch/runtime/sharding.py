"""Sharding rules: ArchConfig + mesh -> a spec for every tensor (port of
``repro.runtime.sharding``).

Strategy, as in the reference: hybrid **FSDP x TP**.

* ``model`` mesh axis = tensor parallelism: d_ff columns, attention heads,
  experts, vocab.
* ``data`` mesh axis = FSDP: the *other* matrix dim of every weight, plus
  the batch dim of activations.
* ``pod``  mesh axis (multi-pod mesh only) = pure data parallelism:
  weights replicated across pods, batch sharded.

Divisibility guard: a dim is sharded on an axis only if it divides evenly;
otherwise that dim is replicated (``explain()`` shows it). So no shard is
ever uneven.

A spec is a tuple with one entry per tensor dim (fewer for a scalar): an
axis name, a tuple of axis names, or None. It compares one to one with the
reference's ``tuple(PartitionSpec)``. ``placements`` turns a spec into
DTensor placements on a ``DeviceMesh``, ``distribute`` places a whole tree.
A mesh here is a ``DeviceMesh`` or, for the rules alone, a mapping of axis
name to size in mesh order.
"""

from __future__ import annotations

import dataclasses
import re
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch import tree as tree_lib
from repro_torch.configs.base import PortArchConfig

Tree = Any
Spec = Tuple[Any, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    n = 1
    for a in _astuple(axis):
        n *= sizes[a]
    return n


def _astuple(axis):
    return axis if isinstance(axis, tuple) else (axis,)


def data_axes(mesh) -> Tuple[str, ...]:
    """Batch shards over pod+data when the pod axis exists."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def _batch_entry(mesh):
    """The batch axes as one spec entry: a name alone, or a tuple of names
    (as ``PartitionSpec`` normalizes them)."""
    da = data_axes(mesh)
    return da[0] if len(da) == 1 else da


# ---------------------------------------------------------------------------
# Per-parameter rules
# ---------------------------------------------------------------------------

# (regex on the leaf path, spec builder). The builder gets the leaf shape
# and the mesh; axes that don't divide are dropped to None.
# fsdp = "data" (never "pod": weights replicate across pods).

def _spec(shape, mesh, axes) -> Spec:
    """A spec, dropping any axis that doesn't divide."""
    out = []
    for dim, ax in zip(shape, axes):
        if ax is None:
            out.append(None)
            continue
        size = mesh_axis_size(mesh, ax)
        out.append(ax if dim % size == 0 and size > 1 else None)
    return tuple(out)


_RULES = [
    # embeddings / head: the embed table shards d_model over "model", not
    # vocab, so the lookup and its scatter-add gradient stay local.
    (r"embed$", lambda s, m: _spec(s, m, (None, "model"))),
    (r"lm_head$", lambda s, m: _spec(s, m, ("data", "model"))),
    # attention
    (r"sub1/wq$", lambda s, m: _spec(s, m, ("data", "model", None))),
    (r"sub1/wk$", lambda s, m: _spec(s, m, ("data", "model", None))),
    (r"sub1/wv$", lambda s, m: _spec(s, m, ("data", "model", None))),
    (r"sub1/wo$", lambda s, m: _spec(s, m, ("model", None, "data"))),
    (r"sub1/b[qkv]$", lambda s, m: _spec(s, m, ("model", None))),
    (r"sub1/[qk]_norm$", lambda s, m: (None,)),
    # dense FFN
    (r"sub2/w_gate$", lambda s, m: _spec(s, m, ("data", "model"))),
    (r"sub2/w_up$", lambda s, m: _spec(s, m, ("data", "model"))),
    (r"sub2/w_down$", lambda s, m: _spec(s, m, ("model", "data"))),
    # MoE: experts over model (EP), FSDP inside each expert
    (r"sub2/router$", lambda s, m: _spec(s, m, ("data", None))),
    (r"sub2/shared/w_gate$", lambda s, m: _spec(s, m, ("data", "model"))),
    (r"sub2/shared/w_up$", lambda s, m: _spec(s, m, ("data", "model"))),
    (r"sub2/shared/w_down$", lambda s, m: _spec(s, m, ("model", "data"))),
    # RG-LRU
    (r"sub1/w_gate_br$", lambda s, m: _spec(s, m, ("data", "model"))),
    (r"sub1/w_in$", lambda s, m: _spec(s, m, ("data", "model"))),
    (r"sub1/w_out$", lambda s, m: _spec(s, m, ("model", "data"))),
    (r"sub1/conv_w$", lambda s, m: _spec(s, m, (None, "model"))),
    (r"sub1/conv_b$", lambda s, m: _spec(s, m, ("model",))),
    (r"sub1/w_[ax]$", lambda s, m: _spec(s, m, ("model", None, None))),
    (r"sub1/b_[ax]$", lambda s, m: _spec(s, m, ("model",))),
    (r"sub1/lambda$", lambda s, m: _spec(s, m, ("model",))),
    # RWKV time-mix: projections data-sharded, model-replicated (the state
    # math is per head and 40 heads do not divide 16)
    (r"sub1/w_[rkvg]$", lambda s, m: _spec(s, m, ("data", None))),
    (r"sub1/w_o$", lambda s, m: _spec(s, m, (None, "data"))),
    (r"sub1/decay_A$", lambda s, m: _spec(s, m, ("data", None))),
    (r"sub1/decay_B$", lambda s, m: (None, None)),
    (r"sub1/(decay_base|bonus_u)$", lambda s, m: (None, None)),
    (r"sub1/(ln_x|mu|cm_mu)$", lambda s, m: (None,)),
    # RWKV channel-mix
    (r"sub1/cm_k$", lambda s, m: _spec(s, m, ("data", "model"))),
    (r"sub1/cm_v$", lambda s, m: _spec(s, m, ("model", "data"))),
    (r"sub1/cm_r$", lambda s, m: _spec(s, m, ("data", None))),
    # norms
    (r"(norm1|norm2|post_norm1|post_norm2|final_norm)$",
     lambda s, m: (None,)),
]

_MOE_3D = {
    "sub2/w_gate": ("model", "data", None),
    "sub2/w_up": ("model", "data", None),
    "sub2/w_down": ("model", None, "data"),
}


def _spec_for(path: str, shape, mesh) -> Spec:
    # MoE expert weights are 3-D versions of the FFN names.
    for suffix, axes in _MOE_3D.items():
        if path.endswith(suffix) and "shared" not in path and len(shape) == 3:
            return _spec(shape, mesh, axes)
    for pat, fn in _RULES:
        if re.search(pat, path):
            return fn(shape, mesh)
    if len(shape) <= 1:                  # scalars / odd vectors: replicate
        return (None,) if shape else ()
    raise ValueError(f"no sharding rule for param {path!r} shape {shape}")


def _leaf_spec(path: str, shape, mesh) -> Spec:
    """A parameter's spec; a stacked unit's leading n_units axis gets
    None."""
    stacked = "units/" in path
    key = re.sub(r"^(units|tail)/\d+/", "", path)
    spec = _spec_for(key, tuple(shape[1:]) if stacked else tuple(shape),
                     mesh)
    return (None,) + spec if stacked else spec


def param_specs(abstract_params: Tree, mesh) -> Tree:
    """A spec tree matching the params tree (meta tensors will do)."""
    flat = tree_lib.flatten_with_path(abstract_params)
    return tree_lib.unflatten(
        abstract_params, [_leaf_spec(p, leaf.shape, mesh) for p, leaf in flat])


# ---------------------------------------------------------------------------
# Activation / batch / cache specs
# ---------------------------------------------------------------------------


def check_meshable(cfg) -> None:
    """Refuse an architecture the reference does not run: its rules here
    are the reference's, and no mesh has run it (ROADMAP, Queue 4, C1: the
    mesh across cards)."""
    if isinstance(cfg, PortArchConfig):
        raise NotImplementedError(
            f"{cfg.name}: the mesh path runs only the reference's ten "
            f"architectures; sharding this one is ROADMAP C1's (the mesh "
            f"across cards)")


def batch_specs(cfg, mesh, batch_abstract: Tree) -> Tree:
    """Shard every batch tensor on its leading (global-batch) dim."""
    check_meshable(cfg)
    da = _batch_entry(mesh)
    dsize = mesh_axis_size(mesh, da)

    def one(leaf):
        if leaf.shape and leaf.shape[0] % dsize == 0 and leaf.shape[0] > 1:
            return (da,)
        return ()
    return tree_lib.map_leaves(one, batch_abstract)


def cache_specs(cfg, mesh, cache_abstract: Tree) -> Tree:
    """KV/state caches: batch dim sharded; kv-head dim sharded over model
    when divisible, else the sequence dim (so a 32k cache of a 72B model
    does not sit whole on every device). Stacked (units) axis -> None."""
    check_meshable(cfg)
    da = _batch_entry(mesh)
    dsize = mesh_axis_size(mesh, da)
    msize = mesh_axis_size(mesh, "model")
    out = []
    for path, leaf in tree_lib.flatten_with_path(cache_abstract):
        stacked = "units/" in path
        shape = tuple(leaf.shape[1:]) if stacked else tuple(leaf.shape)
        name = path.rsplit("/", 1)[-1]
        bs = da if shape and shape[0] % dsize == 0 and shape[0] > 1 else None
        if name in ("k", "v"):          # (B, S, Hkv, hd)
            hs = "model" if shape[2] % msize == 0 else None
            ss = ("model" if hs is None and shape[1] % msize == 0
                  and shape[1] >= msize else None)
            spec: Spec = (bs, ss, hs, None)
        elif name == "S":               # rwkv state (B, H, K, V)
            spec = (bs,) + (None,) * (len(shape) - 1)
        elif len(shape) >= 2:           # h / conv / x_tm / x_cm: (B, ...)
            last = ("model" if shape[-1] % msize == 0
                    and name in ("h", "conv") else None)
            spec = (bs,) + (None,) * (len(shape) - 2) + (last,)
        else:
            spec = (bs,)
        out.append((None,) + spec if stacked else spec)
    return tree_lib.unflatten(cache_abstract, out)


def explain(abstract_params: Tree, mesh) -> Dict[str, str]:
    """path -> spec, for reading and debugging."""
    flat = tree_lib.flatten_with_path(abstract_params)
    return {p: str(_leaf_spec(p, leaf.shape, mesh)) for p, leaf in flat}


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: Spec, mesh, shape: Optional[Tuple[int, ...]] = None
               ) -> List:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` where the mesh axis appears in entry d (a tensor dim on
    ("pod", "data") shards on both, in mesh order), else ``Replicate()``.
    With ``shape``, every sharded dim must divide evenly."""
    sizes = axis_sizes(mesh)
    names = list(sizes)
    out: List = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in _astuple(entry):
            if sizes[ax] > 1:          # a 1-rank axis holds the whole dim
                out[names.index(ax)] = Shard(d)
    if shape is not None:
        for d, entry in enumerate(spec):
            if entry is not None and shape[d] % mesh_axis_size(mesh, entry):
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                                 f"over {entry}: an uneven shard")
    return out


def distribute(tree: Tree, specs: Tree, mesh) -> Tree:
    """Each leaf of ``tree`` as a DTensor on ``mesh`` placed by its spec.
    Every rank must hold the same full tensor (seeded alike); each keeps
    its own shard, with no communication."""
    def one(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute_tensor(leaf, mesh,
                                 placements(spec, mesh, tuple(leaf.shape)),
                                 src_data_rank=None)
    return tree_lib.unflatten(tree, [one(leaf, spec_at(specs, p)) for p, leaf
                                     in tree_lib.flatten_with_path(tree)])


def local_part(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The part of the whole tensor ``t`` that this rank keeps under
    ``spec``, a view: each sharded dim narrowed to this rank's even share,
    the mesh dims of one tensor dim nested in mesh order (as DTensor
    places ``Shard`` on several mesh dims)."""
    pls = placements(spec, mesh, tuple(t.shape))
    for i, pl in enumerate(pls):
        if pl.is_shard():
            n = mesh.size(i)
            size = t.shape[pl.dim] // n
            t = t.narrow(pl.dim, mesh.get_local_rank(i) * size, size)
    return t


def from_local(local: torch.Tensor, spec: Spec, mesh, shape) -> DTensor:
    """A DTensor of global ``shape`` on ``mesh`` from this rank's part
    (``local_part``), with no communication."""
    shape = tuple(shape)
    stride = tuple(int(s) for s in torch.empty(shape, device="meta").stride())
    return DTensor.from_local(local.contiguous(), mesh,
                              placements(spec, mesh, shape), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def spec_at(specs: Tree, path: str) -> Spec:
    """The spec at ``path`` (``tree.flatten_with_path``'s naming) of a spec
    tree, whose tuples are leaves."""
    node = specs
    for key in path.split(tree_lib.SEP) if path else ():
        if isinstance(node, Mapping):
            node = node[key]
        elif dataclasses.is_dataclass(node):
            node = getattr(node, dataclasses.fields(node)[int(key)].name)
        else:
            node = node[int(key)]
    return node
