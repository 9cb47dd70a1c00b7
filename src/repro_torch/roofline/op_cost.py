"""Per-device cost of a PyTorch step, counted op by op (the port's
counterpart of ``repro.roofline.hlo_cost``).

The reference walks the optimized HLO of a compiled SPMD module.
``OpCostMode`` is a ``TorchDispatchMode`` that sees every operator a step
runs, eagerly or under ``FakeTensorMode`` (the dry run: shapes only, no
data), and counts with the reference's rules:

    dot (mm, bmm, ...)   2 x |result| x K
    elementwise          |result| FLOPs (transcendentals counted apart too)
    reduction            |operand| FLOPs
    custom op            its registered flop formula (the hand kernels:
                         ``repro_torch::fused_ffn``, ``::flash_attention``)
    collective           wire bytes by the ring model (``analysis``)
    bytes                each op's operands and result, at the op boundary

Each op is counted ONCE, at its LOCAL shape: an op on DTensors is let
through (``NotImplemented``), DTensor runs it as local ops and collectives,
and those come back to the mode, which counts them. (A mode that counted
the DTensor op too would count a sharded matmul at its global shape, and
``FlopCounterMode`` does both.)

Bytes are per eager op: an elementwise chain that XLA fuses into one
kernel is counted once per op here, so ``bytes`` is an upper bound on the
HBM traffic and is not comparable with the reference's fused bytes.

``trips(n)`` multiplies what is counted inside it by n: a loop whose trips
cost the same (a train step's microbatches) is run once and counted n
times, as ``hlo_cost`` scales a while body by its trip count.
``peak_live_bytes`` is an estimate: the most bytes that op outputs held at
once, not an allocator's peak. An output's bytes are live while any tensor
on its storage is: the output itself, a view of it, a collective's wait,
a detached copy a checkpoint saved. The count holds no tensor object: a
checkpoint's recompute saves detached views into their base's own graph,
so holding a base for as long as its views live would never free it.
``peak_live_by`` says
what was live at that peak: bytes and tensor count by op and output shape
and dtype, summing to ``peak_live_bytes``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

import torch
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.analysis import wire_bytes

aten = torch.ops.aten

_DOTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.dot, aten.mv}

# no data moves: views, metadata, aliases
_FREE = {aten.view, aten._unsafe_view, aten.reshape, aten.permute,
         aten.transpose, aten.t, aten.expand, aten.slice, aten.select,
         aten.squeeze, aten.unsqueeze, aten.alias, aten.detach,
         aten.as_strided, aten.unbind, aten.split, aten.split_with_sizes,
         aten.chunk, aten.unfold, aten.lift_fresh, aten.view_as_real,
         aten.view_as_complex, aten._reshape_alias, aten.diagonal,
         aten.split_with_sizes_copy, aten.sym_size, aten.sym_stride,
         aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
         aten._local_scalar_dense, aten.set_}

# write their result, compute nothing
_FILL = {aten.empty, aten.empty_like, aten.empty_strided, aten.zeros,
         aten.zeros_like, aten.ones, aten.ones_like, aten.full,
         aten.full_like, aten.new_zeros, aten.new_empty, aten.new_ones,
         aten.new_full, aten.arange, aten.scalar_tensor, aten.eye,
         aten.fill_, aten.zero_}

_TRANSCENDENTAL = {aten.exp, aten.exp2, aten.log, aten.log2, aten.tanh,
                   aten.rsqrt, aten.sqrt, aten.pow, aten.sin, aten.cos,
                   aten.sigmoid, aten.expm1, aten.log1p, aten.atan2,
                   aten.erf, aten.logaddexp, aten.softplus, aten.gelu,
                   aten.silu}

_REDUCE = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min,
           aten.argmax, aten.argmin, aten.var, aten.var_mean, aten.std,
           aten.norm, aten.linalg_vector_norm, aten.any, aten.all,
           aten.prod, aten.cumsum, aten.logsumexp, aten.topk, aten.sort}

# softmax as XLA lowers it: max, subtract, exp, sum, divide (log_softmax:
# a log for the divide); one transcendental per element
_SOFTMAX = {aten._softmax: 5, aten._log_softmax: 5,
            aten._softmax_backward_data: 4, aten._log_softmax_backward_data: 4}

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
}


@dataclasses.dataclass
class Cost:
    """Per-device counts (the reference's ``hlo_cost.Cost``)."""

    flops: float = 0.0
    bytes: float = 0.0
    transcendental: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_counts: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())


@dataclasses.dataclass
class CollectiveRecord:
    """One collective as run: its kind, the bytes of its operand and
    result, its group's size and name, and how many times it counts."""

    kind: str
    in_bytes: int
    out_bytes: int
    group_size: int
    group_name: str
    times: float = 1.0


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _dot_flops(packet, args, out) -> float:
    """2 x |result| x K: K from the left operand's last dim."""
    if packet in (aten.addmm, aten.baddbmm):
        lhs = args[1]
    else:
        lhs = args[0]
    return 2.0 * out.numel() * lhs.shape[-1]


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


class OpCostMode(TorchDispatchMode):
    """Count what runs inside it (see the module docstring). After the
    ``with`` block: ``cost()``, ``collectives``, the per-op ledgers
    ``flops_by`` and ``bytes_by`` (for ``breakdown``),
    ``peak_live_bytes`` and ``peak_live_by``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendental = 0.0
        self.collectives: List[CollectiveRecord] = []
        self.flops_by: Dict[str, float] = defaultdict(float)
        self.bytes_by: Dict[str, float] = defaultdict(float)
        self.live = 0
        self.peak_live_bytes = 0
        # each live output's storage: [bytes, tensors on it, ledger key]
        self._storages: Dict[int, list] = {}
        # bytes and tensors live now, by op and output; copied at the peak
        # once the live total next falls (or is read), so a run of rising
        # outputs costs one copy
        self._live_by: Dict[str, List[int]] = defaultdict(lambda: [0, 0])
        self._peak_by: Dict[str, Tuple[int, int]] = {}
        self._at_peak = False
        self._trips = 1.0
        self._hidden = 0

    def __enter__(self):
        _hide_sharding_propagation()
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def cost(self) -> Cost:
        c = Cost(self.flops, self.bytes, self.transcendental)
        for r in self.collectives:
            b = wire_bytes(r.kind, r.in_bytes, r.out_bytes, r.group_size)
            c.coll_bytes[r.kind] = c.coll_bytes.get(r.kind, 0.0) + b * r.times
            c.coll_counts[r.kind] = c.coll_counts.get(r.kind, 0.0) + r.times
        return c

    @property
    def peak_live_by(self) -> Dict[str, Tuple[int, int]]:
        """What was live at the peak: {"op (shape) dtype": (bytes,
        tensors)}, the bytes summing to ``peak_live_bytes``."""
        if self._at_peak:
            self._snapshot()
        return dict(self._peak_by)

    def _snapshot(self) -> None:
        self._peak_by = {k: (b, n) for k, (b, n) in self._live_by.items()
                         if n}
        self._at_peak = False

    def _track(self, out, op: str) -> None:
        """Count each new storage among ``out``'s tensors as live until the
        last tensor on it goes; a tensor on a storage already counted is
        one more holder of it."""
        for t in _tensors(out):
            sid = _storage_id(t)
            if sid in self._storages:
                self._hold(t, sid)
                continue
            n = _nbytes(t)
            key = f"{op} {tuple(t.shape)} {str(t.dtype)[6:]}"
            self._storages[sid] = [n, 0, key]
            entry = self._live_by[key]
            entry[0] += n
            entry[1] += 1
            self.live += n
            if self.live > self.peak_live_bytes:
                self.peak_live_bytes = self.live
                self._at_peak = True
            self._hold(t, sid)

    def _alias(self, out, args) -> None:
        """An aliasing output (a view, a collective's wait, an in-place
        op's result): one more holder of the storage it shares, or, where
        it has a storage of its own (a fake wait), of its first input's."""
        base = args[0] if args and isinstance(args[0], torch.Tensor) else None
        for t in _tensors(out):
            sid = _storage_id(t)
            if sid in self._storages:
                self._hold(t, sid)
            elif base is not None and _storage_id(base) in self._storages:
                # the input's storage object, kept while ``t`` lives, so
                # that its identity is not reused by another storage
                self._hold(t, _storage_id(base), base.untyped_storage())

    def _hold(self, t, sid: int, storage=None) -> None:
        self._storages[sid][1] += 1
        weakref.finalize(t, self._release, sid, storage)

    def _release(self, sid: int, storage=None) -> None:
        st = self._storages[sid]
        st[1] -= 1
        if st[1]:
            return
        del self._storages[sid]
        if self._at_peak:
            self._snapshot()
        n, _, key = st
        entry = self._live_by[key]
        entry[0] -= n
        entry[1] -= 1
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented    # DTensor's local ops come back here
        out = func(*args, **kwargs)
        if self._hidden:             # DTensor deriving a global output shape
            return out
        packet = func._overloadpacket
        name = packet.__name__
        ns = func.namespace
        mult = self._trips
        shape = tuple(out.shape) if isinstance(out, torch.Tensor) else ""
        key = f"{ns}.{name} {shape}"
        if ns in ("_c10d_functional", "_c10d_functional_autograd"):
            if name in _COLLECTIVES:
                group = args[-1]
                self.collectives.append(CollectiveRecord(
                    _COLLECTIVES[name], _nbytes(args[0]), _nbytes(out),
                    _group_size(group), str(group), mult))
                self.bytes += mult * _nbytes(out)
                self.bytes_by[key] += mult * _nbytes(out)
                self._track(out, f"{ns}.{name}")
            else:                    # wait_tensor: its input, ready
                self._alias(out, args)
            return out
        if packet in _FREE or ns == "prim":
            self._alias(out, args)
            return out
        res = _tensors(out)
        if any(t.device.type == "meta" for t in res):
            return out               # shapes only (templates, not steps)
        io_bytes = sum(_nbytes(t) for t in _tensors((args, kwargs)))
        res_bytes = sum(_nbytes(t) for t in res)
        res_elems = sum(t.numel() for t in res)
        if packet in _FILL:
            flops, io_bytes = 0.0, 0
        elif packet in flop_registry and ns != "aten":
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        elif packet in _DOTS:
            flops = _dot_flops(packet, args, res[0])
        elif packet in _SOFTMAX:
            flops = _SOFTMAX[packet] * res_elems
            self.transcendental += mult * res_elems
        elif packet in _REDUCE:
            flops = float(sum(t.numel() for t in _tensors(args[:1])))
        else:
            flops = float(res_elems)
            if packet in _TRANSCENDENTAL:
                self.transcendental += mult * res_elems
        self.flops += mult * flops
        self.bytes += mult * (io_bytes + res_bytes)
        self.flops_by[key] += mult * flops
        self.bytes_by[key] += mult * (io_bytes + res_bytes)
        if _aliases(func):
            self._alias(out, args)
        else:
            self._track(out, f"{ns}.{name}")
        return out


_ACTIVE: List[OpCostMode] = []


@contextlib.contextmanager
def trips(n: float) -> Iterator[None]:
    """Inside an ``OpCostMode``, count everything run here n times (a loop
    run once of n equal trips); outside one, nothing changes."""
    if not _ACTIVE:
        yield
        return
    mode = _ACTIVE[-1]
    prev = mode._trips
    mode._trips = prev * n
    try:
        yield
    finally:
        mode._trips = prev


def _hide_sharding_propagation() -> None:
    """Keep DTensor's own shape inference out of the counts: to find a
    sharded op's global output shape, DTensor runs the op once more on fake
    tensors of the global shape, and those runs pass through the mode. The
    wrapper marks them (installed once, a no-op outside an OpCostMode)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    inner = ShardingPropagator._propagate_tensor_meta_non_cached
    if getattr(inner, "_op_cost_hidden", False):
        return

    def hidden(self, *args, **kwargs):
        mode = _ACTIVE[-1] if _ACTIVE else None
        if mode is not None:
            mode._hidden += 1
        try:
            return inner(self, *args, **kwargs)
        finally:
            if mode is not None:
                mode._hidden -= 1
    hidden._op_cost_hidden = True
    ShardingPropagator._propagate_tensor_meta_non_cached = hidden


def _storage_id(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage, shared by its views (a tensor with
    no storage stands alone)."""
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return id(t)


def _aliases(func) -> bool:
    """Whether ``func`` returns a view or one of its inputs (no new
    storage)."""
    return any(r.alias_info is not None for r in func._schema.returns)
