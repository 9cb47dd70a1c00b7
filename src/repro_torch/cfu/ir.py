"""Program IR + memory planner for the pass-based CFU compiler.

The compiler used to be a monolithic emitter with two copy-pasted entry
points (DSC chain / full VWW network), each hard-coding three schedules.
This module is the shared substrate both now build:

* **Typed ops** (``Conv3x3`` / ``DSCBlock`` / ``Head1x1`` / ``GAP`` /
  ``FC``) over named **tensor values** with explicit shapes — a linear,
  SSA-ish program IR (every value has exactly one producer; consumers are
  recorded for liveness).
* **Schedule annotations**: each ``DSCBlock`` carries the schedule the
  scheduling passes picked for it (``compiler.assign_schedules`` /
  ``compiler.auto_schedule``), so one stream can mix schedules per block.
* **Memory planning as a pass** (``plan_memory``): a liveness-driven
  first-fit allocator per memory space replaces the old bump allocator +
  ad-hoc scratch arena. Buffers whose lifetimes do not overlap share
  addresses (that is what shrinks the SRAM high-water), and any two
  *simultaneously live* regions that collide raise ``MemoryPlanError`` —
  overlap is now checked, never silent.

Schedules (``CFUSchedule`` + the ``SCHEDULES`` registry)
--------------------------------------------------------
=============== =============================================================
``layer-dram``   layer-by-layer, F1/F2 materialized off-chip (paper Eq. 1)
``layer-sram``   layer-by-layer, F1/F2 in the on-chip scratch (paper Eq. 2)
``fused``        the paper's pixel-wise dataflow (zero feature-map buffer)
``fused-rowtile`` row-tile fusion with a rolling SRAM F1 strip and halo
                 *reuse* across row tiles (incl. the stride-2 single-row
                 halo): every input row's expansion is computed exactly
                 once — the ``dsc_block_fused_rowtile``/Pallas granularity,
                 but with zero expansion recompute — while DRAM traffic
                 stays exactly the fused dataflow's.
``fused-winograd`` rowtile dataflow with the depthwise stage on the exact
                 integer Winograd F(2x2,3x3) unit (``CFG_WINO`` /
                 ``WINO_MAC``): 2x2 output tiles from 4x4 F1 windows, 4
                 effective multiplies per output instead of 9, bit-exact
                 by construction (``cfu/winograd.py``). Stride-1 blocks
                 only; stride-2 blocks fall back to ``fused``
                 transparently at schedule-assignment time.
=============== =============================================================

``SCHEDULES`` is the single registry every CLI/benchmark choice list is
derived from; ``"auto"`` (per-block cost-model pick) is a compiler-level
policy, not a schedule, and lives in ``compiler.AUTO_SCHEDULE``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.cfu import isa
from repro_torch.core.dsc import DSCBlockSpec


class CFUSchedule(enum.Enum):
    LAYER_DRAM = "layer-dram"
    LAYER_SRAM = "layer-sram"
    FUSED = "fused"
    FUSED_ROWTILE = "fused-rowtile"
    FUSED_WINOGRAD = "fused-winograd"


#: Schedules whose per-pixel phases span several engine groups, so the
#: v1/v2/v3 pipelining mode changes their cycle count (layer-by-layer
#: passes are single-group: all modes coincide). Report/bench tables
#: derive their pipeline sweeps from this one set.
MULTI_STAGE_SCHEDULES = frozenset(
    {CFUSchedule.FUSED, CFUSchedule.FUSED_ROWTILE,
     CFUSchedule.FUSED_WINOGRAD})

#: name -> (schedule, one-line description). The single source of truth for
#: every ``--schedule`` choice list and report row label.
SCHEDULES: Dict[str, Tuple[CFUSchedule, str]] = {
    CFUSchedule.LAYER_DRAM.value:
        (CFUSchedule.LAYER_DRAM,
         "layer-by-layer, F1/F2 via DRAM (paper Eq. 1 baseline)"),
    CFUSchedule.LAYER_SRAM.value:
        (CFUSchedule.LAYER_SRAM,
         "layer-by-layer, F1/F2 in SRAM (paper Eq. 2 buffer)"),
    CFUSchedule.FUSED.value:
        (CFUSchedule.FUSED,
         "fused pixel-wise (paper dataflow, zero buffer)"),
    CFUSchedule.FUSED_ROWTILE.value:
        (CFUSchedule.FUSED_ROWTILE,
         "row-tile fused, rolling SRAM F1 strip, halo reuse across rows"),
    CFUSchedule.FUSED_WINOGRAD.value:
        (CFUSchedule.FUSED_WINOGRAD,
         "rowtile fused, depthwise on the exact-integer Winograd "
         "F(2x2,3x3) unit (stride-2 blocks fall back to fused)"),
}


# ---------------------------------------------------------------------------
# Values & ops
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Value:
    """One named tensor: shape, producing op, and liveness interval.

    ``def_idx`` is the index of the producing op (-1 = program input);
    ``last_use`` the index of the last consuming op (``None`` = live to the
    end of the program — program outputs and pinned multi-stream
    boundaries). ``space`` is decided by scheduling (scratch) or fixed by
    convention (block IO lives in DRAM; the CFU owns no persistent
    feature-map storage).
    """

    name: str
    shape: Tuple[int, ...]
    space: int = isa.SPACE_DRAM
    def_idx: int = -1
    last_use: Optional[int] = None
    port_resident: bool = False     # never touches memory (e.g. GAP output)
    scratch: bool = False           # scheduler-materialized, single-op life

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


@dataclasses.dataclass
class Op:
    """Base: one network-level operation over named values."""

    name: str
    inputs: List[str]
    outputs: List[str]
    param_idx: int = 0


@dataclasses.dataclass
class Conv3x3(Op):
    """Standard 3x3 stride-2 conv (the VWW stem) on the expansion array."""

    cin: int = 0
    cout: int = 0
    h: int = 0
    w: int = 0
    stride: int = 2


@dataclasses.dataclass
class DSCBlock(Op):
    """One inverted-residual block; ``schedule`` is a pass annotation."""

    spec: Optional[DSCBlockSpec] = None
    h: int = 0
    w: int = 0
    schedule: Optional[CFUSchedule] = None
    tile_rows: int = 4              # fused-rowtile granularity
    scratch: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Head1x1(Op):
    """1x1 conv + ReLU6 (EXP engine, VEC mode)."""

    cin: int = 0
    cout: int = 0
    h: int = 0
    w: int = 0


@dataclasses.dataclass
class GAP(Op):
    """Global average pool; output is port-resident (projection input)."""

    ch: int = 0
    h: int = 0
    w: int = 0


@dataclasses.dataclass
class FC(Op):
    """Classifier on the projection port; consumes the GAP port vector."""

    cin: int = 0
    cout: int = 0


@dataclasses.dataclass
class IRProgram:
    """A linear op list + its value environment (built before any pass)."""

    ops: List[Op]
    values: Dict[str, Value]
    in_value: str
    out_value: str
    network: Optional[str] = None   # "vww" for full-network streams
    extra_meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def value_of(self, name: str) -> Value:
        return self.values[name]

    def add_value(self, v: Value) -> Value:
        if v.name in self.values:
            raise ValueError(f"duplicate value {v.name!r}")
        self.values[v.name] = v
        return v

    def dsc_blocks(self) -> List[DSCBlock]:
        return [op for op in self.ops if isinstance(op, DSCBlock)]


# ---------------------------------------------------------------------------
# IR construction (the one lowering path both entry points share)
# ---------------------------------------------------------------------------


def _use(ir: IRProgram, name: str, op_idx: int) -> None:
    v = ir.values[name]
    if v.last_use is not None:
        v.last_use = max(v.last_use, op_idx)


def _append_chain(ir: IRProgram, specs: Sequence[Tuple[str, DSCBlockSpec]],
                  prev: str, h: int, w: int, *,
                  param_base: int = 0) -> Tuple[str, int, int]:
    """Append a DSC chain to ``ir`` (block i's output feeds block i+1);
    the ONE chain-construction loop both entry points share. Returns the last
    output value name and its (h, w)."""
    for bi, (name, spec) in enumerate(specs):
        oi = len(ir.ops)
        h2, w2 = spec.out_hw(h, w)
        out = ir.add_value(Value(f"y@{name}", (h2, w2, spec.cout),
                                 def_idx=oi, last_use=oi)).name
        ir.ops.append(DSCBlock(name=name, inputs=[prev], outputs=[out],
                               param_idx=param_base + bi, spec=spec,
                               h=h, w=w))
        _use(ir, prev, oi)
        prev, (h, w) = out, (h2, w2)
    return prev, h, w


def build_chain_ir(specs: Sequence[Tuple[str, DSCBlockSpec]],
                   h: int, w: int, *, param_base: int = 0) -> IRProgram:
    """A bare DSC chain: block i's output value is block i+1's input."""
    ir = IRProgram(ops=[], values={}, in_value="x0", out_value="")
    ir.add_value(Value("x0", (h, w, specs[0][1].cin),
                       def_idx=-1, last_use=0))
    prev, _, _ = _append_chain(ir, specs, "x0", h, w,
                               param_base=param_base)
    ir.out_value = prev
    ir.values[prev].last_use = None          # program output: live to HALT
    return ir


def build_vww_ir(specs: Sequence[Tuple[str, DSCBlockSpec]], img_hw: int, *,
                 img_ch: int = 3, head_ch: int = 128,
                 n_classes: int = 2) -> IRProgram:
    """A COMPLETE VWW inference: stem -> DSC chain -> head -> GAP -> FC.

    Weight binding convention (``cfu.network.vww_cfu_params``): params[0] =
    stem, params[1..N] = blocks, params[N+1] = head, params[N+2] = FC.
    """
    ir = IRProgram(ops=[], values={}, in_value="img", out_value="logits",
                   network="vww",
                   extra_meta={"head_ch": head_ch, "n_classes": n_classes})
    c0 = specs[0][1].cin
    sh = sw = -(-img_hw // 2)
    ir.add_value(Value("img", (img_hw, img_hw, img_ch),
                       def_idx=-1, last_use=0))
    ir.add_value(Value("y@stem", (sh, sw, c0), def_idx=0, last_use=0))
    ir.ops.append(Conv3x3(name="stem", inputs=["img"], outputs=["y@stem"],
                          param_idx=0, cin=img_ch, cout=c0,
                          h=img_hw, w=img_hw, stride=2))
    prev, h, w = _append_chain(ir, specs, "y@stem", sh, sw, param_base=1)
    c_last = specs[-1][1].cout
    oi = len(ir.ops)
    ir.add_value(Value("y@head", (h, w, head_ch), def_idx=oi, last_use=oi))
    ir.ops.append(Head1x1(name="head", inputs=[prev], outputs=["y@head"],
                          param_idx=len(specs) + 1, cin=c_last,
                          cout=head_ch, h=h, w=w))
    _use(ir, prev, oi)
    oi = len(ir.ops)
    ir.add_value(Value("pooled", (head_ch,), def_idx=oi, last_use=oi + 1,
                       port_resident=True))
    ir.ops.append(GAP(name="gap", inputs=["y@head"], outputs=["pooled"],
                      param_idx=len(specs) + 2, ch=head_ch, h=h, w=w))
    _use(ir, "y@head", oi)
    oi = len(ir.ops)
    ir.add_value(Value("logits", (n_classes,), def_idx=oi, last_use=None))
    ir.ops.append(FC(name="fc", inputs=["pooled"], outputs=["logits"],
                     param_idx=len(specs) + 2, cin=head_ch, cout=n_classes))
    _use(ir, "pooled", oi)
    return ir


# ---------------------------------------------------------------------------
# Layout: the planner's output record (and the legacy construction shim)
# ---------------------------------------------------------------------------


class MemoryPlanError(ValueError):
    """Two simultaneously-live regions overlap (or a plan is inconsistent)."""


@dataclasses.dataclass(frozen=True)
class Region:
    name: str
    space: int          # isa.SPACE_DRAM | isa.SPACE_SRAM
    base: int
    size: int

    def overlaps(self, other: "Region") -> bool:
        return (self.space == other.space and self.size and other.size
                and self.base < other.base + other.size
                and other.base < self.base + self.size)


#: Suffix of the pong copy a double-buffered boundary region gets in the
#: plan (the ping copy keeps the value's own name).
PONG_SUFFIX = "~pong"


@dataclasses.dataclass
class Layout:
    """Where the compiler placed every feature map.

    ``regions`` keeps EVERY region ever placed (the executor binds IO maps
    by name after the run); ``live`` tracks which are currently allocated.
    ``add`` raises :class:`MemoryPlanError` when the new region overlaps a
    *live* one — address reuse is legal only after an explicit ``free``
    (which is how the planner encodes disjoint lifetimes).

    ``dbuf`` maps a double-buffered boundary value's name to its *pong*
    region (the ping copy is ``regions[name]``): multi-stream compilation
    plans every inter-core boundary map twice, so a producer core can fill
    one copy while the consumer core drains the other.
    """

    regions: Dict[str, Region] = dataclasses.field(default_factory=dict)
    dram_size: int = 0
    sram_size: int = 0          # high-water mark across the program
    live: Dict[str, Region] = dataclasses.field(default_factory=dict)
    dbuf: Dict[str, Region] = dataclasses.field(default_factory=dict)

    def add(self, name: str, space: int, base: int, size: int) -> Region:
        r = Region(name, space, base, size)
        for other in self.live.values():
            if r.overlaps(other):
                raise MemoryPlanError(
                    f"region {name!r} [{base}, {base + size}) overlaps live "
                    f"region {other.name!r} [{other.base}, "
                    f"{other.base + other.size}) in "
                    f"{isa.SPACE_NAMES[space]}")
        self.regions[name] = r
        self.live[name] = r
        if space == isa.SPACE_DRAM:
            self.dram_size = max(self.dram_size, base + size)
        else:
            self.sram_size = max(self.sram_size, base + size)
        return r

    def free(self, name: str) -> None:
        self.live.pop(name, None)


class _SpaceAllocator:
    """First-fit free-list allocator for one memory space."""

    def __init__(self):
        self.holes: List[Tuple[int, int]] = []   # (base, size), sorted
        self.top = 0

    def alloc(self, size: int) -> int:
        if size == 0:
            return self.top
        for i, (base, hsize) in enumerate(self.holes):
            if hsize >= size:
                if hsize == size:
                    self.holes.pop(i)
                else:
                    self.holes[i] = (base + size, hsize - size)
                return base
        base, self.top = self.top, self.top + size
        return base

    def free(self, base: int, size: int) -> None:
        if size == 0:
            return
        self.holes.append((base, size))
        self.holes.sort()
        merged: List[Tuple[int, int]] = []
        for b, s in self.holes:
            if merged and merged[-1][0] + merged[-1][1] == b:
                merged[-1] = (merged[-1][0], merged[-1][1] + s)
            else:
                merged.append((b, s))
        # give the top back so the high-water mark is honest
        if merged and merged[-1][0] + merged[-1][1] == self.top:
            self.top = merged.pop()[0]
        self.holes = merged


def plan_memory(ir: IRProgram, *, pin_io: bool = False,
                dbuf_values: Sequence[str] = (),
                op_segments: Optional[Mapping[int, int]] = None) -> Layout:
    """Liveness-driven placement of every (non-port) value.

    Walks the op list in program order; at op *i* it first frees values
    whose ``last_use`` precedes *i*, then places values defined at *i*
    (program inputs are placed before op 0). Freed addresses are reused by
    a first-fit allocator, so the reported footprints are lifetime-aware
    high-water marks, not sums. ``pin_io=True`` keeps every *boundary*
    DRAM value (op inputs/outputs — never scheduler scratch, whose
    lifetime is one op on one core) live to the end: multi-stream
    compilation's boundary maps must survive the whole frame, each stream
    owning a different pipeline stage.

    ``dbuf_values`` names the *inter-core* boundary values (values whose
    producer and consumer live in different pipeline-stage segments, plus
    the host-facing program input/output): each gets TWO pinned regions —
    the ping copy under its own name and a pong copy under
    ``name + PONG_SUFFIX`` — recorded in ``Layout.dbuf``. Double-buffered
    values must be DRAM-resident non-scratch (they cross cores; a core's
    private SRAM cannot carry them) — anything else raises
    :class:`MemoryPlanError`.

    ``op_segments`` (op index -> pipeline-stage segment) switches DRAM
    scratch to *per-segment arena* placement for the shared-DRAM
    multi-core machine. Program-order liveness is WRONG there: every core
    re-executes its segment each round, so a hole freed by core A's
    scratch is concurrently relived while core B (or a pinned boundary
    copy placed later) occupies it. Scratch may therefore reuse holes
    only WITHIN its own segment's arena; the arenas sit above the pinned
    values and each other, so nothing a different core touches can ever
    alias. SRAM scratch keeps program-order reuse — SRAM is per-core
    private in the machine, so cross-segment address reuse is physical
    reality, not a hazard.
    """
    layout = Layout()
    allocs = {isa.SPACE_DRAM: _SpaceAllocator(),
              isa.SPACE_SRAM: _SpaceAllocator()}

    dbuf = set(dbuf_values)
    for name in dbuf:
        v = ir.values.get(name)
        if v is None:
            raise MemoryPlanError(f"dbuf value {name!r} not in the IR")
        if v.port_resident:
            raise MemoryPlanError(
                f"dbuf value {name!r} is port-resident (never in memory)")
        if v.space != isa.SPACE_DRAM or v.scratch:
            raise MemoryPlanError(
                f"dbuf value {name!r} must be a DRAM boundary map, not "
                f"{'scratch' if v.scratch else isa.SPACE_NAMES[v.space]}")

    vals = [v for v in ir.values.values() if not v.port_resident]

    def in_arena(v: Value) -> bool:
        return (op_segments is not None and v.scratch
                and v.space == isa.SPACE_DRAM)

    def last_use_of(v: Value) -> Optional[int]:
        # pin is a planning-time view only — the IR's liveness is not
        # mutated, so the same IRProgram can be re-planned either way
        if v.name in dbuf:
            return None                      # both copies live to the end
        if pin_io and v.space == isa.SPACE_DRAM and not v.scratch:
            return None
        return v.last_use

    def place(v: Value) -> None:
        layout.add(v.name, v.space, allocs[v.space].alloc(v.size), v.size)
        if v.name in dbuf:
            pong = layout.add(v.name + PONG_SUFFIX, v.space,
                              allocs[v.space].alloc(v.size), v.size)
            layout.dbuf[v.name] = pong

    by_def: Dict[int, List[Value]] = {}
    for v in vals:
        by_def.setdefault(v.def_idx, []).append(v)
    expiring: Dict[int, List[Value]] = {}
    for v in vals:
        lu = last_use_of(v)
        if lu is not None and not in_arena(v):
            expiring.setdefault(lu, []).append(v)

    for v in by_def.get(-1, []):
        place(v)
    for i in range(len(ir.ops)):
        for v in expiring.get(i - 1, []):
            r = layout.regions[v.name]
            layout.free(v.name)
            allocs[v.space].free(r.base, r.size)
        for v in by_def.get(i, []):
            if not in_arena(v):
                place(v)
    if op_segments is None:
        return layout

    # --- per-segment DRAM scratch arenas (shared-DRAM multi-core) --------
    base = layout.dram_size            # arenas sit above every pinned value
    segments = sorted(set(op_segments.values()))
    for seg in segments:
        arena = _SpaceAllocator()
        placed: List[Tuple[Value, int]] = []
        for i in range(len(ir.ops)):
            if op_segments.get(i) != seg:
                continue
            # scratch lifetime is its op: free the previous op's scratch
            # first so consecutive blocks of ONE core share the arena
            for v, off in list(placed):
                if v.last_use is not None and v.last_use < i:
                    r = layout.regions[v.name]
                    layout.free(v.name)
                    arena.free(r.base - base, r.size)
                    placed.remove((v, off))
            for v in by_def.get(i, []):
                if in_arena(v):
                    off = arena.alloc(v.size)
                    layout.add(v.name, v.space, base + off, v.size)
                    placed.append((v, off))
        base = layout.dram_size        # next core's arena: fresh addresses
    return layout
