"""Pass-based compiler: lower DSC chains and whole VWW networks to CFU
instruction streams.

The compiler is a pipeline of four passes over the program IR of
``cfu.ir`` (both entry points build IR and share every pass — the two
copy-pasted lowering paths of the old monolithic emitter are gone):

    build IR  ->  schedule  ->  memory-plan  ->  instruction-select

* **build** — ``ir.build_chain_ir`` (bare DSC chain) /
  ``ir.build_vww_ir`` (complete inference: stem 3x3 s2, bottleneck chain,
  head 1x1, GAP, FC) produce typed ops over named tensor values.
* **schedule** — ``assign_schedules`` annotates every ``DSCBlock`` with
  one of the five schedules (see ``ir.SCHEDULES``), accepting a uniform
  schedule, a per-block mapping, or ``AUTO_SCHEDULE`` (= ``"auto"``): a
  cost-model pick per block, driven by ``timing.analyze`` on a
  single-block compile of each candidate — the winning loop structure
  varies with layer geometry (cf. Daghero et al.), so the pick is per
  block, not per network. ``materialize_scratch`` then creates the
  schedule's buffers (F1/F2 maps for the layer schedules, the rolling F1
  strip for fused-rowtile) as IR values with single-op lifetimes.
* **memory-plan** — ``ir.plan_memory``: liveness-driven first-fit
  placement with buffer reuse and overlap checking (raises
  ``ir.MemoryPlanError`` on any live collision).
* **isel** — ``select_instructions`` emits the existing ISA per op; the
  GAP+FC pair is pattern-matched into the fused pooling->projection
  sequence (the pooled vector stays on the projection port and never
  touches memory).

Schedule lowering (per ``DSCBlock``):

* ``layer-dram`` / ``layer-sram`` — three full passes (expansion at input
  resolution, depthwise, projection), F1/F2 materialized in the planned
  scratch regions (paper Eq. 1 / Eq. 2 traffic).
* ``fused``      — the paper's pixel-wise dataflow: per output pixel
  LD_WIN -> EXP_MAC -> REQUANT F1 -> DW_MAC -> REQUANT F2 -> PROJ_MAC ->
  REQUANT OUT [-> RES_ADD] -> ST_PX; F1/F2 never reach a memory space.
* ``fused-rowtile`` — per tile of ``tile_rows`` output rows, the *new*
  strip rows are expanded once (LD_VEC -> EXP_MAC VEC -> REQUANT F1 ->
  ST_VEC into the CFG_STRIP rolling SRAM buffer), then depthwise +
  projection consume the strip per pixel (LD_TILE -> DW_MAC -> REQUANT F2
  -> PROJ_MAC -> REQUANT OUT [-> RES_ADD] -> ST_PX). Halo rows shared
  with the previous tile (two at stride 1, ONE at stride 2) are still
  resident in the strip and are reused, not recomputed — expansion runs
  exactly once per input row, and DRAM traffic equals the fused
  dataflow's exactly.
* ``fused-winograd`` — rowtile-shaped fusion over 2-row bands, but the
  depthwise stage runs on the exact-integer Winograd F(2x2,3x3) unit
  (``cfu.winograd``): CFG_WINO arms the tile grid, WINO_MAC computes an
  output pixel off its 2x2 tile (16 multiplies per tile = 4 per output
  vs the direct 9, bit-exact by construction — the compiler REFUSES any
  config whose folded transform could overflow int32). Stride-2 blocks
  fall back to ``fused`` at scheduling time.

Multi-stream compilation (``streams=N``): the op chain is partitioned
into N contiguous segments, one CFU core per segment, each core owning a
different pipeline stage of consecutive frames behind the shared DRAM
port. The partitioner balances per-core *time* under each core's own
``PEConfig`` (``pe_per_core``: explicit per-core configs, or
``"auto-hetero"`` — a search over a small allocation space under the
homogeneous total engine budget, e.g. a big core for the stem and a
small one for the tail, cf. Daghero et al., arXiv:2406.12478). Every
value that crosses a segment boundary (plus the host-facing program
input/output) is planned as an explicitly double-buffered region: the
planner allocates ping/pong copies (``ir.plan_memory(dbuf_values=...)``)
and the segment streams bind them with CFG_DBUF words, so a producer
core fills one copy while its consumer drains the other.
``executor.run_multistream`` runs the segments against one shared DRAM
image and *enforces* the handoff (reading a boundary copy before its
producer's round retired raises); ``timing.analyze_multistream`` models
the steady-state round interval (slowest core + its handoffs vs the
serialized DRAM port), the (N-1)-round fill, and frame-batched rounds.

Every stream opens with CFG_PE carrying its core's engine counts
(``timing.PEConfig``) and CFG_CORE carrying its pipeline-stage slot, so
a compiled stream is a *complete* description of the simulated hardware
point.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.cfu import ir as ir_mod
from repro_torch.cfu import isa
from repro_torch.cfu import winograd
from repro_torch.cfu.ir import (CFUSchedule, Conv3x3, DSCBlock, FC, GAP, Head1x1,
                                IRProgram, Layout, MemoryPlanError, Region,
                                SCHEDULES, build_chain_ir, build_vww_ir,
                                plan_memory)
from repro_torch.cfu.isa import Instr, Program
from repro_torch.cfu.timing import PEConfig

__all__ = [
    "CFUSchedule", "SCHEDULES", "AUTO_SCHEDULE", "AUTO_HETERO", "Layout",
    "Region", "MemoryPlanError", "MultiStreamProgram", "ScheduleSpec",
    "compile_block", "compile_network", "compile_vww_network",
    "assign_schedules", "auto_schedule", "materialize_scratch",
    "select_instructions", "estimate_block_cycles", "schedule_names",
    "split_pe_budget", "hetero_pe_candidates", "HETERO_FRACTIONS",
]

#: Compiler policy (not a schedule): pick the cheapest schedule per block.
AUTO_SCHEDULE = "auto"

ScheduleSpec = Union[CFUSchedule, str, Mapping[str, Union[CFUSchedule, str]]]


def schedule_names(include_auto: bool = False) -> List[str]:
    """Every schedule name, from the one registry (CLI choice lists)."""
    names = list(SCHEDULES)
    return names + [AUTO_SCHEDULE] if include_auto else names


def _resolve_one(s: Union[CFUSchedule, str]) -> CFUSchedule:
    if isinstance(s, CFUSchedule):
        return s
    try:
        return SCHEDULES[s][0]
    except KeyError:
        raise ValueError(f"unknown schedule {s!r}; known: "
                         f"{schedule_names(include_auto=True)}") from None


@dataclasses.dataclass
class MultiStreamProgram:
    """N per-core instruction streams sharing one DRAM plan.

    ``streams[i]`` is a complete ``Program`` for core *i* (its own CFG_PE,
    its own SRAM scratch, SET_BASEs into the shared DRAM layout).
    ``meta`` carries the shared layout and the program-level IO binding;
    per-segment bindings live in each stream's own meta.
    """

    streams: List[Program]
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return sum(len(s) for s in self.streams)


# ---------------------------------------------------------------------------
# Pass 1: scheduling
# ---------------------------------------------------------------------------


def estimate_block_cycles(spec, h: int, w: int, schedule: CFUSchedule,
                          pipeline: str = "v3",
                          pe: Optional[PEConfig] = None,
                          tile_rows: int = 4) -> float:
    """Cost model for the auto pass: cycles of one block compiled alone.

    A single-block compile under a *fixed* schedule, walked by
    ``timing.analyze`` — the exact machinery that times the final stream,
    so the pick can never disagree with the model it optimizes.
    """
    from repro_torch.cfu.timing import analyze
    prog = compile_block(spec, h, w, schedule, pe=pe, tile_rows=tile_rows)
    return analyze(prog, pipeline, pe=pe).total_cycles


def auto_schedule_costs(ir: IRProgram, *, pipeline: str = "v3",
                        pe: Optional[PEConfig] = None,
                        tile_rows: int = 4
                        ) -> Dict[str, Dict[CFUSchedule, float]]:
    """The per-block per-schedule cost table the auto pass optimizes.

    One row per DSC block, one candidate column per feasible schedule
    (infeasible candidates — e.g. a strip deeper than CFG_STRIP encodes —
    are simply absent), in ``CFUSchedule`` enum order. ``auto_schedule``
    takes the row-wise argmin of exactly this table, so surfacing it is
    the *why* of every auto pick (``doctor.explain_auto`` renders it)."""
    table: Dict[str, Dict[CFUSchedule, float]] = {}
    for op in ir.dsc_blocks():
        costs: Dict[CFUSchedule, float] = {}
        for s in CFUSchedule:
            try:
                costs[s] = estimate_block_cycles(
                    op.spec, op.h, op.w, s, pipeline=pipeline, pe=pe,
                    tile_rows=tile_rows)
            except ValueError:
                continue   # infeasible candidate (e.g. strip > 255 rows)
        table[op.name] = costs
    return table


def auto_schedule(ir: IRProgram, *, pipeline: str = "v3",
                  pe: Optional[PEConfig] = None,
                  tile_rows: int = 4) -> Dict[str, CFUSchedule]:
    """Cost-model schedule pick, independently per block (the row-wise
    argmin of ``auto_schedule_costs``; first minimum in enum order wins)."""
    table = auto_schedule_costs(ir, pipeline=pipeline, pe=pe,
                                tile_rows=tile_rows)
    return {name: min(costs, key=costs.get) for name, costs in table.items()}


def assign_schedules(ir: IRProgram, schedule: ScheduleSpec, *,
                     tile_rows: int = 4, pipeline: str = "v3",
                     pe: Optional[PEConfig] = None) -> None:
    """Annotate every DSCBlock op with its schedule (pass, mutates IR)."""
    if isinstance(schedule, str) and schedule == AUTO_SCHEDULE:
        mapping: Mapping[str, CFUSchedule] = auto_schedule(
            ir, pipeline=pipeline, pe=pe, tile_rows=tile_rows)
        for op in ir.dsc_blocks():
            op.schedule, op.tile_rows = mapping[op.name], tile_rows
    elif isinstance(schedule, Mapping):
        for op in ir.dsc_blocks():
            if op.name not in schedule:
                raise ValueError(f"no schedule given for block {op.name!r}")
            op.schedule = _resolve_one(schedule[op.name])
            op.tile_rows = tile_rows
    else:
        uniform = _resolve_one(schedule)
        for op in ir.dsc_blocks():
            op.schedule, op.tile_rows = uniform, tile_rows
    _winograd_fallback(ir)


def _winograd_fallback(ir: IRProgram) -> None:
    """F(2x2,3x3) covers stride-1 windows only: a stride-2 block asked to
    run fused-winograd falls back to the plain fused dataflow (same
    traffic, direct depthwise). Under ``auto`` the winograd candidate
    therefore *ties* fused on stride-2 blocks and the enum-order
    tie-break keeps fused — the fallback never changes an auto pick."""
    for op in ir.dsc_blocks():
        if op.schedule is CFUSchedule.FUSED_WINOGRAD and op.spec.stride != 1:
            op.schedule = CFUSchedule.FUSED


def _strip_rows(spec, tile_rows: int) -> int:
    """Rolling-strip depth: one tile's full input halo, (T-1)*s + 3 rows."""
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    rows = (tile_rows - 1) * spec.stride + isa.KERNEL
    if rows > 255:
        raise ValueError(f"tile_rows={tile_rows} needs a {rows}-row strip; "
                         "CFG_STRIP encodes at most 255")
    return rows


def materialize_scratch(ir: IRProgram) -> None:
    """Create each scheduled block's buffers as single-op-lifetime values."""
    for oi, op in enumerate(ir.ops):
        if not isinstance(op, DSCBlock):
            continue
        if op.schedule is None:
            raise ValueError(f"block {op.name!r} not scheduled; run "
                             "assign_schedules first")
        spec, bh, bw = op.spec, op.h, op.w
        h2, w2 = spec.out_hw(bh, bw)
        op.scratch = []
        if op.schedule in (CFUSchedule.LAYER_DRAM, CFUSchedule.LAYER_SRAM):
            space = (isa.SPACE_SRAM if op.schedule is CFUSchedule.LAYER_SRAM
                     else isa.SPACE_DRAM)
            for nm, shape in ((f"f1@{op.name}", (bh, bw, spec.cmid)),
                              (f"f2@{op.name}", (h2, w2, spec.cmid))):
                ir.add_value(ir_mod.Value(nm, shape, space=space,
                                          def_idx=oi, last_use=oi,
                                          scratch=True))
                op.scratch.append(nm)
        elif op.schedule is CFUSchedule.FUSED_ROWTILE:
            nm = f"f1strip@{op.name}"
            ir.add_value(ir_mod.Value(
                nm, (_strip_rows(spec, op.tile_rows), bw, spec.cmid),
                space=isa.SPACE_SRAM, def_idx=oi, last_use=oi,
                scratch=True))
            op.scratch.append(nm)
        elif op.schedule is CFUSchedule.FUSED_WINOGRAD:
            # one F(2x2,3x3) tile row's full input halo: 2*1 + 2 = 4 rows
            # (stride is 1 here — stride-2 blocks fell back to fused)
            nm = f"f1strip@{op.name}"
            ir.add_value(ir_mod.Value(
                nm, (winograd.WIN, bw, spec.cmid),
                space=isa.SPACE_SRAM, def_idx=oi, last_use=oi,
                scratch=True))
            op.scratch.append(nm)
        # FUSED: intermediates live only in the tile/vector registers.


# ---------------------------------------------------------------------------
# Pass 3: instruction selection
# ---------------------------------------------------------------------------


class _InstrSel:
    """Emit the ISA for a (scheduled, memory-planned) op sequence."""

    def __init__(self, layout: Layout, pe: Optional[PEConfig] = None):
        self.layout = layout
        self.pe = pe or PEConfig()
        self.instrs: List[Instr] = []
        self.phase = 0

    def emit(self, op: str, *args):
        self.instrs.append(Instr(op, tuple(args)))

    def bar(self):
        self.emit("BAR", self.phase % 256)
        self.phase += 1

    def region(self, name: str) -> Region:
        return self.layout.regions[name]

    def bind(self, reg: int, name: str):
        """Bind a base register to a planned region: SET_BASE for private
        regions, CFG_DBUF (ping+pong pair) for double-buffered inter-core
        boundary maps — the executing core resolves the pair against its
        frame parity."""
        r = self.region(name)
        pong = self.layout.dbuf.get(name)
        if pong is None:
            self.emit("SET_BASE", reg, r.space, r.base)
        else:
            self.emit("CFG_DBUF", reg, r.space, r.base, pong.base)

    # --- op lowering --------------------------------------------------------

    def op_conv3x3(self, op: Conv3x3):
        """3x3 stride-2 standard conv (the VWW stem) on the expansion
        array: same halo-aware LD_WIN gather as the depthwise windows."""
        h2, w2 = -(-op.h // op.stride), -(-op.w // op.stride)
        self.emit("CFG", op.cin, op.cout, op.cout, op.stride, op.h, op.w)
        self.bind(isa.REG_IN, op.inputs[0])
        self.bind(isa.REG_OUT, op.outputs[0])
        self.emit("LD_WGT", isa.WGT_CONV, op.param_idx)
        self.bar()
        for oy in range(h2):
            for ox in range(w2):
                self.emit("LD_WIN", oy, ox)
                self.emit("CONV_MAC")
                self.emit("REQUANT", isa.STAGE_F1)
                self.emit("ST_PX", oy, ox)

    def op_head1x1(self, op: Head1x1):
        """1x1 conv + ReLU6 (the classifier head) = EXP_MAC in VEC mode."""
        self.emit("CFG", op.cin, op.cout, op.cout, 1, op.h, op.w)
        self.bind(isa.REG_IN, op.inputs[0])
        self.bind(isa.REG_OUT, op.outputs[0])
        self.emit("LD_WGT", isa.WGT_EXP, op.param_idx)
        self.bar()
        for y in range(op.h):
            for x in range(op.w):
                self.emit("LD_VEC", isa.REG_IN, y, x)
                self.emit("EXP_MAC", isa.MODE_VEC)
                self.emit("REQUANT", isa.STAGE_F1)
                self.emit("ST_PX", y, x)

    def op_gap_fc(self, gap: GAP, fc: FC):
        """GAP + FC pattern-matched into one unit: the pooled vector lands
        on the projection port (GAP_FIN) and is consumed in place."""
        self.emit("CFG", gap.ch, gap.ch, fc.cout, 1, gap.h, gap.w)
        self.bind(isa.REG_IN, gap.inputs[0])
        self.bind(isa.REG_OUT, fc.outputs[0])
        self.emit("LD_WGT", isa.WGT_PROJ, fc.param_idx)
        self.bar()
        self.emit("GAP_RST")
        for y in range(gap.h):
            for x in range(gap.w):
                self.emit("LD_VEC", isa.REG_IN, y, x)
                self.emit("GAP_ACC")
        self.emit("GAP_FIN", gap.h * gap.w)
        self.emit("PROJ_MAC")
        self.emit("REQUANT", isa.STAGE_OUT)
        self.emit("ST_PX", 0, 0)

    def op_dsc_block(self, op: DSCBlock):
        assert op.spec.kernel == isa.KERNEL, "the CFU's depthwise is 3x3"
        spec, bh, bw = op.spec, op.h, op.w
        self.emit("CFG", spec.cin, spec.cmid, spec.cout, spec.stride, bh, bw)
        if op.schedule is CFUSchedule.FUSED_ROWTILE:
            self.emit("CFG_STRIP", _strip_rows(spec, op.tile_rows))
        elif op.schedule is CFUSchedule.FUSED_WINOGRAD:
            # exact-or-refuse: a config whose folded transform could
            # overflow int32 must not compile (differential policy)
            winograd.check_exact()
            h2, w2 = spec.out_hw(bh, bw)
            self.emit("CFG_STRIP", winograd.WIN)
            self.emit("CFG_WINO", -(-h2 // winograd.TILE),
                      -(-w2 // winograd.TILE), self.pe.shared_dw_pw)
        self.bind(isa.REG_IN, op.inputs[0])
        self.bind(isa.REG_OUT, op.outputs[0])
        if op.schedule in (CFUSchedule.FUSED_ROWTILE,
                           CFUSchedule.FUSED_WINOGRAD):
            self.bind(isa.REG_F1, op.scratch[0])
        for which in (isa.WGT_EXP, isa.WGT_DW, isa.WGT_PROJ):
            self.emit("LD_WGT", which, op.param_idx)
        if op.schedule is CFUSchedule.FUSED:
            self._dsc_fused(op)
        elif op.schedule is CFUSchedule.FUSED_ROWTILE:
            self._dsc_rowtile(op)
        elif op.schedule is CFUSchedule.FUSED_WINOGRAD:
            self._dsc_winograd(op)
        else:
            self._dsc_layer(op)

    def _dsc_fused(self, op: DSCBlock):
        """The paper's pixel-wise dataflow: one output pixel to completion;
        F1/F2 never reach a memory space."""
        spec = op.spec
        h2, w2 = spec.out_hw(op.h, op.w)
        self.bar()
        for oy in range(h2):
            for ox in range(w2):
                self.emit("LD_WIN", oy, ox)
                self.emit("EXP_MAC", isa.MODE_WIN)
                self.emit("REQUANT", isa.STAGE_F1)
                self.emit("DW_MAC")
                self.emit("REQUANT", isa.STAGE_F2)
                self.emit("PROJ_MAC")
                self.emit("REQUANT", isa.STAGE_OUT)
                if spec.has_residual:
                    self.emit("RES_ADD", oy, ox)
                self.emit("ST_PX", oy, ox)

    def _dsc_layer(self, op: DSCBlock):
        """Layer-by-layer: three passes over planned F1/F2 regions."""
        spec, bh, bw = op.spec, op.h, op.w
        h2, w2 = spec.out_hw(bh, bw)
        self.bind(isa.REG_F1, op.scratch[0])
        self.bind(isa.REG_F2, op.scratch[1])
        # pass 1: expansion at input resolution, F1 materialized
        self.bar()
        for y in range(bh):
            for x in range(bw):
                self.emit("LD_VEC", isa.REG_IN, y, x)
                self.emit("EXP_MAC", isa.MODE_VEC)
                self.emit("REQUANT", isa.STAGE_F1)
                self.emit("ST_VEC", isa.REG_F1, y, x)
        # pass 2: depthwise over the materialized F1, F2 materialized
        self.bar()
        for oy in range(h2):
            for ox in range(w2):
                self.emit("LD_TILE", isa.REG_F1, oy, ox)
                self.emit("DW_MAC")
                self.emit("REQUANT", isa.STAGE_F2)
                self.emit("ST_VEC", isa.REG_F2, oy, ox)
        # pass 3: projection (+ residual) to the block output
        self.bar()
        for oy in range(h2):
            for ox in range(w2):
                self.emit("LD_VEC", isa.REG_F2, oy, ox)
                self.emit("PROJ_MAC")
                self.emit("REQUANT", isa.STAGE_OUT)
                if spec.has_residual:
                    self.emit("RES_ADD", oy, ox)
                self.emit("ST_PX", oy, ox)

    def _dsc_winograd(self, op: DSCBlock):
        """Winograd F(2x2,3x3) row tiling: per band of TILE output rows,
        expand only the NEW strip rows (halo reuse exactly as rowtile —
        each input row once), then WINO_MAC computes each output pixel
        off its 2x2 tile (the tile's 16-multiply array runs once per
        tile, reused for the second row/column of the tile) and the
        unchanged REQUANT F2 -> PROJ_MAC tail finishes the pixel.
        Stride is 1 by construction (assign_schedules falls back)."""
        spec, bh, bw = op.spec, op.h, op.w
        h2, w2 = spec.out_hw(bh, bw)       # == (bh, bw) at stride 1
        rows_done = 0
        for r0 in range(0, h2, winograd.TILE):
            r1 = min(h2, r0 + winograd.TILE)
            # tiles at band r0 gather input rows r0-1 .. r0+2; rows past
            # the image are zero-point padding, never expanded
            need_hi = min(bh - 1, r1)
            self.bar()
            for y in range(rows_done, need_hi + 1):
                for x in range(bw):
                    self.emit("LD_VEC", isa.REG_IN, y, x)
                    self.emit("EXP_MAC", isa.MODE_VEC)
                    self.emit("REQUANT", isa.STAGE_F1)
                    self.emit("ST_VEC", isa.REG_F1, y, x)
            rows_done = max(rows_done, need_hi + 1)
            self.bar()
            for oy in range(r0, r1):
                for ox in range(w2):
                    self.emit("WINO_MAC", oy, ox)
                    self.emit("REQUANT", isa.STAGE_F2)
                    self.emit("PROJ_MAC")
                    self.emit("REQUANT", isa.STAGE_OUT)
                    if spec.has_residual:
                        self.emit("RES_ADD", oy, ox)
                    self.emit("ST_PX", oy, ox)

    def _dsc_rowtile(self, op: DSCBlock):
        """Row-tile fusion with halo reuse: per tile, expand only the strip
        rows not already resident (each input row exactly once), then
        depthwise+projection consume the rolling strip per pixel."""
        spec, bh, bw = op.spec, op.h, op.w
        h2, w2 = spec.out_hw(bh, bw)
        s, t = spec.stride, op.tile_rows
        rows_done = 0                    # input rows already expanded
        for r0 in range(0, h2, t):
            r1 = min(h2, r0 + t)
            need_hi = min(bh - 1, (r1 - 1) * s + 1)   # last halo row needed
            self.bar()
            for y in range(rows_done, need_hi + 1):   # NEW rows only: the
                for x in range(bw):                   # tile halo is reused
                    self.emit("LD_VEC", isa.REG_IN, y, x)
                    self.emit("EXP_MAC", isa.MODE_VEC)
                    self.emit("REQUANT", isa.STAGE_F1)
                    self.emit("ST_VEC", isa.REG_F1, y, x)
            rows_done = max(rows_done, need_hi + 1)
            self.bar()
            for oy in range(r0, r1):
                for ox in range(w2):
                    self.emit("LD_TILE", isa.REG_F1, oy, ox)
                    self.emit("DW_MAC")
                    self.emit("REQUANT", isa.STAGE_F2)
                    self.emit("PROJ_MAC")
                    self.emit("REQUANT", isa.STAGE_OUT)
                    if spec.has_residual:
                        self.emit("RES_ADD", oy, ox)
                    self.emit("ST_PX", oy, ox)


def select_instructions(ops: Sequence[ir_mod.Op], layout: Layout,
                        pe: PEConfig,
                        core: Optional[Tuple[int, int]] = None) -> List[Instr]:
    """Lower a (contiguous) op sequence to one instruction stream.

    ``core=(i, n)`` stamps the stream with its pipeline-stage slot
    (CFG_CORE) — multi-stream segments are self-describing."""
    sel = _InstrSel(layout, pe)
    sel.emit("CFG_PE", pe.exp_pes, pe.dw_lanes, pe.proj_engines)
    if core is not None:
        sel.emit("CFG_CORE", core[0], core[1])
    i = 0
    while i < len(ops):
        op = ops[i]
        if isinstance(op, GAP):
            if not (i + 1 < len(ops) and isinstance(ops[i + 1], FC)):
                raise NotImplementedError(
                    "GAP must be immediately followed by FC (the pooled "
                    "vector is port-resident)")
            sel.op_gap_fc(op, ops[i + 1])
            i += 2
            continue
        if isinstance(op, DSCBlock):
            sel.op_dsc_block(op)
        elif isinstance(op, Conv3x3):
            sel.op_conv3x3(op)
        elif isinstance(op, Head1x1):
            sel.op_head1x1(op)
        else:
            raise NotImplementedError(f"no lowering for {type(op).__name__}")
        i += 1
    sel.emit("HALT")
    return sel.instrs


# ---------------------------------------------------------------------------
# Pass 4: multi-stream partitioning
# ---------------------------------------------------------------------------


def _partition_units(ops: Sequence[ir_mod.Op]) -> List[List[ir_mod.Op]]:
    """Indivisible scheduling units: every op alone, except GAP+FC."""
    units: List[List[ir_mod.Op]] = []
    i = 0
    while i < len(ops):
        if isinstance(ops[i], GAP) and i + 1 < len(ops) \
                and isinstance(ops[i + 1], FC):
            units.append([ops[i], ops[i + 1]])
            i += 2
        else:
            units.append([ops[i]])
            i += 1
    return units


class _UnitCosts:
    """Per-(unit, PEConfig) timing of units compiled alone against the
    real layout. Units compile ONCE; each PE design point is a pure
    ``timing.analyze(pe=...)`` re-walk (engine counts shape time, never
    the stream), so the auto-hetero search costs walks, not compiles."""

    def __init__(self, units: List[List[ir_mod.Op]], layout: Layout,
                 pipeline: str):
        base = PEConfig()
        self.progs = [Program(select_instructions(u, layout, base),
                              meta={"layout": layout}) for u in units]
        self.pipeline = pipeline
        self._cache: Dict[Tuple[int, PEConfig], float] = {}
        from repro_torch.cfu.timing import analyze
        # the serialized-DRAM-port term is PE-independent
        self.port_cycles = [analyze(p, pipeline).dram_transfer_cycles
                            for p in self.progs]

    def cycles(self, ui: int, pe: PEConfig) -> float:
        key = (ui, pe)
        if key not in self._cache:
            from repro_torch.cfu.timing import analyze
            self._cache[key] = analyze(self.progs[ui], self.pipeline,
                                       pe=pe).total_cycles
        return self._cache[key]


def _balanced_partition(cost_rows: List[List[float]], n: int) -> List[int]:
    """Contiguous min-max partition (DP); returns segment sizes.

    ``cost_rows[c][u]`` is unit *u*'s cycles on core *c* — the
    heterogeneity-aware form: each candidate segment is priced under the
    PE config of the core that would own it (cores are in pipeline-stage
    order, so segment *c* always lands on core *c*). Homogeneous configs
    are the special case of identical rows.
    """
    n_units = len(cost_rows[0])
    n = min(n, n_units)
    prefixes = []
    for row in cost_rows[:n]:
        prefix = [0.0]
        for c in row:
            prefix.append(prefix[-1] + c)
        prefixes.append(prefix)
    INF = float("inf")
    # best[k][i] = minimal max-segment-cost splitting units[:i] into k
    # parts, segment k-1 priced on core k-1
    best = [[INF] * (n_units + 1) for _ in range(n + 1)]
    cut = [[0] * (n_units + 1) for _ in range(n + 1)]
    best[0][0] = 0.0
    for k in range(1, n + 1):
        pre = prefixes[k - 1]
        for i in range(k, n_units + 1):
            for j in range(k - 1, i):
                cand = max(best[k - 1][j], pre[i] - pre[j])
                if cand < best[k][i]:
                    best[k][i], cut[k][i] = cand, j
    sizes: List[int] = []
    i = n_units
    for k in range(n, 0, -1):
        j = cut[k][i]
        sizes.append(i - j)
        i = j
    return sizes[::-1]


# --- per-core PE allocation (heterogeneous frame pipeline) -------------------

#: Compiler policy: search a small per-core PE-allocation space under the
#: homogeneous configuration's total engine budget.
AUTO_HETERO = "auto-hetero"

#: Per-core budget shares the auto-hetero search draws from.
HETERO_FRACTIONS = (0.5, 0.75, 1.0, 1.25, 1.5)


def split_pe_budget(total: Tuple[int, int, int],
                    fractions: Sequence[float],
                    shared_dw_pw: int = 0) -> List[PEConfig]:
    """Split a total engine budget into per-core ``PEConfig``s, exactly.

    ``total`` is the (exp_pes, dw_lanes, proj_engines) engine budget summed
    over the cores; ``fractions`` the per-core shares. Every axis is split
    by largest remainder with a floor of one engine, so the per-core
    counts of every axis sum to the budget EXACTLY — heterogeneous
    configurations produced this way have the same total MACs as the
    homogeneous split they compete with.
    """
    n = len(fractions)
    if any(f <= 0 for f in fractions):
        raise ValueError(f"fractions must be positive, got {fractions}")
    out_axes: List[List[int]] = []
    for axis_total in total:
        if axis_total < n:
            raise ValueError(f"cannot split {axis_total} engines over "
                             f"{n} cores (each needs >= 1)")
        s = sum(fractions)
        shares = [axis_total * f / s for f in fractions]
        counts = [max(1, int(x)) for x in shares]
        # largest-remainder top-up / trim to hit the budget exactly
        while sum(counts) < axis_total:
            rema = [(shares[i] - counts[i], i) for i in range(n)]
            counts[max(rema)[1]] += 1
        while sum(counts) > axis_total:
            rema = [(shares[i] - counts[i], i) for i in range(n)
                    if counts[i] > 1]
            counts[min(rema)[1]] -= 1
        out_axes.append(counts)
    return [PEConfig(out_axes[0][i], out_axes[1][i], out_axes[2][i],
                     shared_dw_pw=shared_dw_pw)
            for i in range(n)]


def hetero_pe_candidates(n: int,
                         base_pe: Optional[PEConfig] = None
                         ) -> List[List[PEConfig]]:
    """The auto-hetero search space: per-core allocations of the
    homogeneous total budget (``n x base_pe``).

    Candidates are monotone share profiles (big-stem..small-tail and the
    reverse) drawn from ``HETERO_FRACTIONS`` and summing to ``n`` — a
    deliberately small space (the partitioner adapts segment sizes to the
    allocation, so fine-grained shares buy little). The HOMOGENEOUS
    allocation is always candidate 0, which is what makes the searched
    pick provably never worse than homogeneous under the model.
    """
    base_pe = base_pe or PEConfig()
    total = (base_pe.exp_pes * n, base_pe.dw_lanes * n,
             base_pe.proj_engines * n)

    profiles: List[Tuple[float, ...]] = [(1.0,) * n]

    def grow(prefix: Tuple[float, ...]):
        if len(prefix) == n:
            if abs(sum(prefix) - n) < 1e-9 and prefix not in profiles:
                profiles.append(prefix)
            return
        for f in HETERO_FRACTIONS:
            if not prefix or f <= prefix[-1]:      # non-increasing
                grow(prefix + (f,))

    grow(())
    # the reversed (ascending) profiles too: sometimes the tail is heavy
    for p in list(profiles[1:]):
        rp = tuple(reversed(p))
        if rp not in profiles:
            profiles.append(rp)
    out = []
    for p in profiles:
        try:
            out.append(split_pe_budget(total, p,
                                       shared_dw_pw=base_pe.shared_dw_pw))
        except ValueError:
            continue       # budget too small for this share profile
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _schedule_meta(ir: IRProgram, schedule: ScheduleSpec):
    blocks = ir.dsc_blocks()
    names = {op.schedule.value for op in blocks}
    label = (AUTO_SCHEDULE
             if isinstance(schedule, str) and schedule == AUTO_SCHEDULE
             else (names.pop() if len(names) == 1 else "mixed"))
    return label, {op.name: op.schedule.value for op in blocks}


def _boundary_values(ir: IRProgram,
                     op_seg: Mapping[int, int]) -> List[str]:
    """Values that cross a pipeline-stage boundary: produced and consumed
    in different segments, or host-facing (the program input arrives from
    outside; the program output is drained by the host). These are the
    maps the planner double-buffers."""
    consumers: Dict[str, List[int]] = {}
    for oi, op in enumerate(ir.ops):
        for nm in op.inputs:
            consumers.setdefault(nm, []).append(oi)
    names: List[str] = []
    for v in ir.values.values():
        if v.port_resident or v.scratch:
            continue
        prod = op_seg[v.def_idx] if v.def_idx >= 0 else None   # None = host
        cons = {op_seg[oi] for oi in consumers.get(v.name, ())}
        host_out = v.last_use is None
        if prod is None or host_out or any(c != prod for c in cons):
            names.append(v.name)
    return names


def _resolve_pe_per_core(pe_per_core, pe: PEConfig, n: int,
                         streams_requested: int) -> Optional[List[PEConfig]]:
    """Normalize the ``pe_per_core`` argument to a list of n PEConfigs
    (or None for the auto-hetero search)."""
    if pe_per_core is None:
        return [pe] * n
    if isinstance(pe_per_core, str):
        if pe_per_core != AUTO_HETERO:
            raise ValueError(f"pe_per_core must be a sequence of PEConfigs "
                             f"or {AUTO_HETERO!r}, got {pe_per_core!r}")
        return None
    pes = []
    for p in pe_per_core:
        if isinstance(p, PEConfig):
            pes.append(p)
        elif isinstance(p, str):
            pes.append(PEConfig(*(int(t) for t in p.split(","))))
        else:
            pes.append(PEConfig(*p))
    if len(pes) != streams_requested:
        raise ValueError(f"pe_per_core has {len(pes)} entries for "
                         f"{streams_requested} streams")
    if n < streams_requested:
        # truncating an EXPLICIT allocation would silently drop engine
        # budget from the modeled machine; make the caller decide
        raise ValueError(
            f"only {n} schedulable units for {streams_requested} "
            f"requested streams: an explicit pe_per_core cannot be "
            f"honored (use auto-hetero or fewer streams)")
    return pes


def _compile_ir(ir: IRProgram, schedule: ScheduleSpec,
                pe: Optional[PEConfig], *, streams: int = 1,
                pe_per_core=None, tile_rows: int = 4, pipeline: str = "v3",
                protect: bool = False):
    pe = pe or PEConfig()
    # ``protect`` arms instruction-word parity in the stream meta (the
    # encoder stamps bit 0, the executor verifies — see isa docstring);
    # weight/activation checksum words additionally need the params
    # records, so they are stamped post-compile by faults.protect_program.
    prot = {"parity": True} if protect else {}
    assign_schedules(ir, schedule, tile_rows=tile_rows,
                     pipeline=pipeline, pe=pe)
    materialize_scratch(ir)
    label, block_schedules = _schedule_meta(ir, schedule)

    def meta_for(ops_seg, layout, extra):
        first, last = ops_seg[0], ops_seg[-1]
        v_in, v_out = (ir.value_of(first.inputs[0]),
                       ir.value_of(last.outputs[0]))
        m = {
            "schedule": label,
            "block_schedules": block_schedules,
            "layout": layout,
            "blocks": [(op.name, op.spec, op.h, op.w)
                       for op in ops_seg if isinstance(op, DSCBlock)],
            "pe": pe,
            "in_region": v_in.name, "in_shape": v_in.shape,
            "out_region": v_out.name, "out_shape": v_out.shape,
        }
        if ir.network:
            m["network"] = ir.network
            m.update(ir.extra_meta)
        m.update(extra)
        return m

    if streams <= 1:
        if pe_per_core is not None:
            raise ValueError("pe_per_core needs streams > 1")
        layout = plan_memory(ir)
        instrs = select_instructions(ir.ops, layout, pe)
        return Program(instrs, meta=meta_for(ir.ops, layout, dict(prot)))

    # --- choose per-core PEs + the time-balanced contiguous partition ----
    # (costed against a provisional pinned layout; engine counts never
    # change the stream, so PE candidates are analyze() re-walks)
    prov = plan_memory(ir, pin_io=True)
    units = _partition_units(ir.ops)
    n = min(streams, len(units))
    uc = _UnitCosts(units, prov, pipeline)
    port = sum(uc.port_cycles)
    n_units = len(units)

    def rows_for(pes: List[PEConfig]) -> List[List[float]]:
        return [[uc.cycles(u, p) for u in range(n_units)] for p in pes]

    def score(rows: List[List[float]], sizes: List[int]) -> float:
        worst, at = 0.0, 0
        for c, sz in enumerate(sizes):
            worst = max(worst, sum(rows[c][at:at + sz]))
            at += sz
        return max(worst, port)       # est. steady-state interval

    pes = _resolve_pe_per_core(pe_per_core, pe, n, streams)
    if pes is None:                   # auto-hetero: searched allocation
        best = None
        for cand in hetero_pe_candidates(n, pe):
            rows = rows_for(cand)
            sizes = _balanced_partition(rows, n)
            s = score(rows, sizes)
            # strict <: candidate 0 is homogeneous, so ties keep it and
            # the pick is never worse than homogeneous under the model
            if best is None or s < best[0]:
                best = (s, cand, rows, sizes)
        _, pes, rows, sizes = best
    else:
        rows = rows_for(pes)
        sizes = _balanced_partition(rows, n)

    # --- double-buffer the inter-core boundaries, then lower segments ----
    op_seg: Dict[int, int] = {}
    oi, at = 0, 0
    for si, size in enumerate(sizes):      # units cover ir.ops in order
        for u in units[at:at + size]:
            for _ in u:
                op_seg[oi] = si
                oi += 1
        at += size
    boundaries = _boundary_values(ir, op_seg)
    layout = plan_memory(ir, pin_io=True, dbuf_values=boundaries,
                         op_segments=op_seg)

    progs: List[Program] = []
    partition: List[List[str]] = []
    at = 0
    for si, size in enumerate(sizes):
        seg_ops = [op for u in units[at:at + size] for op in u]
        progs.append(Program(
            select_instructions(seg_ops, layout, pes[si],
                                core=(si, len(sizes))),
            meta=meta_for(seg_ops, layout, {
                "stream": si, "pe": pes[si],
                "est_cycles": sum(rows[si][at:at + size]), **prot})))
        partition.append([op.name for op in seg_ops])
        at += size
    return MultiStreamProgram(progs, meta=meta_for(ir.ops, layout, {
        "streams": len(progs),             # actual core count (may clamp:
        "streams_requested": streams,      # at most one unit per core)
        "partition": partition,
        "pe_per_core": pes,
        "hetero": len(set(pes)) > 1,
        "boundaries": boundaries, **prot}))


def compile_network(specs: Sequence[Tuple[str, "DSCBlockSpec"]],
                    h: int, w: int,
                    schedule: ScheduleSpec,
                    pe: Optional[PEConfig] = None, *,
                    streams: int = 1, pe_per_core=None,
                    tile_rows: int = 4,
                    pipeline: str = "v3",
                    protect: bool = False):
    """Lower a chain of DSC blocks into CFU instruction stream(s).

    ``schedule`` is a uniform schedule (enum or registry name), a
    per-block ``{name: schedule}`` mapping, or ``"auto"`` (cost-model pick
    per block). ``streams=N`` partitions the chain across N CFU cores
    sharing the DRAM port and returns a :class:`MultiStreamProgram`
    whose inter-core boundary maps are double-buffered (ping/pong).

    ``pe_per_core`` makes the frame pipeline heterogeneous: a sequence of
    N ``PEConfig``s (or ``"E,D,P"`` strings), one per core in pipeline
    order, or ``"auto-hetero"`` to search a small allocation space under
    the homogeneous total engine budget (``N x pe``). The partitioner
    balances per-core *time* under each core's own engine counts either
    way.

    ``protect=True`` arms instruction-word parity (``meta["parity"]``):
    the encoder stamps an even-parity bit into bit 0 of every word and
    the executor verifies before decoding. Weight/activation checksum
    words ride on top via ``faults.protect_program`` (they need the
    params records, which the compiler never sees).
    """
    ir = build_chain_ir(specs, h, w)
    return _compile_ir(ir, schedule, pe, streams=streams,
                       pe_per_core=pe_per_core,
                       tile_rows=tile_rows, pipeline=pipeline,
                       protect=protect)


def compile_block(spec, h: int, w: int, schedule: ScheduleSpec,
                  name: str = "b0", pe: Optional[PEConfig] = None, *,
                  tile_rows: int = 4, protect: bool = False) -> Program:
    """Lower a single block (convenience wrapper over compile_network)."""
    return compile_network([(name, spec)], h, w, schedule, pe=pe,
                           tile_rows=tile_rows, protect=protect)


def compile_vww_network(specs: Sequence[Tuple[str, "DSCBlockSpec"]],
                        img_hw: int,
                        schedule: ScheduleSpec,
                        *,
                        img_ch: int = 3,
                        head_ch: int = 128,
                        n_classes: int = 2,
                        pe: Optional[PEConfig] = None,
                        streams: int = 1, pe_per_core=None,
                        tile_rows: int = 4,
                        pipeline: str = "v3",
                        protect: bool = False):
    """Lower a COMPLETE VWW inference: stem -> DSC chain -> head -> GAP+FC.

    ``specs`` is the bottleneck chain (``models.mobilenetv2.block_specs``);
    the stem downsamples the (img_hw, img_hw, img_ch) image by 2 into the
    chain's cin channels. Weight binding: params[0]=stem, params[1..N]=
    blocks, params[N+1]=head, params[N+2]=FC. Accepts the same
    ``schedule``/``streams``/``pe_per_core`` forms as
    :func:`compile_network`.
    """
    ir = build_vww_ir(specs, img_hw, img_ch=img_ch, head_ch=head_ch,
                      n_classes=n_classes)
    return _compile_ir(ir, schedule, pe, streams=streams,
                       pe_per_core=pe_per_core,
                       tile_rows=tile_rows, pipeline=pipeline,
                       protect=protect)
