"""Cycle + energy model of the CFU, driven by the instruction stream.

The model walks a compiled ``Program`` (no data needed — every address is
statically determined by CFG/SET_BASE + the pixel coordinates in the
instructions) and produces cycles, byte traffic per memory space, MAC
counts and energy.

Cycle model
-----------
Per-pixel datapath costs reuse the CALIBRATED per-stage constants of
``core.fusion`` (C_EX_PER_IN_CH etc., solved from the paper's published
Table III(A) cycle counts), so the FUSED stream under v1/v2/v3 pipelining
reproduces ``core.fusion.modeled_cycles`` — and therefore the paper's
27.4x/46.3x/59.3x progression — by construction of the same constants,
not by copying the totals: this model derives them from the instruction
stream. Pipelining modes:

* ``v1`` — sequential: pixel cycles = sum of stage costs + fixed overhead;
* ``v2`` — inter-stage: II = max(Ex, Dw, Pr stage groups) + fixed;
* ``v3`` — intra-stage (MAC/Quantize split): II = max of the five substage
  costs + fixed;

plus 2 (v2) / 4 (v3) pipeline-fill iterations per multi-stage phase.
Layer-by-layer passes have single-stage iterations, so all modes coincide
there (there is nothing to overlap across stages that live in different
passes — exactly why the paper fuses).

Memory-port model
-----------------
Each phase (BAR-delimited) overlaps compute with its DMA traffic:
``phase_cycles = max(compute, transfer)`` — the exposed difference is the
memory-port stall. Port costs:

* DRAM: ``CYC_PER_DRAM_BYTE`` = 45.6 cycles/byte, the paper's own measured
  software-managed transfer cost (Table VI: 14.0M cycles / 307200 B) — in
  this system the scalar core mediates all off-chip traffic (it is a CFU,
  not a DMA master).
* SRAM: 1 byte/cycle single-port scratch.
* Weights are boot-time resident in the CFU's weight buffers (loaded once,
  amortized over frames): LD_WGT contributes *traffic bytes* (they are
  moved, and ``core.traffic.weight_bytes`` counts them) but no per-frame
  stall cycles.

Reads use line-buffered unique-byte accounting: within one stream of one
phase, every map byte is fetched from its memory space at most once (the
standard 2-row line buffer of a 3x3 windowing engine); the residual port
is a separate stream, so a residual block re-reads its input exactly as
``core.traffic.io_bytes`` assumes. This makes the measured bytes equal the
analytic Eq. 1/2 counts EXACTLY (asserted in tests/test_cfu.py).

Energy model
------------
Eyeriss-style op pricing shared with ``benchmarks/bench_energy.py`` (the
constants are defined here and imported there): every MAC and every byte
at its hierarchy level. Unlike the analytic table, the MAC count here is
the *executed* count, so the FUSED schedule honestly pays its 9x expansion
recompute (the paper's No-Local-Reuse trade).

Multi-PE model
--------------
``PEConfig`` parameterizes the engine counts whose paper values the
calibrated constants embody: 9 expansion window engines (one per 3x3 tap,
each an 8-way MAC tree), 9 depthwise lanes, 56 output-stationary
projection engines. MAC-stage latencies scale inversely with the engine
count relative to that baseline (half the engines -> twice the stage
time; PE-array sizing as the first-order area/throughput knob, cf. Bai et
al., arXiv:1809.01536); the projection stage keeps its exact
``ceil(cout / proj_engines)`` group count. Requantize-stage costs do NOT
scale — the quantize units are per-pipeline, not per-engine — so v3
speedup saturates once a MAC stage drops below its requant stage:
over-provisioned arrays buy nothing, which is exactly the knee the
``benchmarks/bench_scaling.py`` sweep measures. The engine counts ride in
the stream itself (the CFG_PE word); ``analyze(pe=...)`` can override
them without recompiling.

Full-network opcodes: CONV_MAC (the stem's 3x3 standard conv) runs on the
expansion array at WIN-mode cost; GAP_ACC/GAP_FIN run on the vector
post-processing path (8-lane adds, then one per-channel divide).

Rowtile + multi-stream
----------------------
``CFG_STRIP`` puts F1 reads/writes into rolling-strip addressing (row mod
strip depth), mirroring the executor, so the fused-rowtile schedule's
SRAM strip traffic is metered against the strip buffer, not a full map.
``analyze_multistream`` models N cores running the segments of a
``compiler.MultiStreamProgram`` on *consecutive frames*; the shared
off-chip port serializes across cores, and ``dram_transfer_cycles``
(tracked per phase) is what it arbitrates. The static-energy term
``E_LEAK_PER_PE_CYCLE`` charges every engine for every cycle, which is
what gives the energy-vs-PE sweep its minimum.

Heterogeneous frame pipeline + batching
---------------------------------------
The multi-stream model is no longer pure port contention:

* **Per-core PE configs** — each stream's CFG_PE word may differ (the
  compiler's heterogeneity-aware partitioner balances per-core *time*
  under each core's own engine counts), so ``analyze_multistream`` walks
  each stream under its own configuration unless ``pe=`` overrides all.
* **Buffer handoff** — every double-buffered boundary a core touches
  (its CFG_DBUF words) costs ``HANDOFF_SYNC_CYCLES`` per round: the
  ping/pong swap plus the ready-flag check against the neighbour core.
  A core's round time is ``total_cycles + handoff_cycles``.
* **Frame batching** — ``analyze(batch=B)`` prices one stream driving B
  frames in lockstep: per-iteration compute and all byte traffic scale
  with B, but each phase's *pipeline-fill* cycles are paid once per phase
  (the fill is a property of the stream, not of the data plane), so
  batching amortizes fill — exactly what the batched executor does.
* **Fill/drain** — the report separates the steady-state initiation
  interval ``max(slowest round, serialized DRAM port)`` from the
  ``(N-1)·interval`` pipeline fill; ``cycles_for_frames(F)`` composes
  them, and ``frames_per_cycle`` / ``energy_per_frame_pj`` are the
  steady-state throughput and per-frame energy the benchmarks sweep.

Batch-cost API + SRAM port width
--------------------------------
The instruction walk is batch-independent, so ``BatchCostModel`` /
``MultiStreamCostModel`` walk once and price ANY batch from the cached
phases — ``analyze``/``analyze_multistream`` delegate to them, and the
request-level serving simulator (``cfu.serve``) prices thousands of
dispatched batches against them at event-loop speed. The scratch port
is parameterized (``sram_port_bytes``, default the paper's 1 B/cycle —
golden numbers byte-identical): a W-byte port divides SRAM transfer
cycles by W without touching byte counts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.cfu import isa
from repro_torch.cfu import winograd
from repro_torch.cfu.isa import Program
from repro_torch.cfu.trace import CAT_PHASE, CounterBank, Tracer
from repro_torch.core.fusion import (C_DW, C_DWQ, C_EX_PER_IN_CH, C_EXQ, C_PR,
                                     C_PX_FIXED, PROJECTION_ENGINES,
                                     SW_CYCLES_PER_XFER_BYTE)

# Memory-port costs (cycles per byte), see module docstring.
CYC_PER_DRAM_BYTE = SW_CYCLES_PER_XFER_BYTE     # CPU-mediated off-chip port
# On-chip scratch port width in bytes per cycle. The paper's scratch is a
# single-port byte-wide SRAM (1 B/cycle); ``analyze(sram_port_bytes=W)``
# prices a W-byte port instead (SRAM transfer cycles = bytes / W). The
# default keeps every golden cycle number byte-identical: 1/1 == 1.0 and
# the walker multiplies by exactly that constant.
SRAM_PORT_BYTES = 1
CYC_PER_SRAM_BYTE = 1.0 / SRAM_PORT_BYTES       # derived: default port

# pJ per op / per byte (Horowitz ISSCC'14-derived, int8, ~28-40 nm class).
# Canonical definitions — benchmarks/bench_energy.py imports these.
E_MAC_INT8 = 0.2          # pJ per int8 MAC
E_SRAM_BYTE = 1.25        # pJ per byte, large on-chip SRAM
E_RF_BYTE = 0.1           # pJ per byte, register file / pipeline regs
E_DRAM_BYTE = 160.0       # pJ per byte, off-chip DRAM
# Static (leakage + clock-tree) power per engine: charged for every cycle
# the array exists, whether or not it is busy. This is what bends the
# energy-vs-PE curve: a bigger array finishes sooner but leaks wider, a
# smaller one leaks narrower but longer — the minimum sits near the
# balanced design point (benchmarks/bench_scaling.py sweeps it).
E_LEAK_PER_PE_CYCLE = 0.01   # pJ per engine per cycle

# Per-round cost of one double-buffered boundary handoff: the ping/pong
# swap plus the ready-flag exchange with the neighbour core (a handful of
# uncached flag reads through the shared port).
HANDOFF_SYNC_CYCLES = 64.0

PIPELINES = ("v1", "v2", "v3")
_FILL_ITERS = {"v1": 0, "v2": 2, "v3": 4}

# Canonical substage order — deterministic tie-breaks when the doctor asks
# which stage BINDS an iteration (first maximum in this order wins).
STAGE_ORDER = ("ex_mac", "ex_q", "dw_mac", "dw_q", "pr_mac", "gap")
_STAGE_GROUPS = {"ex_mac": "ex", "ex_q": "ex", "dw_mac": "dw",
                 "dw_q": "dw", "pr_mac": "pr", "gap": "gap"}

GAP_LANES = 8.0           # vector adder lanes of the pooling accumulator


@dataclasses.dataclass(frozen=True)
class PEConfig:
    """Engine counts of the simulated CFU (defaults = the paper's arrays).

    Encodable in the CFG_PE instruction (8-bit fields, so 1..255 each).
    """

    exp_pes: int = 9          # expansion window engines (one per 3x3 tap)
    dw_lanes: int = 9         # depthwise MAC lanes
    proj_engines: int = PROJECTION_ENGINES    # output-stationary PEs (56)
    # Shared dw/pw engine variant (WinoFPGA-style): when a block runs the
    # fused-winograd schedule, its depthwise multiply array idles for 3 of
    # every 4 output pixels (the 16-multiply array fires once per 2x2
    # tile), so the projection GEMM may borrow the idle lanes. 1 = the
    # projection stage is priced with proj_engines + dw_lanes effective
    # engines while CFG_WINO is armed. Reuse, not extra silicon: the leak
    # term still charges exp + dw + proj engines.
    shared_dw_pw: int = 0

    def __post_init__(self):
        for name in ("exp_pes", "dw_lanes", "proj_engines"):
            v = getattr(self, name)
            if not 1 <= int(v) <= 255:
                raise ValueError(f"PEConfig.{name}={v} outside [1, 255]")
        if self.shared_dw_pw not in (0, 1):
            raise ValueError(
                f"PEConfig.shared_dw_pw={self.shared_dw_pw} must be 0 or 1")


@dataclasses.dataclass
class PhaseStats:
    """One BAR-delimited phase of the instruction walk.

    Cycle fields are per-frame (scaled by batch at report time); byte
    fields use the executor-aligned rd/wr split — per-phase sums equal
    the report totals exactly, which is what lets the trace exporter
    attribute every byte and cycle to a phase span.
    """

    n_iters: int = 0
    compute_cycles: float = 0.0         # per-frame iteration body cycles
    fill_cycles: float = 0.0            # pipeline fill, paid once per phase
    transfer_cycles: float = 0.0
    dram_transfer_cycles: float = 0.0   # DRAM-port share of transfer
    multi_stage: bool = False
    last_iter_cycles: float = 0.0
    label: str = ""                     # e.g. "block3" (first LD_WGT seen)
    dram_rd_bytes: int = 0              # per-frame data + weight reads
    dram_wr_bytes: int = 0
    sram_rd_bytes: int = 0
    sram_wr_bytes: int = 0
    weight_bytes: int = 0               # share of dram_rd that is weights
    # Per-frame iteration-body cycles attributed to the stage that BINDS
    # the pipeline each iteration (v1: every stage its own cost, the body
    # is their sum; v2: the substages of the binding group; v3: the single
    # binding substage). Sums to compute_cycles minus the per-iteration
    # C_PX_FIXED overhead (up to float rounding); the bottleneck doctor's
    # raw material — never feeds back into any report total.
    bound_stage_cycles: Dict[str, float] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class TimingReport:
    pipeline: str
    total_cycles: float
    compute_cycles: float
    transfer_cycles: float
    stall_cycles: float               # exposed (not hidden) memory time
    dram_bytes: int                   # reads + writes, incl. weights
    sram_bytes: int
    weight_bytes: int
    macs: int
    energy_pj: Dict[str, float]   # {"mac", "dram", "sram", "leak", "total"}
    sram_buffer_bytes: int            # scratch high-water (Eq. 2 analogue)
    n_phases: int
    dram_transfer_cycles: float = 0.0  # DRAM-port busy time (contention in)
    batch: int = 1                     # frames driven in lockstep
    handoff_cycles: float = 0.0        # dbuf boundary sync, per round
    n_dbuf_boundaries: int = 0         # distinct CFG_DBUF regions touched
    # executor-aligned counter splits (dram_bytes == rd + wr, etc.) and
    # per-opcode retired counts — ``ExecStats`` carries the same fields in
    # the same units, so modeled-vs-executed is a field-for-field diff
    dram_rd_bytes: int = 0
    dram_wr_bytes: int = 0
    sram_rd_bytes: int = 0
    sram_wr_bytes: int = 0
    check_bytes: int = 0               # CHK_* sweep coverage (batch-indep.)
    retired: Dict[str, int] = dataclasses.field(default_factory=dict)
    macs_by_engine: Dict[str, int] = dataclasses.field(default_factory=dict)
    # per-stage engine-busy cycles summed over iterations BEFORE pipelining
    # overlap (keys "ex_mac"/"ex_q"/"dw_mac"/"dw_q"/"pr_mac"/"gap") — the
    # axis the winograd ≥2x depthwise-stage gate compares on
    stage_cycles: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def frames_per_cycle(self) -> float:
        """Throughput of one core re-running this stream back-to-back."""
        return self.batch / self.total_cycles if self.total_cycles else 0.0

    @property
    def n_instr(self) -> int:
        return sum(self.retired.values())

    def counter_bank(self) -> CounterBank:
        """The CSR-style view (diffable against ``ExecStats``'s)."""
        return CounterBank(
            retired=dict(self.retired), macs=dict(self.macs_by_engine),
            dram_rd_bytes=self.dram_rd_bytes,
            dram_wr_bytes=self.dram_wr_bytes,
            sram_rd_bytes=self.sram_rd_bytes,
            sram_wr_bytes=self.sram_wr_bytes,
            weight_bytes=self.weight_bytes,
            check_bytes=self.check_bytes,
            stall_cycles=self.stall_cycles,
            handoff_cycles=self.handoff_cycles)


class _Walker:
    def __init__(self, pipeline: str, pe: Optional[PEConfig] = None,
                 sram_port_bytes: Optional[int] = None,
                 dram_cycles_per_byte: Optional[float] = None):
        if pipeline not in PIPELINES:
            raise ValueError(f"pipeline must be one of {PIPELINES}")
        self.pipeline = pipeline
        self.pe = pe or PEConfig()
        self.pe_locked = pe is not None      # analyze() override wins
        w = sram_port_bytes if sram_port_bytes is not None else SRAM_PORT_BYTES
        if w < 1:
            raise ValueError(f"sram_port_bytes must be >= 1, got {w}")
        self.cyc_per_sram_byte = 1.0 / w
        # off-chip port cost: the paper's measured CPU-mediated constant by
        # default (byte-identical golden numbers); the doctor's what-if
        # layer re-prices with a faster port without recompiling
        d = (CYC_PER_DRAM_BYTE if dram_cycles_per_byte is None
             else float(dram_cycles_per_byte))
        if d <= 0:
            raise ValueError(
                f"dram_cycles_per_byte must be > 0, got {d}")
        self.cyc_per_dram_byte = d
        # the stream may override via CFG_PE unless the caller pinned it
        # CFG / base state
        self.cin = self.cmid = self.cout = 0
        self.stride = 1
        self.h = self.w = self.h2 = self.w2 = 0
        self.strip_rows = 0      # CFG_STRIP rolling-buffer depth (0 = off)
        self.wino = None         # CFG_WINO latch: (tiles_y, tiles_x, shared)
        self.wino_seen: set = set()    # tiles whose 16-mul array has fired
        self.base: Dict[int, Tuple[int, int]] = {}
        # traffic
        self.touched: Dict[Tuple[int, str], np.ndarray] = {}
        self.space_sizes = {isa.SPACE_DRAM: 0, isa.SPACE_SRAM: 0}
        self.bytes_rd = {isa.SPACE_DRAM: 0, isa.SPACE_SRAM: 0}
        self.bytes_wr = {isa.SPACE_DRAM: 0, isa.SPACE_SRAM: 0}
        self.weight_bytes = 0
        self.check_bytes = 0     # bytes swept by CHK_* detection words
        self.macs = 0
        self.retired: Dict[str, int] = {}     # per-opcode, mirrors ExecStats
        self.macs_by_engine: Dict[str, int] = {}
        # cycles
        self.phases: List[PhaseStats] = []
        self.cur = PhaseStats()
        self.iter_stages: Dict[str, float] = {}
        # per-stage work cycles, summed over iterations BEFORE pipelining
        # (what each engine is busy for — the dw-stage speedup gate's axis)
        self.stage_cycles: Dict[str, float] = {}
        self.last_exp_mode: Optional[int] = None
        self.dbuf_bases: set = set()   # distinct double-buffered boundaries

    # --- map geometry (mirrors executor._map_shape) -------------------------

    def _map_shape(self, reg: int) -> Tuple[int, int, int]:
        return {isa.REG_IN: (self.h, self.w, self.cin),
                isa.REG_F1: (self.h, self.w, self.cmid),
                isa.REG_F2: (self.h2, self.w2, self.cmid),
                isa.REG_OUT: (self.h2, self.w2, self.cout)}[reg]

    # --- traffic helpers ----------------------------------------------------

    def _read(self, reg: int, y: int, x: int, stream: str):
        """Line-buffered unique read of one channel vector."""
        space, addr = self.base[reg]
        hm, wm, ch = self._map_shape(reg)
        if not (0 <= y < hm and 0 <= x < wm):
            return  # on-the-fly padding: no memory access
        if reg == isa.REG_F1 and self.strip_rows:
            y = y % self.strip_rows      # rolling strip (executor mirror)
        key = (space, stream)
        t = self.touched.get(key)
        if t is None:
            t = self.touched[key] = np.zeros(self.space_sizes[space], bool)
        off = addr + (y * wm + x) * ch
        seg = t[off:off + ch]
        new = ch - int(seg.sum())
        if new:
            seg[:] = True
            self.bytes_rd[space] += new
            self.cur.transfer_cycles += new * self._cyc_per_byte(space)
            if space == isa.SPACE_DRAM:
                self.cur.dram_transfer_cycles += new * self.cyc_per_dram_byte
                self.cur.dram_rd_bytes += new
            else:
                self.cur.sram_rd_bytes += new

    def _write(self, reg: int, n: int):
        space, _ = self.base[reg]
        self.bytes_wr[space] += n
        self.cur.transfer_cycles += n * self._cyc_per_byte(space)
        if space == isa.SPACE_DRAM:
            self.cur.dram_transfer_cycles += n * self.cyc_per_dram_byte
            self.cur.dram_wr_bytes += n
        else:
            self.cur.sram_wr_bytes += n

    def _mac(self, engine: str, n: int):
        self.macs += n
        self.macs_by_engine[engine] = self.macs_by_engine.get(engine, 0) + n

    def _cyc_per_byte(self, space: int) -> float:
        return (self.cyc_per_dram_byte if space == isa.SPACE_DRAM
                else self.cyc_per_sram_byte)

    # --- cycle helpers ------------------------------------------------------

    def _bind_iter(self, st: Dict[str, float], n_groups: int,
                   body: float) -> None:
        """Attribute this iteration's body to the stage(s) that bind it.

        v1 / single-group: the body is the sequential sum, every stage owns
        its own cost. v2: the substages of the binding GROUP (their sum is
        the body). v3: the single binding substage owns the whole body.
        Ties break on the canonical ``STAGE_ORDER`` so the attribution is
        deterministic; accumulates into the phase's ``bound_stage_cycles``.
        """
        bound = self.cur.bound_stage_cycles
        if n_groups < 2 or self.pipeline == "v1":
            for k, v in st.items():
                bound[k] = bound.get(k, 0.0) + v
            return
        if self.pipeline == "v2":
            gsum = {"ex": st.get("ex_mac", 0.0) + st.get("ex_q", 0.0),
                    "dw": st.get("dw_mac", 0.0) + st.get("dw_q", 0.0),
                    "pr": st.get("pr_mac", 0.0),
                    "gap": st.get("gap", 0.0)}
            win = max(("ex", "dw", "pr", "gap"), key=lambda g: gsum[g])
            for k in STAGE_ORDER:
                if k in st and _STAGE_GROUPS[k] == win:
                    bound[k] = bound.get(k, 0.0) + st[k]
            return
        win = max((k for k in STAGE_ORDER if k in st), key=lambda k: st[k])
        bound[win] = bound.get(win, 0.0) + body

    def _end_iter(self):
        if not self.iter_stages:
            return
        st = self.iter_stages
        for k, v in st.items():
            self.stage_cycles[k] = self.stage_cycles.get(k, 0.0) + v
        n_groups = len({_STAGE_GROUPS[k] for k in st})
        # Pipelining (v2/v3) is a property of the FUSED pipeline, where one
        # iteration spans all three engines. Layer-by-layer iterations
        # occupy a single engine group, so their cost is the sequential sum
        # under every mode ("all modes coincide", module docstring).
        if n_groups < 2 or self.pipeline == "v1":
            body = sum(st.values())
        elif self.pipeline == "v2":
            body = max(st.get("ex_mac", 0.0) + st.get("ex_q", 0.0),
                       st.get("dw_mac", 0.0) + st.get("dw_q", 0.0),
                       st.get("pr_mac", 0.0),
                       st.get("gap", 0.0))
        else:
            body = max(st.values())
        self._bind_iter(st, n_groups, body)
        cyc = body + C_PX_FIXED
        self.cur.compute_cycles += cyc
        self.cur.n_iters += 1
        self.cur.last_iter_cycles = cyc
        if n_groups >= 2:
            self.cur.multi_stage = True
        self.iter_stages = {}

    def _end_phase(self):
        self._end_iter()
        if self.cur.multi_stage:
            # fill is paid once per phase regardless of the data-plane
            # batch: kept apart from the per-frame body so analyze(batch=B)
            # can amortize it
            self.cur.fill_cycles = (_FILL_ITERS[self.pipeline]
                                    * self.cur.last_iter_cycles)
        if self.cur.n_iters or self.cur.transfer_cycles \
                or self.cur.weight_bytes:
            # weight-only phases carry 0 cycles (max(0, 0)) — kept so every
            # byte lands in some phase span, without moving any golden total
            self.phases.append(self.cur)
        self.cur = PhaseStats()
        self.touched.clear()
        self.wino_seen.clear()    # tile registers drain with the pipeline

    def _begin_iter(self):
        self._end_iter()

    # --- instruction dispatch ----------------------------------------------

    def walk(self, program: Program) -> None:
        layout = program.meta["layout"]
        self.space_sizes = {isa.SPACE_DRAM: layout.dram_size,
                            isa.SPACE_SRAM: layout.sram_size}
        k2 = isa.KERNEL * isa.KERNEL
        for ins in program.instrs:
            op = ins.op
            self.retired[op] = self.retired.get(op, 0) + 1
            if op == "CFG":
                cin, cmid, cout, stride, h, w = ins.args
                self.cin, self.cmid, self.cout = cin, cmid, cout
                self.stride, self.h, self.w = stride, h, w
                self.h2, self.w2 = -(-h // stride), -(-w // stride)
                self.strip_rows = 0
                self.wino = None
                self.wino_seen.clear()
            elif op == "CFG_STRIP":
                self.strip_rows = ins.args[0]
            elif op == "CFG_WINO":
                self.wino = tuple(ins.args)
                self.wino_seen.clear()
            elif op == "CFG_PE":
                if not self.pe_locked:
                    self.pe = PEConfig(*ins.args)
            elif op == "SET_BASE":
                reg, space, addr = ins.args
                self.base[reg] = (space, addr)
            elif op == "CFG_DBUF":
                # bytes are parity-independent (equal-size copies), so the
                # walker meters against the ping copy; the boundary itself
                # is what costs a per-round handoff
                reg, space, base0, base1 = ins.args
                self.base[reg] = (space, base0)
                self.dbuf_bases.add((space, base0, base1))
            elif op == "CFG_CORE":
                pass       # stream identity: informational, no cycles
            elif op == "LD_WGT":
                which, block = ins.args
                nbytes = {isa.WGT_EXP: self.cin * self.cmid,
                          isa.WGT_DW: k2 * self.cmid,
                          isa.WGT_PROJ: self.cmid * self.cout,
                          isa.WGT_CONV: k2 * self.cin * self.cmid}[which]
                self.weight_bytes += nbytes
                self.bytes_rd[isa.SPACE_DRAM] += nbytes
                self.cur.dram_rd_bytes += nbytes
                self.cur.weight_bytes += nbytes
                if not self.cur.label:
                    self.cur.label = f"block{block}"
                # boot-resident: no per-frame transfer cycles
            elif op == "BAR":
                self._end_phase()
            elif op == "LD_WIN":
                self._begin_iter()
                oy, ox = ins.args
                for dy in range(isa.KERNEL):
                    for dx in range(isa.KERNEL):
                        self._read(isa.REG_IN, oy * self.stride + dy - 1,
                                   ox * self.stride + dx - 1, "win")
                self.last_exp_mode = isa.MODE_WIN
            elif op == "LD_VEC":
                self._begin_iter()
                reg, y, x = ins.args
                self._read(reg, y, x, f"vec{reg}")
                self.last_exp_mode = isa.MODE_VEC
            elif op == "LD_TILE":
                self._begin_iter()
                reg, oy, ox = ins.args
                for dy in range(isa.KERNEL):
                    for dx in range(isa.KERNEL):
                        self._read(reg, oy * self.stride + dy - 1,
                                   ox * self.stride + dx - 1, "tile")
            elif op == "EXP_MAC":
                mode = ins.args[0]
                pixels = k2 if mode == isa.MODE_WIN else 1
                self._mac("exp", pixels * self.cin * self.cmid)
                self.iter_stages["ex_mac"] = (
                    C_EX_PER_IN_CH * self.cin * self.cmid * pixels / k2
                    * (k2 / self.pe.exp_pes))
            elif op == "CONV_MAC":
                # Standard 3x3 conv on the expansion array: k2*cin*cmid
                # MACs, one tap per window engine — WIN-mode expansion cost,
                # but only ONE output vector to requantize (VEC-mode quant).
                self._mac("conv", k2 * self.cin * self.cmid)
                self.iter_stages["ex_mac"] = (
                    C_EX_PER_IN_CH * self.cin * self.cmid
                    * (k2 / self.pe.exp_pes))
                self.last_exp_mode = isa.MODE_VEC
            elif op == "DW_MAC":
                self._mac("dw", k2 * self.cmid)
                self.iter_stages["dw_mac"] = (C_DW * self.cmid
                                              * (k2 / self.pe.dw_lanes))
            elif op == "WINO_MAC":
                # F(2x2,3x3): the 16-multiply array fires once per 2x2
                # tile (the tile's FIRST pixel); the other pixels read the
                # latched tile registers — no memory, no multiplies. Per
                # tile that is 16 muls for 4 outputs vs the direct 4x9.
                self._begin_iter()
                oy, ox = ins.args
                ty, tx = oy // winograd.TILE, ox // winograd.TILE
                if (ty, tx) not in self.wino_seen:
                    self.wino_seen.add((ty, tx))
                    for dy in range(winograd.WIN):
                        for dx in range(winograd.WIN):
                            self._read(isa.REG_F1, ty * winograd.TILE + dy - 1,
                                       tx * winograd.TILE + dx - 1, "wino")
                    self._mac("dw", winograd.MULS_PER_TILE * self.cmid)
                    self.iter_stages["dw_mac"] = (
                        C_DW * self.cmid
                        * (winograd.MULS_PER_TILE / self.pe.dw_lanes))
            elif op == "PROJ_MAC":
                self._mac("proj", self.cmid * self.cout)
                eng = self.pe.proj_engines
                if self.wino is not None and (self.wino[2]
                                              or self.pe.shared_dw_pw):
                    # shared dw/pw engine: the projection GEMM borrows the
                    # Winograd multiply lanes, idle 3 of every 4 pixels
                    eng += self.pe.dw_lanes
                groups = -(-self.cout // eng)
                self.iter_stages["pr_mac"] = C_PR * self.cmid * groups
            elif op == "REQUANT":
                stage = ins.args[0]
                if stage == isa.STAGE_F1:
                    pixels = (k2 if self.last_exp_mode == isa.MODE_WIN else 1)
                    self.iter_stages["ex_q"] = C_EXQ * self.cmid * pixels / k2
                elif stage == isa.STAGE_F2:
                    self.iter_stages["dw_q"] = C_DWQ * self.cmid
                # OUT requant is folded into C_PX_FIXED (fusion calibration)
            elif op == "RES_ADD":
                oy, ox = ins.args
                self._read(isa.REG_IN, oy, ox, "res")
            elif op == "GAP_RST":
                pass
            elif op == "GAP_ACC":
                self.iter_stages["gap"] = self.cmid / GAP_LANES
            elif op == "GAP_FIN":
                # one rounding divide per channel on the post-processing path
                self.iter_stages["gap"] = (self.iter_stages.get("gap", 0.0)
                                           + self.cmid)
            elif op == "ST_PX":
                self._write(isa.REG_OUT, self.cout)
            elif op == "ST_VEC":
                reg = ins.args[0]
                _, _, ch = self._map_shape(reg)
                self._write(reg, ch)
            elif op == "CHK_WGT":
                # The checksum unit sweeps the weight buffer behind the
                # streamer at line rate: coverage is metered (check_bytes,
                # batch-independent like all weight traffic), cycles are
                # hidden — a protected stream prices identically to its
                # unprotected twin, so detection is free on the cycle axis
                # and its cost shows up ONLY as the honest counter.
                self.check_bytes += {
                    isa.WGT_EXP: self.cin * self.cmid,
                    isa.WGT_DW: k2 * self.cmid,
                    isa.WGT_PROJ: self.cmid * self.cout,
                    isa.WGT_CONV: k2 * self.cin * self.cmid}[ins.args[0]]
            elif op in ("CHK_SAVE", "CHK_CMP"):
                # region sweep over the map bound to reg (executor mirror)
                hm, wm, ch = self._map_shape(ins.args[0])
                self.check_bytes += hm * wm * ch
            elif op == "HALT":
                self._end_phase()
            else:
                raise ValueError(f"timing model: unhandled opcode {op}")
        self._end_phase()  # in case HALT was omitted


class BatchCostModel:
    """Price one compiled stream at any batch size without re-walking.

    The instruction walk is batch-independent (every address is static),
    so the walker runs ONCE at construction; :meth:`report` then scales
    the per-frame phase terms for any ``batch`` — the aggregation is the
    exact code ``analyze`` always ran, so reports are float-identical to
    a fresh ``analyze(program, ..., batch=B)`` call. This is what lets a
    request-level serving simulator (``cfu.serve``) price thousands of
    dispatched batches against the calibrated model at event-loop speed.
    """

    def __init__(self, program: Program, pipeline: str = "v3",
                 pe: Optional[PEConfig] = None,
                 sram_port_bytes: Optional[int] = None,
                 handoff_sync_cycles: Optional[float] = None,
                 dram_cycles_per_byte: Optional[float] = None):
        w = _Walker(pipeline, pe=pe, sram_port_bytes=sram_port_bytes,
                    dram_cycles_per_byte=dram_cycles_per_byte)
        w.walk(program)
        self._w = w
        self._layout = program.meta["layout"]
        self.pipeline = pipeline
        self.handoff_sync_cycles = (HANDOFF_SYNC_CYCLES
                                    if handoff_sync_cycles is None
                                    else float(handoff_sync_cycles))

    @property
    def phases(self) -> List[PhaseStats]:
        """The walked per-frame phases (read-only view for the doctor)."""
        return self._w.phases

    @property
    def pe(self) -> PEConfig:
        """Engine counts the walk actually priced (stream CFG_PE or the
        constructor override)."""
        return self._w.pe

    @staticmethod
    def _phase_cycles(p: PhaseStats, b: float) -> float:
        """One phase's cycles at batch b — THE expression of the cycle
        model (compute/transfer overlap); trace spans reuse it verbatim so
        span durations sum to ``total_cycles`` bit-for-bit."""
        return max(p.compute_cycles * b + p.fill_cycles,
                   p.transfer_cycles * b)

    def report(self, batch: int = 1) -> TimingReport:
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        w = self._w
        b = float(batch)
        compute = sum(p.compute_cycles * b + p.fill_cycles for p in w.phases)
        transfer = sum(p.transfer_cycles * b for p in w.phases)
        total = sum(self._phase_cycles(p, b) for p in w.phases)
        dram_xfer = sum(p.dram_transfer_cycles * b for p in w.phases)
        # weights are boot-resident: loaded once however many frames ride
        # the data plane, so only the data share of DRAM traffic scales
        dram_rd = ((w.bytes_rd[isa.SPACE_DRAM] - w.weight_bytes) * batch
                   + w.weight_bytes)
        dram_wr = w.bytes_wr[isa.SPACE_DRAM] * batch
        sram_rd = w.bytes_rd[isa.SPACE_SRAM] * batch
        sram_wr = w.bytes_wr[isa.SPACE_SRAM] * batch
        dram = dram_rd + dram_wr
        sram = sram_rd + sram_wr
        macs = w.macs * batch
        e_mac = macs * E_MAC_INT8
        e_dram = dram * E_DRAM_BYTE
        e_sram = sram * E_SRAM_BYTE
        n_pes = w.pe.exp_pes + w.pe.dw_lanes + w.pe.proj_engines
        e_leak = n_pes * total * E_LEAK_PER_PE_CYCLE
        return TimingReport(
            pipeline=self.pipeline,
            total_cycles=total,
            compute_cycles=compute,
            transfer_cycles=transfer,
            stall_cycles=total - compute,
            dram_bytes=int(dram),
            sram_bytes=int(sram),
            weight_bytes=int(w.weight_bytes),
            macs=int(macs),
            energy_pj={"mac": e_mac, "dram": e_dram, "sram": e_sram,
                       "leak": e_leak,
                       "total": e_mac + e_dram + e_sram + e_leak},
            sram_buffer_bytes=int(self._layout.sram_size),
            n_phases=len(w.phases),
            dram_transfer_cycles=dram_xfer,
            batch=batch,
            handoff_cycles=self.handoff_sync_cycles * len(w.dbuf_bases),
            n_dbuf_boundaries=len(w.dbuf_bases),
            dram_rd_bytes=int(dram_rd),
            dram_wr_bytes=int(dram_wr),
            sram_rd_bytes=int(sram_rd),
            sram_wr_bytes=int(sram_wr),
            check_bytes=int(w.check_bytes),
            retired=dict(w.retired),
            macs_by_engine={k: v * batch
                            for k, v in w.macs_by_engine.items()},
            stage_cycles={k: v * b for k, v in w.stage_cycles.items()},
        )

    def emit_trace(self, tracer: Tracer, batch: int = 1, *, pid: int = 0,
                   t0: float = 0.0) -> float:
        """Emit the modeled timeline: one span per BAR-delimited phase.

        Span durations use :meth:`_phase_cycles` — the exact per-phase
        expression ``report`` sums — so the emitted spans add up to
        ``total_cycles`` with no rounding slack (the exactness invariant
        tests/test_cfu_trace.py pins). Cumulative byte counters ride the
        same timeline; returns the end timestamp so callers can stack
        streams end-to-end. Tracing never feeds back into the report.
        """
        w = self._w
        b = float(batch)
        tracer.thread_name(pid, 0, "phases (cycle time)")
        t = t0
        cum = {"dram_rd": 0.0, "dram_wr": 0.0,
               "sram_rd": 0.0, "sram_wr": 0.0}
        for i, p in enumerate(w.phases):
            dur = self._phase_cycles(p, b)
            drd = (p.dram_rd_bytes - p.weight_bytes) * batch + p.weight_bytes
            cum["dram_rd"] += drd
            cum["dram_wr"] += p.dram_wr_bytes * batch
            cum["sram_rd"] += p.sram_rd_bytes * batch
            cum["sram_wr"] += p.sram_wr_bytes * batch
            tracer.span(
                p.label or f"phase{i}", t, dur, pid=pid, tid=0,
                cat=CAT_PHASE,
                args={"compute_cycles": p.compute_cycles * b + p.fill_cycles,
                      "transfer_cycles": p.transfer_cycles * b,
                      "stall_cycles": dur - (p.compute_cycles * b
                                             + p.fill_cycles),
                      "fill_cycles": p.fill_cycles,
                      "n_iters": p.n_iters,
                      "dram_rd_bytes": drd,
                      "dram_wr_bytes": p.dram_wr_bytes * batch,
                      "sram_rd_bytes": p.sram_rd_bytes * batch,
                      "sram_wr_bytes": p.sram_wr_bytes * batch,
                      "weight_bytes": p.weight_bytes})
            t += dur
            tracer.counter("model.bytes", t, dict(cum), pid=pid)
        # per-boundary handoff cost as a counter track (satellite: the
        # ROADMAP's calibration hook made visible)
        tracer.counter("model.handoff_cycles", t,
                       {"per_round": self.handoff_sync_cycles
                        * len(w.dbuf_bases),
                        "n_boundaries": len(w.dbuf_bases)}, pid=pid)
        rep = self.report(batch)
        tracer.counter_bank(rep.counter_bank(), t, pid=pid)
        return t


class MultiStreamCostModel:
    """Batch-cost model of a ``compiler.MultiStreamProgram``: every stream
    walked once, any batch priced from the cached walks (float-identical
    to ``analyze_multistream(ms, ..., batch=B)``)."""

    def __init__(self, ms, pipeline: str = "v3",
                 pe=None,
                 sram_port_bytes: Optional[int] = None,
                 handoff_sync_cycles: Optional[float] = None,
                 dram_cycles_per_byte: Optional[float] = None):
        # ``pe`` overrides every core at once (one PEConfig) or per core
        # (a sequence of one PEConfig-or-None per stream) — the doctor's
        # what-if layer perturbs ONE core of a heterogeneous pipeline
        # without flattening the others.
        if pe is None or isinstance(pe, PEConfig):
            pes: List[Optional[PEConfig]] = [pe] * len(ms.streams)
        else:
            pes = list(pe)
            if len(pes) != len(ms.streams):
                raise ValueError(
                    f"per-core pe list has {len(pes)} entries for "
                    f"{len(ms.streams)} streams")
        self.models = [BatchCostModel(p, pipeline, pe=pe_i,
                                      sram_port_bytes=sram_port_bytes,
                                      handoff_sync_cycles=handoff_sync_cycles,
                                      dram_cycles_per_byte=dram_cycles_per_byte)
                       for p, pe_i in zip(ms.streams, pes)]
        self.pipeline = pipeline

    @property
    def n_cores(self) -> int:
        return len(self.models)

    def emit_trace(self, tracer: Tracer, batch: int = 1, *,
                   pid_base: int = 0, t0: float = 0.0) -> float:
        """Modeled timeline of one frame group: core i's phase spans on
        pid ``pid_base + i``, stacked end-to-end in time (the end-to-end
        latency view; steady state overlaps rounds across cores)."""
        t = t0
        for i, m in enumerate(self.models):
            pid = pid_base + i
            tracer.process_name(pid, f"core{i}-model (cycle time)")
            t = m.emit_trace(tracer, batch, pid=pid, t0=t)
        return t

    def report(self, batch: int = 1) -> MultiStreamReport:
        reps = [m.report(batch) for m in self.models]
        latency = sum(r.total_cycles + r.handoff_cycles for r in reps)
        slowest = max(r.total_cycles + r.handoff_cycles for r in reps)
        port = sum(r.dram_transfer_cycles for r in reps)
        interval = max(slowest, port)
        handoff = sum(r.handoff_cycles for r in reps)
        energy: Dict[str, float] = {}
        for r in reps:
            for k, v in r.energy_pj.items():
                energy[k] = energy.get(k, 0.0) + v
        # per-stream leak was n_pes_i * total_i * C; steady state charges
        # n_pes_i * interval instead (leak_i / total_i recovers the rate).
        leak = sum(r.energy_pj["leak"] / r.total_cycles
                   for r in reps if r.total_cycles) * interval
        energy["total"] += leak - energy.get("leak", 0.0)
        energy["leak"] = leak
        return MultiStreamReport(
            pipeline=self.pipeline,
            per_stream=reps,
            latency_cycles=latency,
            interval_cycles=interval,
            dram_contention_cycles=max(0.0, interval - slowest),
            dram_bytes=sum(r.dram_bytes for r in reps),
            sram_bytes=sum(r.sram_bytes for r in reps),
            macs=sum(r.macs for r in reps),
            energy_pj=energy,
            batch=batch,
            handoff_cycles=handoff,
            pipeline_fill_cycles=(len(reps) - 1) * interval,
        )


@dataclasses.dataclass
class MultiStreamReport:
    """Timing of an N-core compile: per-core reports + pipelined totals.

    ``latency_cycles`` is one frame group end-to-end (cores run
    back-to-back, each paying its boundary handoffs). ``interval_cycles``
    is the steady-state per-*round* initiation interval with all cores
    busy on consecutive frame groups:
    ``max(max_i (core_i + handoff_i), sum_i dram_port_i)`` — the first
    term is the slowest core's round (compute/transfer plus its
    double-buffer handoffs), the second the shared DRAM port serializing
    every core's off-chip transfers (the ping/pong boundary copies
    decouple the cores' *data* dependencies, so bandwidth and handoff are
    all that couples them). ``dram_contention_cycles`` is the exposed
    excess of the port over the slowest round.

    Each round retires ``batch`` frames, so the steady-state throughput is
    ``frames_per_cycle = batch / interval_cycles``; the pipeline fill
    before steady state is ``(N-1)·interval`` (``pipeline_fill_cycles``),
    and ``cycles_for_frames`` composes the two for a finite frame count.
    """

    pipeline: str
    per_stream: List[TimingReport]
    latency_cycles: float
    interval_cycles: float
    dram_contention_cycles: float
    dram_bytes: int
    sram_bytes: int
    macs: int
    energy_pj: Dict[str, float]
    batch: int = 1
    handoff_cycles: float = 0.0        # summed over the cores, per round
    pipeline_fill_cycles: float = 0.0  # (N-1) intervals before steady state

    @property
    def throughput_speedup_vs_single(self) -> float:
        return self.latency_cycles / self.interval_cycles

    @property
    def frames_per_cycle(self) -> float:
        """Steady-state throughput: frames retired per cycle."""
        return self.batch / self.interval_cycles if self.interval_cycles \
            else 0.0

    @property
    def energy_per_frame_pj(self) -> float:
        return self.energy_pj["total"] / self.batch

    def cycles_for_frames(self, n_frames: int) -> float:
        """Fill + steady state + drain for a finite frame sequence:
        ``ceil(F / batch)`` rounds through an N-deep pipeline."""
        rounds = -(-n_frames // self.batch)
        return (rounds + len(self.per_stream) - 1) * self.interval_cycles


def analyze_multistream(ms, pipeline: str = "v3",
                        pe: Optional[PEConfig] = None,
                        batch: int = 1,
                        sram_port_bytes: Optional[int] = None,
                        handoff_sync_cycles: Optional[float] = None,
                        dram_cycles_per_byte: Optional[float] = None,
                        ) -> MultiStreamReport:
    """Walk every stream of a ``compiler.MultiStreamProgram``.

    Each stream is priced under its OWN CFG_PE word (per-core PE configs
    ride in the streams); ``pe=`` overrides all of them at once. ``batch``
    is the per-round frame-group size of the batched frame pipeline
    (see ``analyze``): totals are per round, i.e. per ``batch`` frames.
    ``sram_port_bytes`` widens every core's scratch port and
    ``dram_cycles_per_byte`` re-prices the shared off-chip port (see
    ``analyze``).

    Energy: the dynamic terms (MAC/DRAM/SRAM) sum over the streams, but
    the static term is re-priced for the steady state the report models —
    EVERY core leaks for the whole per-round interval, including its
    idle/stall share, so extra cores are never energetically free.

    ``handoff_sync_cycles`` calibrates the per-boundary double-buffer
    handoff cost (default ``HANDOFF_SYNC_CYCLES`` = 64): each core's round
    pays it once per CFG_DBUF boundary it touches.

    Repeated what-if pricing of the SAME program at many batch sizes
    should build a :class:`MultiStreamCostModel` once instead.
    """
    return MultiStreamCostModel(ms, pipeline, pe=pe,
                                sram_port_bytes=sram_port_bytes,
                                handoff_sync_cycles=handoff_sync_cycles,
                                dram_cycles_per_byte=dram_cycles_per_byte
                                ).report(batch)


def analyze(program: Program, pipeline: str = "v3",
            pe: Optional[PEConfig] = None, batch: int = 1,
            sram_port_bytes: Optional[int] = None,
            handoff_sync_cycles: Optional[float] = None,
            dram_cycles_per_byte: Optional[float] = None) -> TimingReport:
    """Walk one compiled program and report cycles/traffic/energy.

    ``pe`` overrides the stream's CFG_PE engine counts (what-if analysis
    without recompiling); by default the stream's own word governs.

    ``batch`` prices the stream driving B frames in lockstep (the batched
    executor's data plane): per-iteration compute, byte traffic, MACs and
    dynamic energy scale with B; each phase's pipeline-fill cycles are
    paid once, so throughput per frame improves with batch. All totals
    (cycles, bytes, energy) are for the whole batch.

    ``sram_port_bytes`` widens the on-chip scratch port (bytes moved per
    cycle; default ``SRAM_PORT_BYTES`` = 1, the paper's byte-wide
    single-port scratch, which keeps all golden cycle numbers
    byte-identical). Byte COUNTS never change — only the cycles the SRAM
    share of each phase's transfer takes, so a wider port only helps
    where a phase is scratch-bound.

    ``dram_cycles_per_byte`` re-prices the off-chip port (default
    ``CYC_PER_DRAM_BYTE`` = 45.6, the paper's measured CPU-mediated
    cost — again byte-identical golden numbers). The doctor's what-if
    layer passes ``CYC_PER_DRAM_BYTE / 2`` to ask what a 2x port buys.

    Repeated what-if pricing of the SAME program at many batch sizes
    should build a :class:`BatchCostModel` once instead (one walk, any
    batch) — this function re-walks per call.
    """
    return BatchCostModel(program, pipeline, pe=pe,
                          sram_port_bytes=sram_port_bytes,
                          handoff_sync_cycles=handoff_sync_cycles,
                          dram_cycles_per_byte=dram_cycles_per_byte
                          ).report(batch)
