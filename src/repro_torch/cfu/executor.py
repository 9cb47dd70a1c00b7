"""Golden-model CFU executor: bit-exact, vectorized, batched, pure numpy.

The interpreter executes the *encoded* 64-bit words (``run_words``), so the
binary ISA provably carries the whole program; ``run_program`` is sugar that
encodes first. Per instruction the datapath is one vectorized numpy op
(an einsum for EXP/PROJ/CONV, an elementwise-multiply-reduce for DW) — the
"vectorization" is across the channel/tile dimension, exactly the
parallelism of the paper's engine arrays (9x8 expansion MACs, 9-way
depthwise, 56 output-stationary projection engines).

Batched simulation: every memory space carries a leading batch axis
(``(B, bytes)``) and every datapath register broadcasts over it, so ONE
instruction stream drives N images in lockstep — the multi-stream serving
scenario. The instruction count is batch-independent (the stream is the
same program); only the data plane widens. ``run_words`` accepts either a
single image (H, W, C) or a batch (B, H, W, C) and is bit-exact per image
either way (asserted in tests/test_cfu_differential.py).

Multi-core simulation: ``run_multistream``
executes a ``compiler.MultiStreamProgram`` as a frame-pipelined machine —
N cores over ONE shared physical DRAM, each core re-running its own
encoded stream per round with a private SRAM scratch. Inter-core boundary
maps exist exactly TWICE in that DRAM (the planner's ping/pong copies,
bound by CFG_DBUF words): in an even round a core reads/writes the ping
copy, in an odd round the pong copy, so the producer of a boundary fills
one copy while its consumer drains the other. ``MultiStreamRunner``
exposes the schedule core-step by core-step and ENFORCES the handoff
protocol: stepping a core whose input boundary copy does not yet hold its
frame group — or whose output copy still holds data its consumer has not
retired — raises :class:`HandoffViolation` instead of silently reading
stale (or clobbering unconsumed) data. Frame-level batching composes with
the pipelining: each round drives a GROUP of ``batch`` frames through a
core in lockstep (the batch axis below), so B frames x N cores run as
``ceil(B/batch)`` pipelined rounds.

Bit-exactness contract: the int8 outputs equal
``core.dsc.dsc_block_reference`` / ``dsc_block_fused_pixelwise`` (and the
full-network stream equals ``models.mobilenetv2.forward_int8``) with EXACT
integer equality, because every arithmetic step mirrors ``core.quant``
operation-for-operation in IEEE float32 / int32:

* MAC loops accumulate raw int8 operands in int32 with the zero-point
  correction folded into the bias (``quant.fold_zero_point_correction``);
* ``_requantize_np`` mirrors ``quant.requantize``: float32 multiply by the
  effective scale, round-half-to-even, int32 add of the zero point, clip;
* ``_residual_add_np`` mirrors ``quant.residual_add_q``'s TFLite ADD;
* ``GAP_FIN`` divides the int32 pooling accumulator in float32 and rounds
  half-to-even — the exact arithmetic of the scalar-core reference's
  global average pool;
* on-the-fly padding (LD_WIN/LD_TILE) returns the destination domain's
  zero point for out-of-bounds taps — numerically identical to the
  reference's explicitly padded tensors (see the NOTE in
  ``dsc_block_reference``).

Weight binding: ``LD_WGT.block`` indexes the host-side ``params`` sequence.
Entries are ``QuantizedDSCParams`` for DSC blocks or the duck-typed aux
parameter records of ``cfu.network`` (stem conv / head 1x1 / FC) — the
machine only touches the attributes each instruction actually needs, so a
stem entry carries conv weights and F1-domain requant constants and nothing
else.

Machine state (see package docstring): WIN (3x3xC + validity mask), VEC,
F1T (3x3xM), F2V (M), the GAP int32 pooling accumulator, the pending int32
accumulator ACC, the requant result RES, four base registers, and one
(B, bytes) int8 array per memory space.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cfu import isa
from repro_torch.cfu import winograd
from repro_torch.cfu.isa import Instr
from repro_torch.cfu.trace import (CAT_EXEC, CAT_MARK, NULL_TRACER, CounterBank,
                                   Tracer)

INT8_MIN, INT8_MAX = -128, 127


class FaultDetected(RuntimeError):
    """An ISA-level detection mechanism caught corrupted state: a word
    failed the even-parity check, or a CHK_WGT / CHK_CMP checksum word
    found memory that no longer matches its stamped golden sum. The
    campaign taxonomy in ``cfu/faults.py`` classifies this outcome as
    *detected* (vs masked / silent-data-corruption / crashed)."""


# --- numpy mirrors of core.quant (bit-exact by op-for-op identity) ----------


def _requantize_np(acc_i32: np.ndarray, eff_scale, zp_out: int,
                   relu: bool = False,
                   relu6_max_q: Optional[int] = None) -> np.ndarray:
    y = np.round(acc_i32.astype(np.float32)
                 * np.asarray(eff_scale, np.float32))
    y = y.astype(np.int32) + zp_out
    lo = zp_out if relu else INT8_MIN
    hi = INT8_MAX if relu6_max_q is None else min(relu6_max_q, INT8_MAX)
    return np.clip(y, lo, hi).astype(np.int8)


def _residual_add_np(y_q: np.ndarray, x_q: np.ndarray, p) -> np.ndarray:
    s_y = np.float32(np.asarray(p.qp_out.scale))
    s_x = np.float32(np.asarray(p.qp_in.scale))
    acc = (s_y * (y_q.astype(np.float32) - p.qp_out.zero_point)
           + s_x * (x_q.astype(np.float32) - p.qp_in.zero_point))
    out = np.round(acc / s_y) + p.qp_out.zero_point
    return np.clip(out, INT8_MIN, INT8_MAX).astype(np.int8)


def host_array(v, name: str, dtype) -> np.ndarray:
    """``v`` (numpy, or a torch tensor on the CPU) as a numpy array.

    The golden model runs on the host. A tensor on a card raises instead of
    being copied back quietly: move the parameters with ``.to("cpu")``.
    """
    device = getattr(v, "device", None)
    if device is not None and getattr(device, "type", "cpu") != "cpu":
        raise TypeError(
            f"{name} lies on {device}; the golden executor reads host "
            f"arrays (numpy or CPU tensors), move the parameters to the CPU")
    return np.asarray(v, dtype)


@dataclasses.dataclass
class _BlockWeights:
    """Numpy views of one weight-set's tensors + requant constants.

    ``p`` may be a ``QuantizedDSCParams`` or one of ``cfu.network``'s aux
    records (stem/head/FC); fields an entry doesn't define stay ``None``
    and the corresponding engines simply must not be used by the stream.
    """

    p: object
    w_exp: Optional[np.ndarray]
    w_dw: Optional[np.ndarray]
    w_proj: Optional[np.ndarray]
    w_conv: Optional[np.ndarray]
    b_exp: Optional[np.ndarray]
    b_dw: Optional[np.ndarray]
    b_proj: Optional[np.ndarray]
    b_conv: Optional[np.ndarray]
    m_exp: Optional[np.ndarray]
    m_dw: Optional[np.ndarray]
    m_proj: Optional[np.ndarray]

    @classmethod
    def of(cls, p) -> "_BlockWeights":
        def arr(name, dtype):
            v = getattr(p, name, None)
            return None if v is None else host_array(v, name, dtype)
        return cls(
            p=p,
            w_exp=arr("w_exp", np.int32), w_dw=arr("w_dw", np.int32),
            w_proj=arr("w_proj", np.int32), w_conv=arr("w_conv", np.int32),
            b_exp=arr("b_exp", np.int32), b_dw=arr("b_dw", np.int32),
            b_proj=arr("b_proj", np.int32), b_conv=arr("b_conv", np.int32),
            m_exp=arr("m_exp", np.float32), m_dw=arr("m_dw", np.float32),
            m_proj=arr("m_proj", np.float32),
        )


@dataclasses.dataclass
class ExecStats:
    """Executed-stream counters, field-aligned with ``timing.TimingReport``.

    Units follow the cost model's convention so the two are DIRECTLY
    diffable (``tests/test_cfu_trace.py`` pins the equality): data bytes
    are line-buffered *unique* bytes per phase, summed over the whole
    lockstep batch; weight bytes count once per LD_WGT executed
    (boot-resident streaming, never scaled by batch); ``counts`` is the
    per-opcode retired-instruction histogram (batch-independent — one
    stream drives the whole batch); ``macs_by_engine`` splits ``n_macs``
    across the exp/conv/dw/proj arrays.
    """

    n_instr: int = 0
    n_macs: int = 0          # executed MACs, summed over the whole batch
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    macs_by_engine: Dict[str, int] = dataclasses.field(default_factory=dict)
    dram_rd_bytes: int = 0
    dram_wr_bytes: int = 0
    sram_rd_bytes: int = 0
    sram_wr_bytes: int = 0
    weight_bytes: int = 0
    weight_reloads: int = 0      # LD_WGT re-streaming an already-seen set
    check_bytes: int = 0         # bytes swept by CHK_* detection words

    @property
    def retired(self) -> Dict[str, int]:
        """Alias: per-opcode retired-instruction counts."""
        return self.counts

    @property
    def dram_bytes(self) -> int:
        return self.dram_rd_bytes + self.dram_wr_bytes

    @property
    def sram_bytes(self) -> int:
        return self.sram_rd_bytes + self.sram_wr_bytes

    def counter_bank(self) -> CounterBank:
        """Render into the CSR-style bank (stall/handoff stay 0 — the
        executor has no clock; those live on the cost-model side)."""
        return CounterBank(
            retired=dict(self.counts), macs=dict(self.macs_by_engine),
            dram_rd_bytes=self.dram_rd_bytes,
            dram_wr_bytes=self.dram_wr_bytes,
            sram_rd_bytes=self.sram_rd_bytes,
            sram_wr_bytes=self.sram_wr_bytes,
            weight_bytes=self.weight_bytes,
            weight_reloads=self.weight_reloads,
            check_bytes=self.check_bytes)


class CFUMachine:
    """Architectural state + instruction dispatch (batch axis throughout)."""

    def __init__(self, params: Sequence, dram_size: int, sram_size: int,
                 batch: int = 1,
                 dram_mem: Optional[np.ndarray] = None,
                 tracer: Optional[Tracer] = None, pid: int = 0):
        self.params = list(params)
        self._wcache: Dict[int, _BlockWeights] = {}
        self.batch = batch
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.pid = pid
        # ``dram_mem`` shares one off-chip image between machines — the
        # multi-stream runner's common DRAM port (each core keeps its own
        # SRAM scratch).
        self.mem = {
            isa.SPACE_DRAM: (dram_mem if dram_mem is not None else
                             np.zeros((batch, max(dram_size, 1)), np.int8)),
            isa.SPACE_SRAM: np.zeros((batch, max(sram_size, 1)), np.int8),
        }
        # CFG state
        self.cin = self.cmid = self.cout = 0
        self.stride = 1
        self.h = self.w = self.h2 = self.w2 = 0
        self.strip_rows = 0      # CFG_STRIP: F1 rolling-buffer depth (0=off)
        self.wino_cfg = None     # CFG_WINO latch: (tiles_y, tiles_x, shared)
        self._wino_tiles = {}    # (ty, tx) -> (B, 2, 2, M) int32 tile regs
        self._wino_u4 = {}       # block -> transformed weights (4, 4, M)
        self.frame_parity = 0    # ping/pong latch CFG_DBUF resolves against
        self.core_id: Optional[Tuple[int, int]] = None   # CFG_CORE slot
        # base registers: reg -> (space, addr)
        self.base: Dict[int, Tuple[int, int]] = {}
        self.cur: Optional[_BlockWeights] = None
        self.cur_block: Optional[int] = None
        self.wgt_loaded: set = set()     # which engines LD_WGT streamed
        # datapath registers (all carry the leading batch axis)
        self.win = None          # (B,3,3,C) int8 input window
        self.win_valid = None    # (3,3) bool — shared across the batch
        self.vec = None          # (B,C) or (B,M) int8
        self.acc = None          # pending int32 accumulator
        self.acc_src = None      # which MAC produced it ("exp_win"|...)
        self.f1t = None          # (B,3,3,M) int8
        self.f2v = None          # (B,M) int8
        self.gap = None          # (B,M) int32 pooling accumulator
        self.res = None          # last requant result (int8, (B,ch))
        self.chk: Dict[int, int] = {}    # CHK_SAVE/CHK_CMP register file
        # fault-campaign hook: called as hook(machine, n_instr) before
        # each instruction (``cfu/faults.py`` flips memory bits in a
        # targeted cycle window through it); None costs one ``is None``
        self.pre_instr_hook = None
        self.stats = ExecStats()
        # traffic meter: line-buffered unique-read accounting, mirroring
        # timing._Walker._read byte for byte (the exactness invariant) —
        # one touched-bitmap per (space, stream) pair, cleared at BAR
        self._touched: Dict[Tuple[int, str], np.ndarray] = {}
        self._wgt_seen: set = set()          # (block, engine) ever streamed
        self._phase_idx = 0
        self._phase_start = 0                # n_instr at phase start
        self._phase_label = ""

    # --- traffic meter (mirrors timing._Walker byte accounting) -------------

    def _meter_read(self, reg: int, y: int, x: int, stream: str):
        """Count the unique bytes this channel-vector read moves."""
        space, base = self.base[reg]
        hm, wm, ch = self._map_shape(reg)
        if not (0 <= y < hm and 0 <= x < wm):
            return          # on-the-fly padding: no memory access
        if reg == isa.REG_F1 and self.strip_rows:
            y = y % self.strip_rows
        key = (space, stream)
        t = self._touched.get(key)
        if t is None:
            t = self._touched[key] = np.zeros(self.mem[space].shape[1], bool)
        off = base + (y * wm + x) * ch
        seg = t[off:off + ch]
        new = ch - int(seg.sum())
        if new:
            seg[:] = True
            n = new * self.batch          # every lockstep frame moves it
            if space == isa.SPACE_DRAM:
                self.stats.dram_rd_bytes += n
            else:
                self.stats.sram_rd_bytes += n

    def _meter_write(self, reg: int, n: int):
        space, _ = self.base[reg]
        n *= self.batch
        if space == isa.SPACE_DRAM:
            self.stats.dram_wr_bytes += n
        else:
            self.stats.sram_wr_bytes += n

    def _meter_macs(self, engine: str, n: int):
        self.stats.n_macs += n
        self.stats.macs_by_engine[engine] = \
            self.stats.macs_by_engine.get(engine, 0) + n

    def _end_phase(self):
        """BAR/HALT: reset the line-buffer trackers, emit the phase span
        (executor time axis = retired instructions)."""
        self._touched.clear()
        self._wino_tiles.clear()    # tile registers drain with the pipeline
        start, end = self._phase_start, self.stats.n_instr
        if end > start:
            self.tracer.span(
                self._phase_label or f"phase{self._phase_idx}",
                start, end - start, pid=self.pid, tid=0, cat=CAT_EXEC,
                args={"n_instr": end - start})
        self._phase_idx += 1
        self._phase_start = end
        self._phase_label = ""

    # --- address helpers ----------------------------------------------------

    def _map_shape(self, reg: int) -> Tuple[int, int, int]:
        if reg == isa.REG_IN:
            return self.h, self.w, self.cin
        if reg == isa.REG_F1:
            return self.h, self.w, self.cmid
        if reg == isa.REG_F2:
            return self.h2, self.w2, self.cmid
        if reg == isa.REG_OUT:
            return self.h2, self.w2, self.cout
        raise ValueError(reg)

    def _vec_slice(self, reg: int, y: int, x: int) -> np.ndarray:
        space, base = self.base[reg]
        _, w, ch = self._map_shape(reg)
        if reg == isa.REG_F1 and self.strip_rows:
            # Strip mode: F1 rows live in a rolling buffer, row coordinate
            # modulo the strip depth (the circular line buffer of the
            # fused-rowtile schedule; bounds were checked by the caller).
            y = y % self.strip_rows
        off = base + (y * w + x) * ch
        return self.mem[space][:, off:off + ch]

    def _zp_of(self, reg: int) -> int:
        # Lazy per-register lookup: aux weight records (stem/head/FC) only
        # define the domains their instructions touch.
        p = self.cur.p
        attr = {isa.REG_IN: "qp_in", isa.REG_F1: "qp_f1",
                isa.REG_F2: "qp_f2", isa.REG_OUT: "qp_out"}[reg]
        return getattr(p, attr).zero_point

    def _gather_window(self, reg: int, oy: int, ox: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """3x3 window with on-the-fly zero-point padding (paper Fig. 13b).

        Window top-left = out*stride - 1 — identical to
        ``core.dsc._window_indices`` (SAME padding, pad_top = pad_left = 1).
        """
        hm, wm, ch = self._map_shape(reg)
        k, s = isa.KERNEL, self.stride
        win = np.empty((self.batch, k, k, ch), np.int8)
        valid = np.zeros((k, k), bool)
        zp = np.int8(self._zp_of(reg))
        for dy in range(k):
            iy = oy * s + dy - 1
            for dx in range(k):
                ix = ox * s + dx - 1
                if 0 <= iy < hm and 0 <= ix < wm:
                    win[:, dy, dx] = self._vec_slice(reg, iy, ix)
                    valid[dy, dx] = True
                else:
                    win[:, dy, dx] = zp
        return win, valid

    # --- dispatch -----------------------------------------------------------

    def execute(self, instrs: Sequence[Instr]) -> ExecStats:
        for ins in instrs:
            if self.pre_instr_hook is not None:
                self.pre_instr_hook(self, self.stats.n_instr)
            self.stats.n_instr += 1
            self.stats.counts[ins.op] = self.stats.counts.get(ins.op, 0) + 1
            getattr(self, "_op_" + ins.op.lower())(*ins.args)
        return self.stats

    def _op_halt(self):
        self._end_phase()

    def _op_bar(self, phase):
        # pipeline drain; architectural state is unaffected, but the
        # line-buffer trackers reset (a new phase re-fetches its maps)
        self._end_phase()

    def _op_cfg(self, cin, cmid, cout, stride, h, w):
        self.cin, self.cmid, self.cout = cin, cmid, cout
        self.stride, self.h, self.w = stride, h, w
        self.h2, self.w2 = -(-h // stride), -(-w // stride)
        self.strip_rows = 0      # each block opts back in via CFG_STRIP
        self.wino_cfg = None     # ... and via CFG_WINO
        self._wino_tiles.clear()

    def _op_cfg_pe(self, exp_pes, dw_lanes, proj_engines):
        pass  # engine counts shape time, never values (timing model only)

    def _op_cfg_strip(self, rows):
        self.strip_rows = rows

    def _op_cfg_wino(self, tiles_y, tiles_x, shared):
        # arm the F(2x2,3x3) unit for this block; ``shared`` only shapes
        # time (the projection GEMM borrows the idle multiply array in the
        # cost model) — values are unaffected, like CFG_PE
        self.wino_cfg = (tiles_y, tiles_x, shared)
        self._wino_tiles.clear()

    def _op_cfg_core(self, core, n_cores):
        self.core_id = (core, n_cores)   # informational: stream identity

    def _op_set_base(self, reg, space, addr):
        self.base[reg] = (space, addr)

    def _op_cfg_dbuf(self, reg, space, base0, base1):
        # double-buffered boundary: the frame-parity latch picks the copy
        self.base[reg] = (space, base1 if self.frame_parity & 1 else base0)

    def _op_ld_wgt(self, which, block):
        if block not in self._wcache:
            self._wcache[block] = _BlockWeights.of(self.params[block])
        self.cur = self._wcache[block]
        if block != self.cur_block:      # new block: old streams invalid
            self.cur_block = block
            self.wgt_loaded = set()
        self.wgt_loaded.add(which)
        # weight-streamer traffic (mirrors timing._Walker's LD_WGT sizes;
        # boot-resident, so never scaled by the data-plane batch)
        k2 = isa.KERNEL * isa.KERNEL
        nbytes = {isa.WGT_EXP: self.cin * self.cmid,
                  isa.WGT_DW: k2 * self.cmid,
                  isa.WGT_PROJ: self.cmid * self.cout,
                  isa.WGT_CONV: k2 * self.cin * self.cmid}[which]
        self.stats.weight_bytes += nbytes
        self.stats.dram_rd_bytes += nbytes
        if (block, which) in self._wgt_seen:
            self.stats.weight_reloads += 1
        self._wgt_seen.add((block, which))
        if not self._phase_label:
            self._phase_label = f"block{block}"

    def _need_wgt(self, which, engine: str):
        if which not in self.wgt_loaded:
            raise RuntimeError(
                f"{engine} engine used before LD_WGT streamed its weights "
                f"(block {self.cur_block})")

    def _op_ld_win(self, oy, ox):
        for dy in range(isa.KERNEL):
            for dx in range(isa.KERNEL):
                self._meter_read(isa.REG_IN, oy * self.stride + dy - 1,
                                 ox * self.stride + dx - 1, "win")
        self.win, self.win_valid = self._gather_window(isa.REG_IN, oy, ox)

    def _op_ld_vec(self, reg, y, x):
        self._meter_read(reg, y, x, f"vec{reg}")
        v = self._vec_slice(reg, y, x).copy()
        if reg == isa.REG_F2:
            self.f2v = v     # projection input port
        else:
            self.vec = v     # expansion input port

    def _op_ld_tile(self, reg, oy, ox):
        # Materialized-F1 window: pad value IS the F1 zero point, exactly
        # what the reference's jnp.pad(..., constant_values=zp_f1) provides.
        for dy in range(isa.KERNEL):
            for dx in range(isa.KERNEL):
                self._meter_read(reg, oy * self.stride + dy - 1,
                                 ox * self.stride + dx - 1, "tile")
        self.f1t, _ = self._gather_window(reg, oy, ox)

    def _op_exp_mac(self, mode):
        self._need_wgt(isa.WGT_EXP, "expansion")
        cw = self.cur
        src = self.win if mode == isa.MODE_WIN else self.vec
        self.acc = (np.einsum("...c,cm->...m", src.astype(np.int32),
                              cw.w_exp) + cw.b_exp)
        self.acc_src = "exp_win" if mode == isa.MODE_WIN else "exp_vec"
        self._meter_macs("exp", src.size * self.cmid)

    def _op_conv_mac(self):
        self._need_wgt(isa.WGT_CONV, "stem conv")
        cw = self.cur
        self.acc = (np.einsum("byxc,yxcm->bm", self.win.astype(np.int32),
                              cw.w_conv) + cw.b_conv)
        self.acc_src = "conv"
        self._meter_macs("conv", self.win.size * self.cmid)

    def _op_dw_mac(self):
        self._need_wgt(isa.WGT_DW, "depthwise")
        cw = self.cur
        prod = self.f1t.astype(np.int32) * cw.w_dw
        self.acc = prod.sum(axis=(-3, -2)) + cw.b_dw
        self.acc_src = "dw"
        self._meter_macs("dw", self.f1t.size)

    def _op_wino_mac(self, oy, ox):
        """One output pixel off its F(2x2,3x3) tile.

        The first pixel of a 2x2 tile runs the 16-multiply array: gather
        the 4x4 F1 window (top-left = 2·ty - 1, zero-point padding for
        out-of-range taps — identical to the reference's padded F1), push
        it through the folded integer transform (``cfu.winograd``), and
        latch the (2, 2, M) int32 tile in the tile registers. The tile's
        other pixels reuse the latched values: no reads, no multiplies —
        that is the 9 -> 4 effective-MAC win the schedule exists for.
        """
        self._need_wgt(isa.WGT_DW, "winograd depthwise")
        if self.wino_cfg is None:
            raise RuntimeError("WINO_MAC before CFG_WINO armed the unit")
        cw = self.cur
        t = winograd.TILE
        ty, tx = oy // t, ox // t
        tile = self._wino_tiles.get((ty, tx))
        if tile is None:
            hm, wm, ch = self._map_shape(isa.REG_F1)
            zp = np.int8(self._zp_of(isa.REG_F1))
            d = np.empty((self.batch, winograd.WIN, winograd.WIN, ch),
                         np.int8)
            for dy in range(winograd.WIN):
                iy = ty * t + dy - 1
                for dx in range(winograd.WIN):
                    ix = tx * t + dx - 1
                    if 0 <= iy < hm and 0 <= ix < wm:
                        self._meter_read(isa.REG_F1, iy, ix, "wino")
                        d[:, dy, dx] = self._vec_slice(isa.REG_F1, iy, ix)
                    else:
                        d[:, dy, dx] = zp
            u4 = self._wino_u4.get(self.cur_block)
            if u4 is None:
                u4 = winograd.weight_transform(cw.w_dw)
                self._wino_u4[self.cur_block] = u4
            tile = winograd.wino_dw_tiles(d, u4)
            self._wino_tiles[(ty, tx)] = tile
            self._meter_macs("dw", d.size)   # 16·M·B, vs the direct 9·M·B
        self.acc = tile[:, oy % t, ox % t] + cw.b_dw
        self.acc_src = "dw"

    def _op_proj_mac(self):
        self._need_wgt(isa.WGT_PROJ, "projection")
        cw = self.cur
        self.acc = (np.einsum("...m,mn->...n", self.f2v.astype(np.int32),
                              cw.w_proj) + cw.b_proj)
        self.acc_src = "proj"
        self._meter_macs("proj", self.f2v.size * self.cout)

    def _op_requant(self, stage):
        cw, p = self.cur, self.cur.p
        if stage == isa.STAGE_F1:
            y = _requantize_np(self.acc, cw.m_exp, p.qp_f1.zero_point,
                               relu=True, relu6_max_q=p.q6_f1)
            if self.acc_src == "exp_win":
                # Fused path: taps whose SOURCE pixel was padding must read
                # as zp_f1 downstream (the hardware's address check gates
                # the expansion engines) — same masking as
                # ``dsc_block_fused_pixelwise``.
                self.f1t = np.where(self.win_valid[..., None], y,
                                    np.int8(p.qp_f1.zero_point))
            else:
                self.res = y
        elif stage == isa.STAGE_F2:
            y = _requantize_np(self.acc, cw.m_dw, p.qp_f2.zero_point,
                               relu=True, relu6_max_q=p.q6_f2)
            self.f2v = y
            self.res = y
        else:
            self.res = _requantize_np(self.acc, cw.m_proj,
                                      p.qp_out.zero_point, relu=False)

    def _op_gap_rst(self):
        self.gap = np.zeros((self.batch, self.cmid), np.int32)

    def _op_gap_acc(self):
        self.gap += self.vec.astype(np.int32)

    def _op_gap_fin(self, n):
        # int32 sum -> float32 divide -> round-half-to-even: the exact
        # arithmetic of forward_int8's global average pool.
        g = np.round(self.gap.astype(np.float32) / np.float32(n))
        g = np.clip(g.astype(np.int32), INT8_MIN, INT8_MAX).astype(np.int8)
        self.f2v = g            # pooled vector feeds the projection port
        self.res = g

    def _op_res_add(self, oy, ox):
        self._meter_read(isa.REG_IN, oy, ox, "res")
        x_px = self._vec_slice(isa.REG_IN, oy, ox)
        self.res = _residual_add_np(self.res, x_px, self.cur.p)

    def _op_st_px(self, oy, ox):
        self._meter_write(isa.REG_OUT, self.cout)
        self._vec_slice(isa.REG_OUT, oy, ox)[:] = self.res

    def _op_st_vec(self, reg, y, x):
        self._meter_write(reg, self._map_shape(reg)[2])
        self._vec_slice(reg, y, x)[:] = self.res

    # --- detection words (reliability extension) ----------------------------

    def _chk_region(self, reg: int) -> Tuple[np.ndarray, int]:
        space, base = self.base[reg]
        hm, wm, ch = self._map_shape(reg)
        size = hm * wm * ch
        return self.mem[space][:, base:base + size], size

    def _op_chk_wgt(self, which, block, sum_):
        name = {isa.WGT_EXP: "w_exp", isa.WGT_DW: "w_dw",
                isa.WGT_PROJ: "w_proj", isa.WGT_CONV: "w_conv"}[which]
        w = getattr(self.params[block], name, None)
        if w is None:
            raise RuntimeError(
                f"CHK_WGT: block {block} defines no {name} tensor")
        k2 = isa.KERNEL * isa.KERNEL
        nbytes = {isa.WGT_EXP: self.cin * self.cmid,
                  isa.WGT_DW: k2 * self.cmid,
                  isa.WGT_PROJ: self.cmid * self.cout,
                  isa.WGT_CONV: k2 * self.cin * self.cmid}[which]
        self.stats.check_bytes += nbytes
        got = isa.checksum32(w)
        if got != sum_:
            raise FaultDetected(
                f"CHK_WGT: block {block} {name} checksum 0x{got:08x} != "
                f"stamped 0x{sum_:08x} — weight memory corrupted")

    def _op_chk_save(self, reg, k):
        data, size = self._chk_region(reg)
        self.stats.check_bytes += size
        self.chk[k] = isa.checksum32(data)

    def _op_chk_cmp(self, reg, k):
        want = self.chk.get(k)
        if want is None:
            raise RuntimeError(f"CHK_CMP chk={k} before any CHK_SAVE")
        data, size = self._chk_region(reg)
        self.stats.check_bytes += size
        got = isa.checksum32(data)
        if got != want:
            raise FaultDetected(
                f"CHK_CMP: region at {isa.REG_NAMES[reg]} checksum "
                f"0x{got:08x} != saved 0x{want:08x} — activation memory "
                f"corrupted in the guarded window")


# --- host-side entry points --------------------------------------------------


def bind_input(x_q, meta: Dict[str, object]) -> Tuple[np.ndarray, bool]:
    """Normalize to a batch and validate against the bound input region.

    Shared by the interpreter entry points below and the jitted fast path
    (``cfu/fastpath.py``) so both backends accept exactly the same input
    conventions — single frame or leading batch axis — and reject the
    same malformed shapes.
    """
    layout = meta["layout"]
    x_q = np.asarray(x_q, np.int8)
    in_ndim = len(meta["in_shape"])
    if x_q.ndim == in_ndim:
        batched, x_q = False, x_q[None]
    elif x_q.ndim == in_ndim + 1:
        batched = True
    else:
        raise ValueError(f"input ndim {x_q.ndim}, expected {in_ndim} "
                         f"or {in_ndim + 1} (batched)")
    r_in = layout.regions[meta["in_region"]]
    if x_q[0].size != r_in.size:
        raise ValueError(f"input has {x_q[0].size} bytes, region "
                         f"{r_in.name} holds {r_in.size}")
    return x_q, batched


def read_output(dram_mem: np.ndarray, sram_mem: Optional[np.ndarray],
                meta: Dict[str, object], batched: bool) -> np.ndarray:
    layout = meta["layout"]
    r_out = layout.regions[meta["out_region"]]
    if r_out.space != isa.SPACE_DRAM and sram_mem is None:
        raise ValueError(
            f"output region {r_out.name!r} is SRAM-resident but this "
            "entry point only exposes the shared DRAM image (multi-stream "
            "outputs must be planned into DRAM)")
    mem = dram_mem if r_out.space == isa.SPACE_DRAM else sram_mem
    y = mem[:, r_out.base:r_out.base + r_out.size]
    y = y.reshape((mem.shape[0],) + tuple(meta["out_shape"])).copy()
    return y if batched else y[0]


def run_words(words: Sequence[int], x_q, params: Sequence,
              meta: Dict[str, object],
              return_stats: bool = False,
              tracer: Optional[Tracer] = None,
              pre_instr_hook=None):
    """Execute an encoded program on ``x_q``: (H, W, C) int8 or a batch
    (B, H, W, C) — one instruction stream drives the whole batch.

    ``meta`` is the Program.meta of the compiled stream (memory layout +
    input/output binding); the architectural behaviour is fully determined
    by the words themselves. ``tracer`` records per-phase spans (time axis
    = retired instructions) and a final counter-bank dump; it never
    affects any computed value. ``pre_instr_hook(machine, n_instr)`` runs
    before each instruction — the fault campaigns' cycle-window injection
    point (``cfu/faults.py``).

    When ``meta["parity"]`` is set, every word is verified against its
    even-parity bit BEFORE decoding, so a single-bit flip anywhere in an
    encoded instruction raises :class:`FaultDetected` instead of
    executing (or crashing the decoder on) a corrupted word.
    """
    layout = meta["layout"]
    if meta.get("parity"):
        bad = isa.bad_parity_indices(words)
        if bad:
            raise FaultDetected(
                f"{len(bad)} instruction word(s) failed the parity check "
                f"(first at index {bad[0]}) — instruction memory corrupted")
    x_q, batched = bind_input(x_q, meta)
    m = CFUMachine(params, layout.dram_size, layout.sram_size,
                   batch=x_q.shape[0], tracer=tracer)
    m.pre_instr_hook = pre_instr_hook
    r_in = layout.regions[meta["in_region"]]
    m.mem[r_in.space][:, r_in.base:r_in.base + r_in.size] = \
        x_q.reshape(x_q.shape[0], -1)
    stats = m.execute(isa.decode_words(words))
    m.tracer.process_name(m.pid, "cfu-exec (instr time)")
    m.tracer.counter_bank(stats.counter_bank(), stats.n_instr, pid=m.pid)
    y = read_output(m.mem[isa.SPACE_DRAM], m.mem[isa.SPACE_SRAM],
                     meta, batched)
    return (y, stats) if return_stats else y


def run_program(program, x_q, params: Sequence,
                return_stats: bool = False,
                tracer: Optional[Tracer] = None):
    """Encode then execute — every run exercises the binary format."""
    return run_words(isa.encode_program(program), x_q, params, program.meta,
                     return_stats=return_stats, tracer=tracer)


class HandoffViolation(RuntimeError):
    """A core tried to touch a double-buffered boundary copy out of turn:
    reading a copy before its producer's round retired, or overwriting a
    copy its consumer has not drained yet."""


class MultiStreamRunner:
    """Frame-pipelined multi-core execution over ONE shared physical DRAM,
    with the double-buffer handoff protocol ENFORCED step by step.

    N cores each own a pipeline-stage segment of the network. Frames are
    processed in GROUPS of ``batch`` (the lockstep data plane of the
    batched executor); core *i* runs its whole segment for one group per
    :meth:`step`. Every inter-core boundary map exists twice in the shared
    DRAM (the planner's ping/pong copies): group *g* lives in copy
    ``g % 2``, which the executing core resolves through its frame-parity
    latch and the CFG_DBUF words of its stream.

    The runner tracks which group each boundary copy currently holds and
    which (boundary, group) pairs the consumer has retired. ``step(core)``
    raises :class:`HandoffViolation` — it never silently reads stale
    data — when the core's input copy does not hold its next group (the
    producer has not retired that round) or its output copy still holds a
    group the consumer has not drained (a double buffer is two deep, not
    infinite). :meth:`run` plays the canonical schedule (core *i* takes
    group *r - i* in round *r*); arbitrary legal interleavings reach the
    same bit-exact result (property-tested in
    ``tests/test_cfu_properties.py``).
    """

    def __init__(self, ms, x_q, params: Sequence, batch: int = 1,
                 tracer: Optional[Tracer] = None):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.ms = ms
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._step_seq = 0           # scheduler step index: the time axis
        self.layout = ms.meta["layout"]
        x_q, self.batched = bind_input(x_q, ms.meta)
        self.n_frames = x_q.shape[0]
        self.batch = batch
        self.n_groups = -(-self.n_frames // batch)
        pad = self.n_groups * batch - self.n_frames
        if pad:        # ragged tail: repeat the last frame, sliced off later
            x_q = np.concatenate([x_q, np.repeat(x_q[-1:], pad, 0)], axis=0)
        self.frames = x_q
        self.n_cores = len(ms.streams)
        self.words = [isa.decode_words(isa.encode_program(p))
                      for p in ms.streams]
        self.in_names = [p.meta["in_region"] for p in ms.streams]
        self.out_names = [p.meta["out_region"] for p in ms.streams]
        # ONE shared DRAM: private segments are disjoint by the pinned
        # plan; boundary maps exist exactly twice (ping/pong).
        self.dram = np.zeros((batch, max(self.layout.dram_size, 1)), np.int8)
        self.cores = [CFUMachine(params, self.layout.dram_size,
                                 self.layout.sram_size, batch=batch,
                                 dram_mem=self.dram,
                                 tracer=self.tracer, pid=i)
                      for i, _ in enumerate(ms.streams)]
        for i in range(self.n_cores):
            self.tracer.process_name(i, f"core{i}-exec (step time)")
        self.next_group = [0] * self.n_cores
        self.copy_holds: Dict[Tuple[str, int], int] = {}  # copy -> group
        self.consumed: set = set()                        # (name, group)
        out_shape = tuple(ms.meta["out_shape"])
        self.out = np.zeros((self.n_groups * batch,) + out_shape, np.int8)

    # --- boundary-copy helpers ---------------------------------------------

    def _copy_region(self, name: str, parity: int):
        if parity and name in self.layout.dbuf:
            return self.layout.dbuf[name]
        return self.layout.regions[name]

    def _blocker(self, core: int) -> Optional[str]:
        """Why ``step(core)`` would violate the handoff (None = ready)."""
        g = self.next_group[core]
        if g >= self.n_groups:
            return f"core {core} has retired all {self.n_groups} groups"
        parity = g & 1
        in_name = self.in_names[core]
        # core 0's input arrives by host DMA inside its own step (which
        # also consumes the copy's previous group), so only downstream
        # cores can be starved of input
        if core > 0 and self.copy_holds.get((in_name, parity)) != g:
            held = self.copy_holds.get((in_name, parity))
            return (f"core {core} needs boundary {in_name!r} group {g} in "
                    f"copy {parity}, which holds "
                    f"{'nothing' if held is None else f'group {held}'} — "
                    f"producer core {core - 1} has not retired that round")
        out_name = self.out_names[core]
        held = self.copy_holds.get((out_name, parity))
        if held is not None and (out_name, held) not in self.consumed:
            return (f"core {core} would overwrite boundary {out_name!r} "
                    f"copy {parity} holding group {held}, which its "
                    f"consumer has not drained")
        return None

    def ready(self, core: int) -> bool:
        return self._blocker(core) is None

    @property
    def done(self) -> bool:
        return all(g >= self.n_groups for g in self.next_group)

    # --- execution -----------------------------------------------------------

    def step(self, core: int) -> int:
        """Run ``core``'s segment for its next frame group; returns the
        group index. Raises :class:`HandoffViolation` if the double-buffer
        protocol does not permit the step yet."""
        why = self._blocker(core)
        if why is not None:
            # the wait event a hardware ready-flag probe would log: the
            # core polled its boundary out of turn and was refused
            self.tracer.instant(
                "handoff_violation", self.cores[core].stats.n_instr,
                pid=core, tid=1, cat=CAT_MARK,
                args={"why": why, "group": self.next_group[core]})
            raise HandoffViolation(why)
        g = self.next_group[core]
        parity = g & 1
        in_name, out_name = self.in_names[core], self.out_names[core]
        if core == 0:      # host DMA: this round's frames arrive off-chip
            r = self._copy_region(in_name, parity)
            self.dram[:, r.base:r.base + r.size] = \
                self.frames[g * self.batch:(g + 1) * self.batch] \
                    .reshape(self.batch, -1)
            self.copy_holds[(in_name, parity)] = g
        m = self.cores[core]
        m.frame_parity = parity
        t0 = m.stats.n_instr
        m.execute(self.words[core])
        self._step_seq += 1
        self.tracer.span(f"group{g}", t0, m.stats.n_instr - t0,
                         pid=core, tid=1, cat=CAT_EXEC,
                         args={"group": g, "parity": parity,
                               "step": self._step_seq})
        self.tracer.counter("handoffs_retired", m.stats.n_instr, g + 1,
                            pid=core, series=in_name)
        self.consumed.add((in_name, g))
        self.copy_holds[(out_name, parity)] = g
        if core == self.n_cores - 1:   # host drains the program output
            r = self._copy_region(out_name, parity)
            y = self.dram[:, r.base:r.base + r.size]
            self.out[g * self.batch:(g + 1) * self.batch] = \
                y.reshape((self.batch,) + self.out.shape[1:])
            self.consumed.add((out_name, g))
        self.next_group[core] = g + 1
        return g

    def run(self) -> "MultiStreamRunner":
        """The canonical schedule: in round r, core i takes group r - i."""
        for rnd in range(self.n_groups + self.n_cores - 1):
            for core in range(self.n_cores):
                if 0 <= rnd - core < self.n_groups:
                    self.step(core)
        return self

    def outputs(self) -> np.ndarray:
        y = self.out[:self.n_frames].copy()
        return y if self.batched else y[0]

    def stats(self):
        return [m.stats for m in self.cores]


def run_multistream(ms, x_q, params: Sequence, return_stats: bool = False,
                    batch: int = 1, tracer: Optional[Tracer] = None):
    """Execute a ``compiler.MultiStreamProgram`` as the frame-pipelined
    multi-core machine it compiles for: N cores share ONE physical DRAM
    (the common off-chip port), each owns its SRAM scratch, and the
    canonical schedule interleaves the streams round by round — in round
    *r*, core *i* executes frame group *r - i*, so all N cores are busy
    on N consecutive groups at once (the steady state
    ``timing.analyze_multistream`` prices). ``batch`` sets the frames per
    group (frame-level batching composed with the layer pipeline); the
    result is bit-exact vs the single-stream compile per frame either way.

    The double-buffer handoff is enforced, not assumed: see
    :class:`MultiStreamRunner`, which this wraps.
    """
    runner = MultiStreamRunner(ms, x_q, params, batch=batch,
                               tracer=tracer).run()
    y = runner.outputs()
    return (y, runner.stats()) if return_stats else y
