"""Seeded fault injection, ISA-level detection, and failover replay.

Edge devices die in the field: SRAM and DRAM words take single-event
upsets, streamed weights arrive corrupted, instruction memories flip
bits, whole cores drop out mid-run. This module makes the repo answer
what that costs, using the bit-exact golden executor as the oracle:

* :class:`FaultInjector` draws deterministic single-bit faults from a
  seeded RNG, targeted at one of four spaces — ``"weights"`` (the int8
  tensors a stream's LD_WGT words actually load), ``"instr"`` (the
  encoded 64-bit words), ``"sram"`` / ``"dram"`` (data memory, flipped
  mid-run at a targeted instruction-index window through the executor's
  ``pre_instr_hook``).
* :func:`protect_program` is the post-compile stamping pass (the linker
  analogue): it arms instruction-word parity in the stream meta, inserts
  a ``CHK_WGT`` word after every ``LD_WGT`` carrying the pristine
  tensor's :func:`isa.checksum32`, and (optionally) wraps
  producer->consumer feature-map regions across BAR boundaries in
  ``CHK_SAVE``/``CHK_CMP`` pairs. A protected stream computes the exact
  same bytes as its unprotected twin — detection never perturbs data.
* :func:`classify_fault` runs one faulted execution against the golden
  output and lands it in the four-way taxonomy: **detected** (a typed
  :class:`FaultDetected` from parity or a checksum word), **crashed**
  (any other exception — decoder, range check, protocol), **masked**
  (logits bit-equal golden), or **sdc** — silent data corruption, the
  outcome the detection mechanisms exist to eliminate.
* :func:`run_campaign` sweeps fault space x flips-per-run x trials into
  the outcome taxonomy; :func:`detection_coverage` is the campaign cell
  the tests pin at 100% — with parity + weight checksums armed, every
  single-bit weight and instruction-word fault must land in *detected*
  (both mechanisms are exact for single flips: a flip always breaks even
  parity, and an additive byte sum mod 2^32 always moves by ±2^k).
* :func:`run_with_dropout` is the executor-level failover path: play the
  canonical multi-core schedule to a drop round, recompile the chain for
  the surviving cores (the balanced partitioner re-partitions), replay
  every frame the dead pipeline had in flight, and return outputs that
  are bit-exact vs the no-fault run (the serving-level p99 impact is
  quantified by ``serve.dispatcher``'s :class:`DropoutEvent`).

Determinism: every campaign is a pure function of (program, params,
input, seed) — the RNG is ``np.random.default_rng(seed)`` and the
executor is the deterministic golden interpreter.

Nothing here mutates a program or a params list in place:
:func:`protect_program` returns a new program (new instruction list, a
copied meta), :func:`faulted_words` and :func:`faulted_params` copy what
they flip, and memory faults land in the executor's machine state. The
fast path's cache (``cfu.fastpath``), keyed by a program's encoded words,
relies on that.

Host code over the port's golden executor, carried over from
``repro.cfu.faults``: words, draws, campaign cells and failover outputs
equal the reference's. Weights are read as host arrays; a tensor on a
card raises ``TypeError`` (``executor.host_array``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cfu import isa
from repro_torch.cfu.executor import (FaultDetected, MultiStreamRunner,
                                      bind_input, host_array,
                                      run_multistream, run_program,
                                      run_words)

__all__ = [
    "FaultDetected", "Fault", "FaultInjector", "FailoverReport",
    "protect_program", "classify_fault", "run_faulted", "run_campaign",
    "detection_coverage", "run_with_dropout",
    "FAULT_SPACES", "OUTCOMES",
    "MASKED", "DETECTED", "SDC", "CRASHED",
]

MASKED, DETECTED, SDC, CRASHED = "masked", "detected", "sdc", "crashed"
OUTCOMES = (MASKED, DETECTED, SDC, CRASHED)
FAULT_SPACES = ("weights", "instr", "sram", "dram")

WGT_ATTRS = {isa.WGT_EXP: "w_exp", isa.WGT_DW: "w_dw",
             isa.WGT_PROJ: "w_proj", isa.WGT_CONV: "w_conv"}

# reads that can consume a CHK_SAVE-guarded region (op -> reg extractor)
_READ_REGS: Dict[str, Callable[[Tuple[int, ...]], int]] = {
    "LD_WIN": lambda a: isa.REG_IN,
    "LD_VEC": lambda a: a[0],
    "LD_TILE": lambda a: a[0],
    "RES_ADD": lambda a: isa.REG_IN,
    "WINO_MAC": lambda a: isa.REG_F1,
}


# --- the protect/stamping pass (post-compile "linker") ----------------------


def protect_program(program: isa.Program, params: Optional[Sequence] = None,
                    *, parity: bool = True, weight_checksums: bool = True,
                    activation_checksums: bool = False) -> isa.Program:
    """Stamp detection words into a compiled stream.

    Runs post-compile because the checksums need the bound params — the
    compiler never sees weight values, only specs. The returned program
    computes byte-identical outputs to the input program (checks read,
    never write); its meta gains ``parity``/``protected`` flags, so
    ``isa.encode_program`` stamps the parity bit and the executor arms
    verification.

    ``activation_checksums`` additionally guards feature-map regions
    across phase boundaries: when a BAR-delimited phase stored a map
    through a plain SET_BASE binding, a ``CHK_SAVE`` snapshots it just
    before the BAR, and a ``CHK_CMP`` re-verifies it right before the
    first read in a later phase — corruption landing in the guarded
    window is caught at the consumer. Double-buffered (CFG_DBUF)
    boundary regions and rolling-strip F1 maps are left unguarded (their
    geometry is parity-/window-dependent).

    Accepts a ``compiler.MultiStreamProgram`` too (streams are stamped
    independently; per-core params indexing is shared).
    """
    if hasattr(program, "streams"):       # MultiStreamProgram duck-type
        from repro_torch.cfu.compiler import MultiStreamProgram
        streams = [protect_program(p, params, parity=parity,
                                   weight_checksums=weight_checksums,
                                   activation_checksums=activation_checksums)
                   for p in program.streams]
        meta = dict(program.meta)
        meta["protected"] = True
        if parity:
            meta["parity"] = True
        return MultiStreamProgram(streams, meta=meta)
    if weight_checksums and params is None:
        raise ValueError("weight_checksums=True needs the params records "
                         "(the compiler never sees weight values)")

    out: List[isa.Instr] = []
    # static mirrors of the executor's CFG / base-register latches
    cin = cmid = cout = h = w = h2 = w2 = 0
    stride = 1
    strip_rows = 0
    bases: Dict[int, Optional[Tuple[int, int]]] = {}
    stored: set = set()                    # regs stored to since last BAR
    # (space, addr) -> (chk_idx, size): armed guards awaiting their CMP
    guards: Dict[Tuple[int, int], Tuple[int, int]] = {}
    free_chk = list(range(isa.N_CHK_REGS))

    def map_size(reg: int) -> int:
        return {isa.REG_IN: h * w * cin,
                isa.REG_F1: h * w * cmid,
                isa.REG_F2: h2 * w2 * cmid,
                isa.REG_OUT: h2 * w2 * cout}[reg]

    for ins in program.instrs:
        op = ins.op
        if activation_checksums and op in _READ_REGS:
            # first read of a guarded region in a consuming phase:
            # re-verify before the datapath touches a single byte
            reg = _READ_REGS[op](ins.args)
            b = bases.get(reg)
            g = guards.get(b) if b is not None else None
            if g is not None and not (reg == isa.REG_F1 and strip_rows) \
                    and g[1] == map_size(reg):
                out.append(isa.Instr("CHK_CMP", (reg, g[0])))
                guards.pop(b)
                free_chk.append(g[0])
        if op == "CFG":
            cin, cmid, cout, stride, h, w = ins.args
            h2, w2 = -(-h // stride), -(-w // stride)
            strip_rows = 0
        elif op == "CFG_STRIP":
            strip_rows = ins.args[0]
        elif op == "SET_BASE":
            reg, space, addr = ins.args
            bases[reg] = (space, addr)
        elif op == "CFG_DBUF":
            bases[ins.args[0]] = None      # parity-resolved: unguardable
        elif op == "ST_PX":
            stored.add(isa.REG_OUT)
        elif op == "ST_VEC":
            stored.add(ins.args[0])
        if op in ("ST_PX", "ST_VEC"):
            # a legitimate overwrite retires any stale guard on the region
            # (region reuse by the memory planner must never false-trip)
            b = bases.get(isa.REG_OUT if op == "ST_PX" else ins.args[0])
            g = guards.pop(b, None) if b is not None else None
            if g is not None:
                free_chk.append(g[0])
        if op == "BAR" and activation_checksums:
            # snapshot every map this phase produced through a plain
            # SET_BASE binding, just before the pipeline drains
            for reg in sorted(stored):
                b = bases.get(reg)
                if b is None or b in guards or not free_chk:
                    continue
                if reg == isa.REG_F1 and strip_rows:
                    continue               # rolling strip: partial map
                k = free_chk.pop(0)
                out.append(isa.Instr("CHK_SAVE", (reg, k)))
                guards[b] = (k, map_size(reg))
        if op in ("BAR", "HALT"):
            stored.clear()
        out.append(ins)
        if op == "LD_WGT" and weight_checksums:
            which, block = ins.args
            w_t = getattr(params[block], WGT_ATTRS[which], None)
            if w_t is not None:
                w_h = host_array(w_t, WGT_ATTRS[which], np.int8)
                out.append(isa.Instr(
                    "CHK_WGT", (which, block, isa.checksum32(w_h))))

    meta = dict(program.meta)
    meta["protected"] = True
    if parity:
        meta["parity"] = True
    return isa.Program(out, meta)


# --- fault model -------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Fault:
    """One single-bit flip, fully determined (no RNG at apply time).

    ``index`` is a byte offset (weights/sram/dram) or a word index
    (instr); ``bit`` counts within that unit (0..7 or 0..63).
    ``at_instr`` is the cycle window for data-space faults: the flip
    lands just before the instruction with that retired-index executes
    (weights/instr faults are applied at t=0, before the run).
    """

    space: str
    index: int
    bit: int
    block: int = 0              # weights: params record index
    which: str = ""             # weights: tensor attribute name
    at_instr: int = 0           # sram/dram: injection window


class FaultInjector:
    """Seeded, deterministic fault planner for one compiled stream.

    Weight faults only target tensors the stream actually loads (its
    LD_WGT words) — a flip in a never-streamed tensor is outside the
    machine and would vacuously count as masked.
    """

    def __init__(self, words: Sequence[int], meta: Dict[str, object],
                 params: Sequence, seed: int = 0):
        self.words = np.asarray(words, dtype=np.uint64)
        self.meta = meta
        self.params = params
        self.rng = np.random.default_rng(seed)
        layout = meta["layout"]
        self.space_sizes = {"dram": layout.dram_size,
                            "sram": layout.sram_size}
        self.n_instr = len(self.words)
        self.wgt_targets: List[Tuple[int, str, int]] = []
        seen = set()
        for ins in isa.decode_words(self.words):
            if ins.op != "LD_WGT":
                continue
            which, block = ins.args
            name = WGT_ATTRS[which]
            if (block, name) in seen:
                continue
            seen.add((block, name))
            w_t = getattr(params[block], name, None)
            if w_t is not None:
                self.wgt_targets.append(
                    (block, name, int(host_array(w_t, name, np.int8).size)))
        if not self.wgt_targets:
            raise ValueError("stream loads no weight tensors to fault")

    def sample(self, space: str) -> Fault:
        rng = self.rng
        if space == "weights":
            block, name, size = \
                self.wgt_targets[rng.integers(len(self.wgt_targets))]
            return Fault(space, int(rng.integers(size)),
                         int(rng.integers(8)), block=block, which=name)
        if space == "instr":
            return Fault(space, int(rng.integers(len(self.words))),
                         int(rng.integers(64)))
        if space in ("sram", "dram"):
            size = self.space_sizes[space]
            if size <= 0:
                raise ValueError(
                    f"this stream maps no {space.upper()} "
                    "(zero-size space: nothing to upset)")
            return Fault(space, int(rng.integers(size)),
                         int(rng.integers(8)),
                         at_instr=int(rng.integers(self.n_instr)))
        raise ValueError(f"fault space must be one of {FAULT_SPACES}, "
                         f"got {space!r}")

    def targetable(self, space: str) -> bool:
        """Whether ``space`` has any bits this stream could be hurt in."""
        if space in ("sram", "dram"):
            return self.space_sizes[space] > 0
        return space in ("weights", "instr")


def _with_attr(record, name: str, value):
    """Copy a params record with one attribute replaced (dataclass-aware)."""
    if dataclasses.is_dataclass(record):
        return dataclasses.replace(record, **{name: value})
    import copy
    r = copy.copy(record)
    setattr(r, name, value)
    return r


def faulted_params(params: Sequence, fault: Fault) -> List:
    """Params list with the fault's weight bit flipped (input unchanged)."""
    out = list(params)
    arr = np.array(host_array(getattr(params[fault.block], fault.which),
                              fault.which, np.int8), copy=True)
    arr.reshape(-1).view(np.uint8)[fault.index] ^= np.uint8(1 << fault.bit)
    out[fault.block] = _with_attr(params[fault.block], fault.which, arr)
    return out


def faulted_words(words: np.ndarray, fault: Fault) -> np.ndarray:
    """Encoded stream with the fault's instruction bit flipped."""
    out = np.array(words, dtype=np.uint64, copy=True)
    out[fault.index] ^= np.uint64(1) << np.uint64(fault.bit)
    return out


def _mem_fault_hook(mem_faults: Sequence[Fault]):
    spaces = {"sram": isa.SPACE_SRAM, "dram": isa.SPACE_DRAM}

    def hook(machine, n_instr: int):
        for f in mem_faults:
            if n_instr == f.at_instr:
                mem = machine.mem[spaces[f.space]]
                if f.index < mem.shape[1]:
                    # lane 0 of the lockstep batch takes the upset
                    mem.view(np.uint8)[0, f.index] ^= np.uint8(1 << f.bit)
    return hook


def run_faulted(words: np.ndarray, meta: Dict[str, object],
                params: Sequence, x_q, faults: Sequence[Fault]):
    """Execute with the given faults applied; raises what the run raises."""
    params_f, words_f, mem_faults = list(params), words, []
    for f in faults:
        if f.space == "weights":
            params_f = faulted_params(params_f, f)
        elif f.space == "instr":
            words_f = faulted_words(words_f, f)
        else:
            mem_faults.append(f)
    hook = _mem_fault_hook(mem_faults) if mem_faults else None
    return run_words(words_f, x_q, params_f, meta, pre_instr_hook=hook)


def classify_fault(words: np.ndarray, meta: Dict[str, object],
                   params: Sequence, x_q, golden: np.ndarray,
                   faults: Sequence[Fault]) -> str:
    """One faulted run -> the four-way outcome taxonomy."""
    try:
        y = run_faulted(words, meta, params, x_q, faults)
    except FaultDetected:
        return DETECTED
    except Exception:
        return CRASHED
    return MASKED if np.array_equal(y, golden) else SDC


# --- campaign sweeps ---------------------------------------------------------


def run_campaign(program: isa.Program, params: Sequence, x_q, *,
                 spaces: Sequence[str] = FAULT_SPACES,
                 n_faults: int = 16,
                 n_flips: Sequence[int] = (1,),
                 seed: int = 0,
                 protect: bool = True,
                 activation_checksums: bool = True) -> Dict[str, object]:
    """The sweep: fault space x flips-per-run x trials -> outcome counts.

    One arm (detection on OR off — run it twice to compare); the clean
    run of the arm's own words provides the golden logits AND validates
    that protection itself never perturbs data or false-trips.
    """
    if protect:
        program = protect_program(
            program, params, parity=True, weight_checksums=True,
            activation_checksums=activation_checksums)
    words = isa.encode_program(program)
    meta = program.meta
    golden = run_words(words, x_q, params, meta)
    inj = FaultInjector(words, meta, params, seed=seed)
    cells: Dict[str, Dict[str, int]] = {}
    records: List[Dict[str, object]] = []
    skipped = [s for s in spaces if not inj.targetable(s)]
    for space in spaces:
        if space in skipped:
            continue
        for k in n_flips:
            key = f"{space}|x{k}"
            tally = cells.setdefault(key, {o: 0 for o in OUTCOMES})
            for _ in range(n_faults):
                faults = [inj.sample(space) for _ in range(k)]
                outcome = classify_fault(words, meta, params, x_q,
                                         golden, faults)
                tally[outcome] += 1
                records.append({
                    "space": space, "flips": k, "outcome": outcome,
                    "faults": [dataclasses.asdict(f) for f in faults]})
    return {"protect": bool(protect), "seed": seed, "n_faults": n_faults,
            "skipped_spaces": skipped, "cells": cells, "records": records}


def detection_coverage(program: isa.Program, params: Sequence, x_q, *,
                       n_faults: int = 16, seed: int = 0
                       ) -> Dict[str, int]:
    """The gated cell: single-bit weight + instruction faults with
    parity and weight checksums armed. The gate pins detected == injected
    (no SDC, no masked, no crash — detection fires before anything
    else can)."""
    res = run_campaign(program, params, x_q,
                       spaces=("weights", "instr"), n_faults=n_faults,
                       n_flips=(1,), seed=seed, protect=True,
                       activation_checksums=False)
    w, i = res["cells"]["weights|x1"], res["cells"]["instr|x1"]
    return {"weights_faults": n_faults,
            "weights_detected": w[DETECTED],
            "instr_faults": n_faults,
            "instr_detected": i[DETECTED]}


# --- degraded-mode failover (executor level) --------------------------------


@dataclasses.dataclass
class FailoverReport:
    n_cores: int                 # pipeline width before the dropout
    survivors: int               # cores the replay compile targets
    drop_after_round: int        # schedule rounds completed at the drop
    drained_frames: int          # frames fully retired pre-drop
    replayed_frames: int         # in-flight + unstarted frames replayed


def run_with_dropout(ms, recompile: Callable[[int], object], x_q,
                     params: Sequence, *, drop_after_round: int,
                     batch: int = 1) -> Tuple[np.ndarray, FailoverReport]:
    """Core-dropout failover with bit-exact in-flight replay.

    Plays the canonical frame-pipelined schedule of ``ms`` for
    ``drop_after_round`` rounds, then declares one core dead. Every
    frame group the LAST core has drained is final (the pipeline is
    feed-forward: a drained group left the machine); every other frame
    was in flight or unstarted, so it is replayed from its original
    input through ``recompile(n_cores - 1)`` — the balanced partitioner
    re-partitions the op chain across the survivors (a single survivor
    yields a plain one-stream program). Outputs are the drained prefix
    concatenated with the replay, bit-exact vs the no-fault run because
    both paths are the same golden arithmetic over the same frames.
    """
    n_cores = len(getattr(ms, "streams", ()))
    if n_cores < 2:
        raise ValueError("dropout failover needs a multi-core pipeline "
                         f"(got {n_cores} stream(s))")
    runner = MultiStreamRunner(ms, x_q, params, batch=batch)
    rounds_total = runner.n_groups + n_cores - 1
    rounds = min(max(int(drop_after_round), 0), rounds_total)
    for rnd in range(rounds):
        for core in range(n_cores):
            if 0 <= rnd - core < runner.n_groups:
                runner.step(core)
    drained_groups = min(runner.next_group[n_cores - 1], runner.n_groups)
    drained = min(drained_groups * batch, runner.n_frames)
    x_all, batched = bind_input(x_q, ms.meta)
    replayed = runner.n_frames - drained
    if replayed == 0:
        y = runner.out[:runner.n_frames].copy()
    else:
        prog2 = recompile(n_cores - 1)
        x_rest = x_all[drained:runner.n_frames]
        if hasattr(prog2, "streams"):
            y2 = run_multistream(prog2, x_rest, params, batch=batch)
        else:
            y2 = run_program(prog2, x_rest, params)
        y = np.concatenate(
            [runner.out[:drained], np.asarray(y2, np.int8)], axis=0)
    report = FailoverReport(
        n_cores=n_cores, survivors=n_cores - 1, drop_after_round=rounds,
        drained_frames=int(drained), replayed_frames=int(replayed))
    return (y if batched else y[0]), report
