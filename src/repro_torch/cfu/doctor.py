"""Bottleneck doctor: where every modeled cycle went, and what to do next.

The simulator's raw telemetry (cycle-stamped spans, CSR counters) says
what happened; this module turns it into *diagnosis*. Three layers:

Attribution
-----------
:func:`attribute` classifies **every** cycle of a
``timing.TimingReport`` into an exhaustive, mutually exclusive set of
bound categories (:data:`CATEGORIES`):

* ``exp_mac`` / ``dw_mac`` / ``pw_mac`` — cycles where that MAC array
  binds the pixel pipeline (v3: the single binding substage owns the
  iteration body; v2: the binding stage group; v1/layer-by-layer: every
  stage owns its own sequential cost).
* ``requant``  — cycles bound by the per-pipeline quantize units
  (``ex_q``/``dw_q`` stages) plus the per-pixel fixed overhead
  ``C_PX_FIXED`` (the fusion calibration folds the OUT requant into it).
* ``gap_vec``  — the vector post-processing path (GAP accumulate/divide).
* ``pipeline_fill`` — the per-phase fill iterations of v2/v3 pipelining.
* ``dram_port`` / ``sram_port`` — phases where the memory port, not
  compute, owns the phase (``phase = max(compute, transfer)`` picks the
  transfer side): the port serializes the whole phase, split by which
  port the bytes crossed.
* ``weight_reload`` — structurally ZERO under this model (weights are
  boot-resident; LD_WGT moves bytes but stalls no frame); the category
  exists so the taxonomy stays exhaustive and the claim stays visible.
* ``handoff_sync`` — double-buffer boundary sync; enters at the
  multi-core round level (a single stream's ``total_cycles`` excludes
  it, so it is zero in single-stream attributions).

**Conservation invariant** (as for the trace spans): for every
schedule x streams x batch cell, summing ``categories`` in their
canonical order equals ``TimingReport.total_cycles`` (interval_cycles at
the multi-core level) **bit-exactly**. The decomposition is exact real
arithmetic; the few ULPs of float re-association are repaired into the
dominant category and the repair is asserted tiny
(:class:`ConservationError` if the books don't balance).

What-if sensitivity
-------------------
:func:`what_if` re-prices the SAME compiled program through
``BatchCostModel``/``MultiStreamCostModel`` under finite perturbations —
one more engine per MAC array, a 2x scratch port, free boundary
handoffs, a 2x off-chip port — and reports marginal cycles per unit, so
the output literally ranks the next optimization. Every row carries the
exact ``analyze``/``analyze_multistream`` kwargs of its perturbed
config: re-running the analysis fresh reproduces ``new_cycles``
exactly (tests pin equality, not approximation).
:func:`what_if_schedules` extends the ranking across the other four
schedules of a block (a recompile, same pricing) — this is the row that
surfaces the dw-bound -> fused-winograd story at the winograd gate point
(block 3 at 40x40 under a 9,2,56 engine split).

explain_auto
------------
:func:`explain_auto` renders the per-block per-schedule cost table
``--schedule auto`` already computes internally
(``compiler.auto_schedule_costs``): the pick, the runner-up and the
margin, per block — the *why* of every auto decision.

Surfaced by ``python -m repro_torch.launch.doctor`` (text/JSON + roofline
points through the shared ``repro_torch.roofline.points`` renderer) and the
``--doctor`` flags of ``launch.cfu``/``launch.serve_cfu``. Host code
(Python floats), carried over from ``repro.cfu.doctor`` expression for
expression: the attributions, what-ifs and lines equal the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core.fusion import C_PX_FIXED
from repro_torch.cfu.ir import CFUSchedule, IRProgram
from repro_torch.cfu.isa import Program
from repro_torch.cfu.timing import (CYC_PER_DRAM_BYTE, SRAM_PORT_BYTES,
                              BatchCostModel, MultiStreamCostModel,
                              PEConfig, TimingReport)
from repro_torch.roofline.points import RooflinePoint

# The exhaustive, mutually exclusive bound taxonomy, in canonical order.
# Conservation sums follow THIS order; ties break on it; renderers keep it.
CATEGORIES = (
    "exp_mac",        # expansion / stem-conv MAC array binds
    "dw_mac",         # depthwise MAC lanes (direct or winograd) bind
    "pw_mac",         # projection (pointwise) engines bind
    "requant",        # quantize units + per-pixel fixed overhead bind
    "gap_vec",        # vector post-processing (GAP) path binds
    "pipeline_fill",  # v2/v3 fill iterations, paid once per phase
    "dram_port",      # off-chip port serializes the phase
    "sram_port",      # scratch port serializes the phase
    "weight_reload",  # boot-resident weights: structurally zero
    "handoff_sync",   # dbuf boundary sync (multi-core rounds only)
)

_STAGE_CAT = {"ex_mac": "exp_mac", "ex_q": "requant", "dw_mac": "dw_mac",
              "dw_q": "requant", "pr_mac": "pw_mac", "gap": "gap_vec"}

# Relative budget for the float re-association the conservation repair may
# absorb into the dominant category — anything larger means the
# decomposition itself is wrong, not rounding, and must raise.
_CONSERVE_RTOL = 1e-6


class ConservationError(AssertionError):
    """The bound categories failed to sum (bit-exactly) to the total."""


def _csum(cats: Dict[str, float],
          order: Optional[Sequence[str]] = None) -> float:
    s = 0.0
    for c in (CATEGORIES if order is None else order):
        s += cats[c]
    return s


def _conserve(cats: Dict[str, float], total: float, what: str,
              order: Optional[Sequence[str]] = None) -> None:
    """Repair float re-association until the canonical-order sum equals
    ``total`` bit-exactly.

    The decomposition is exact in real arithmetic; only the few ULPs of
    re-association need absorbing. One free slot is not always enough —
    with a single adjustable category the reachable sums can straddle the
    target on a round-to-even tie and never land on it — so the repair
    walks each nonzero category in turn (smallest first, i.e. finest ULP
    grid first) a few ULPs around its first-order guess until the sum
    lands. Raises loudly if the books are off by more than rounding or
    no slot converges.

    ``order`` overrides the canonical key order (the serving latency
    decomposition reuses this repair with its own component ordering).
    """
    keys = CATEGORIES if order is None else tuple(order)
    err0 = total - _csum(cats, keys)
    if err0 == 0.0:
        return
    budget = _CONSERVE_RTOL * max(abs(total), 1.0)
    if abs(err0) > budget:
        raise ConservationError(
            f"{what}: categories sum to {_csum(cats, keys)!r}, "
            f"total is {total!r} (err {err0!r} > budget {budget!r})")
    # Smallest nonzero slot first: its ULP is the finest step available,
    # so it reaches offsets a coarser slot's grid skips over.
    slots = sorted((c for c in keys if cats[c] > 0.0),
                   key=lambda c: cats[c]) or [keys[0]]
    for dom in slots:
        orig = cats[dom]
        guess = orig + (total - _csum(cats, keys))
        cats[dom] = guess
        if _csum(cats, keys) == total:
            return
        for direction in (float("inf"), float("-inf")):
            x = guess
            for _ in range(64):
                x = math.nextafter(x, direction)
                cats[dom] = x
                if _csum(cats, keys) == total:
                    return
        cats[dom] = orig     # no value of this slot lands; try the next
    raise ConservationError(f"{what}: conservation repair did not converge")


@dataclasses.dataclass
class PhaseAttribution:
    """One BAR-delimited phase's share of the bound taxonomy."""

    label: str
    total_cycles: float
    bound: str                       # "compute" | "memory" | "idle"
    categories: Dict[str, float]


@dataclasses.dataclass
class CycleAttribution:
    """Every cycle of one stream's ``TimingReport``, classified.

    ``categories`` carries ALL of :data:`CATEGORIES` (zeros included) in
    canonical order; summing its values in that order — which is plain
    ``sum(categories.values())``, dicts preserve insertion order —
    equals ``total_cycles`` bit-exactly.
    """

    pipeline: str
    batch: int
    total_cycles: float
    categories: Dict[str, float]
    per_phase: List[PhaseAttribution]

    @property
    def top(self) -> str:
        """The dominant bound category (first maximum in canonical
        order)."""
        return max(CATEGORIES, key=lambda c: self.categories[c])

    def share(self, cat: str) -> float:
        return (self.categories[cat] / self.total_cycles
                if self.total_cycles else 0.0)

    def check(self) -> None:
        """Assert the conservation invariant (cheap; tests hammer it)."""
        if tuple(self.categories) != CATEGORIES:
            raise ConservationError(
                f"category keys {tuple(self.categories)} != canonical set")
        if _csum(self.categories) != self.total_cycles:
            raise ConservationError(
                f"sum {_csum(self.categories)!r} != "
                f"total {self.total_cycles!r}")
        for c, v in self.categories.items():
            if v < 0.0:
                raise ConservationError(f"negative category {c}={v!r}")

    def to_json(self) -> Dict[str, object]:
        return {"pipeline": self.pipeline, "batch": self.batch,
                "total_cycles": self.total_cycles,
                "top": self.top,
                "categories": dict(self.categories),
                "per_phase": [
                    {"label": p.label, "total_cycles": p.total_cycles,
                     "bound": p.bound, "categories": dict(p.categories)}
                    for p in self.per_phase]}


@dataclasses.dataclass
class MultiStreamAttribution:
    """The steady-state round interval of an N-core pipeline, classified.

    Per-core attributions each conserve against their own
    ``total_cycles``; ``categories`` decomposes ``interval_cycles`` as
    the slowest core's story plus its boundary handoffs plus the exposed
    DRAM-port contention (``max(slowest round, serialized port)`` is the
    model's interval expression — the categories mirror it exactly).
    """

    pipeline: str
    batch: int
    interval_cycles: float
    slowest_core: int
    categories: Dict[str, float]
    per_core: List[CycleAttribution]

    @property
    def top(self) -> str:
        return max(CATEGORIES, key=lambda c: self.categories[c])

    def share(self, cat: str) -> float:
        return (self.categories[cat] / self.interval_cycles
                if self.interval_cycles else 0.0)

    def check(self) -> None:
        if tuple(self.categories) != CATEGORIES:
            raise ConservationError(
                f"category keys {tuple(self.categories)} != canonical set")
        if _csum(self.categories) != self.interval_cycles:
            raise ConservationError(
                f"sum {_csum(self.categories)!r} != "
                f"interval {self.interval_cycles!r}")
        for a in self.per_core:
            a.check()

    def to_json(self) -> Dict[str, object]:
        return {"pipeline": self.pipeline, "batch": self.batch,
                "interval_cycles": self.interval_cycles,
                "slowest_core": self.slowest_core,
                "top": self.top,
                "categories": dict(self.categories),
                "per_core": [a.to_json() for a in self.per_core]}


# ---------------------------------------------------------------------------
# Attribution
# ---------------------------------------------------------------------------


def attribute_model(model: BatchCostModel, batch: int = 1
                    ) -> CycleAttribution:
    """Classify every cycle of one walked stream at batch ``batch``.

    Per phase the cycle model is ``max(compute*b + fill, transfer*b)``
    (``BatchCostModel._phase_cycles``, reused verbatim): a compute-bound
    phase decomposes into its fill plus the binding-stage cycles the
    walker recorded plus the fixed per-pixel overhead; a transfer-bound
    phase is owned by its ports, split by where the bytes crossed.
    """
    b = float(batch)
    per_phase: List[PhaseAttribution] = []
    totals = dict.fromkeys(CATEGORIES, 0.0)
    for i, p in enumerate(model.phases):
        total_p = BatchCostModel._phase_cycles(p, b)
        ct = p.compute_cycles * b + p.fill_cycles
        tt = p.transfer_cycles * b
        cats = dict.fromkeys(CATEGORIES, 0.0)
        if total_p <= 0.0:
            bound = "idle"      # weight-only phase: bytes, no cycles
        elif ct >= tt:
            bound = "compute"
            cats["pipeline_fill"] = p.fill_cycles
            for k, v in p.bound_stage_cycles.items():
                cats[_STAGE_CAT[k]] += v * b
            cats["requant"] += C_PX_FIXED * p.n_iters * b
            _conserve(cats, total_p, f"phase {i} ({p.label or 'unnamed'})")
        else:
            bound = "memory"
            dram = min(p.dram_transfer_cycles * b, total_p)
            cats["dram_port"] = dram
            cats["sram_port"] = total_p - dram
            _conserve(cats, total_p, f"phase {i} ({p.label or 'unnamed'})")
        per_phase.append(PhaseAttribution(
            label=p.label or f"phase{i}", total_cycles=total_p,
            bound=bound, categories=cats))
        for c in CATEGORIES:
            totals[c] += cats[c]
    rep = model.report(batch)
    _conserve(totals, rep.total_cycles, "stream total")
    attr = CycleAttribution(pipeline=model.pipeline, batch=batch,
                            total_cycles=rep.total_cycles,
                            categories=totals, per_phase=per_phase)
    attr.check()
    return attr


def attribute(program: Program, pipeline: str = "v3",
              pe: Optional[PEConfig] = None, batch: int = 1,
              sram_port_bytes: Optional[int] = None,
              handoff_sync_cycles: Optional[float] = None,
              dram_cycles_per_byte: Optional[float] = None
              ) -> CycleAttribution:
    """Walk + classify one compiled program (``analyze``'s twin)."""
    return attribute_model(
        BatchCostModel(program, pipeline, pe=pe,
                       sram_port_bytes=sram_port_bytes,
                       handoff_sync_cycles=handoff_sync_cycles,
                       dram_cycles_per_byte=dram_cycles_per_byte), batch)


def attribute_multistream_model(mm: MultiStreamCostModel, batch: int = 1
                                ) -> MultiStreamAttribution:
    """Classify the steady-state round interval of an N-core pipeline."""
    rep = mm.report(batch)
    per_core = [attribute_model(m, batch) for m in mm.models]
    rounds = [r.total_cycles + r.handoff_cycles for r in rep.per_stream]
    slowest = max(range(len(rounds)), key=lambda i: rounds[i])
    cats = dict(per_core[slowest].categories)
    cats["handoff_sync"] += rep.per_stream[slowest].handoff_cycles
    cats["dram_port"] += max(0.0, rep.interval_cycles - rounds[slowest])
    _conserve(cats, rep.interval_cycles, "round interval")
    attr = MultiStreamAttribution(
        pipeline=mm.pipeline, batch=batch,
        interval_cycles=rep.interval_cycles, slowest_core=slowest,
        categories=cats, per_core=per_core)
    attr.check()
    return attr


def attribute_multistream(ms, pipeline: str = "v3", pe=None,
                          batch: int = 1,
                          sram_port_bytes: Optional[int] = None,
                          handoff_sync_cycles: Optional[float] = None,
                          dram_cycles_per_byte: Optional[float] = None
                          ) -> MultiStreamAttribution:
    """Walk + classify a ``MultiStreamProgram``
    (``analyze_multistream``'s twin)."""
    return attribute_multistream_model(
        MultiStreamCostModel(ms, pipeline, pe=pe,
                             sram_port_bytes=sram_port_bytes,
                             handoff_sync_cycles=handoff_sync_cycles,
                             dram_cycles_per_byte=dram_cycles_per_byte),
        batch)


# ---------------------------------------------------------------------------
# What-if sensitivity
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WhatIf:
    """One finite perturbation, priced by the same model as the baseline.

    ``params`` is the complete keyword set of the perturbed analysis —
    passing it back to ``timing.analyze`` (or ``analyze_multistream``
    when ``multistream``) reproduces ``new_cycles`` EXACTLY; the doctor
    never quotes a number the model wouldn't produce fresh.
    """

    name: str
    description: str
    base_cycles: float
    new_cycles: float
    params: Dict[str, object]
    multistream: bool = False
    schedule: Optional[str] = None   # set by what_if_schedules rows

    @property
    def cycles_saved(self) -> float:
        return self.base_cycles - self.new_cycles

    @property
    def speedup(self) -> float:
        return self.base_cycles / self.new_cycles if self.new_cycles \
            else float("inf")

    def to_json(self) -> Dict[str, object]:
        return {"name": self.name, "description": self.description,
                "base_cycles": self.base_cycles,
                "new_cycles": self.new_cycles,
                "cycles_saved": self.cycles_saved,
                "speedup": self.speedup,
                "multistream": self.multistream,
                "schedule": self.schedule}


def rank(what_ifs: Sequence[WhatIf]) -> List[WhatIf]:
    """Largest saving first; name breaks ties deterministically."""
    return sorted(what_ifs, key=lambda w: (-w.cycles_saved, w.name))


def _bump(pe: PEConfig, field: str) -> Optional[PEConfig]:
    v = getattr(pe, field) + 1
    return None if v > 255 else dataclasses.replace(pe, **{field: v})


def _perturbations(eff_sram: int, eff_handoff: Optional[float],
                   eff_dram: float):
    """The four knob families of the tentpole, as (name, desc, kwargs)."""
    return [
        ("sram_port_bytes x2",
         f"double the scratch port ({eff_sram} -> {2 * eff_sram} B/cyc)",
         {"sram_port_bytes": 2 * eff_sram}),
        ("handoff_sync_cycles=0",
         "free double-buffer boundary handoffs",
         {"handoff_sync_cycles": 0.0}),
        ("dram_port x2",
         f"double the off-chip port ({eff_dram:g} -> "
         f"{eff_dram / 2.0:g} cyc/B)",
         {"dram_cycles_per_byte": eff_dram / 2.0}),
    ]


def what_if(program: Program, pipeline: str = "v3",
            pe: Optional[PEConfig] = None, batch: int = 1,
            sram_port_bytes: Optional[int] = None,
            handoff_sync_cycles: Optional[float] = None,
            dram_cycles_per_byte: Optional[float] = None) -> List[WhatIf]:
    """Marginal cycles of the standard perturbations on one stream.

    PE+1 per MAC array (at the stream's EFFECTIVE engine counts — the
    CFG_PE word unless ``pe`` overrides), 2x scratch port, free
    handoffs, 2x DRAM port. Ranked by cycles saved on
    ``total_cycles``.
    """
    base_params = {"pe": pe, "sram_port_bytes": sram_port_bytes,
                   "handoff_sync_cycles": handoff_sync_cycles,
                   "dram_cycles_per_byte": dram_cycles_per_byte}
    m = BatchCostModel(program, pipeline, **base_params)
    base = m.report(batch).total_cycles
    eff_pe = m.pe
    eff_sram = sram_port_bytes if sram_port_bytes is not None \
        else SRAM_PORT_BYTES
    eff_dram = dram_cycles_per_byte if dram_cycles_per_byte is not None \
        else CYC_PER_DRAM_BYTE
    rows: List[WhatIf] = []

    def price(name: str, desc: str, **overrides) -> None:
        params = {**base_params, **overrides}
        new = BatchCostModel(program, pipeline, **params
                             ).report(batch).total_cycles
        rows.append(WhatIf(name=name, description=desc, base_cycles=base,
                           new_cycles=new,
                           params={"pipeline": pipeline, "batch": batch,
                                   **params}))

    for field, engine in (("exp_pes", "expansion engine"),
                          ("dw_lanes", "depthwise lane"),
                          ("proj_engines", "projection engine")):
        bumped = _bump(eff_pe, field)
        if bumped is not None:
            price(f"{field}+1",
                  f"one more {engine} "
                  f"({getattr(eff_pe, field)} -> "
                  f"{getattr(bumped, field)})", pe=bumped)
    for name, desc, kw in _perturbations(eff_sram, handoff_sync_cycles,
                                         eff_dram):
        price(name, desc, **kw)
    return rank(rows)


def what_if_multistream(ms, pipeline: str = "v3", pe=None, batch: int = 1,
                        sram_port_bytes: Optional[int] = None,
                        handoff_sync_cycles: Optional[float] = None,
                        dram_cycles_per_byte: Optional[float] = None
                        ) -> List[WhatIf]:
    """Marginal STEADY-STATE cycles (``interval_cycles``) of the standard
    perturbations on an N-core pipeline. PE bumps are per-core-aware: a
    heterogeneous pipeline gets +1 on EVERY core's own config."""
    base_params = {"pe": pe, "sram_port_bytes": sram_port_bytes,
                   "handoff_sync_cycles": handoff_sync_cycles,
                   "dram_cycles_per_byte": dram_cycles_per_byte}
    mm = MultiStreamCostModel(ms, pipeline, **base_params)
    base = mm.report(batch).interval_cycles
    eff_pes = [m.pe for m in mm.models]
    eff_sram = sram_port_bytes if sram_port_bytes is not None \
        else SRAM_PORT_BYTES
    eff_dram = dram_cycles_per_byte if dram_cycles_per_byte is not None \
        else CYC_PER_DRAM_BYTE
    rows: List[WhatIf] = []

    def price(name: str, desc: str, **overrides) -> None:
        params = {**base_params, **overrides}
        new = MultiStreamCostModel(ms, pipeline, **params
                                   ).report(batch).interval_cycles
        rows.append(WhatIf(name=name, description=desc, base_cycles=base,
                           new_cycles=new, multistream=True,
                           params={"pipeline": pipeline, "batch": batch,
                                   **params}))

    for field, engine in (("exp_pes", "expansion engine"),
                          ("dw_lanes", "depthwise lane"),
                          ("proj_engines", "projection engine")):
        bumped = [_bump(p, field) for p in eff_pes]
        if all(b is not None for b in bumped):
            price(f"{field}+1 (all cores)",
                  f"one more {engine} on every core", pe=bumped)
    for name, desc, kw in _perturbations(eff_sram, handoff_sync_cycles,
                                         eff_dram):
        price(name, desc, **kw)
    return rank(rows)


def what_if_schedules(spec, h: int, w: int, current: CFUSchedule, *,
                      pipeline: str = "v3",
                      pe: Optional[PEConfig] = None, batch: int = 1,
                      tile_rows: int = 4,
                      sram_port_bytes: Optional[int] = None,
                      handoff_sync_cycles: Optional[float] = None,
                      dram_cycles_per_byte: Optional[float] = None
                      ) -> List[WhatIf]:
    """Schedule swaps as what-ifs for ONE block: recompile under each of
    the other schedules and price with the same model/knobs. These are
    the rows that tell the dw-bound -> fused-winograd story."""
    from repro_torch.cfu.compiler import compile_block
    price_params = {"pe": pe, "sram_port_bytes": sram_port_bytes,
                    "handoff_sync_cycles": handoff_sync_cycles,
                    "dram_cycles_per_byte": dram_cycles_per_byte}

    def cycles(s: CFUSchedule) -> float:
        prog = compile_block(spec, h, w, s, pe=pe, tile_rows=tile_rows)
        return BatchCostModel(prog, pipeline, **price_params
                              ).report(batch).total_cycles

    base = cycles(current)
    rows: List[WhatIf] = []
    for s in CFUSchedule:
        if s is current:
            continue
        try:
            new = cycles(s)
        except ValueError:
            continue    # infeasible candidate for this geometry
        rows.append(WhatIf(
            name=f"schedule={s.value}",
            description=f"recompile {current.value} -> {s.value}",
            base_cycles=base, new_cycles=new, schedule=s.value,
            params={"pipeline": pipeline, "batch": batch,
                    "tile_rows": tile_rows, **price_params}))
    return rank(rows)


# ---------------------------------------------------------------------------
# explain_auto
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AutoExplanation:
    """The cost table behind ``--schedule auto``, per block."""

    table: Dict[str, Dict[str, float]]   # block -> schedule name -> cycles
    picks: Dict[str, str]

    def margin(self, block: str) -> float:
        """Runner-up cycles / pick cycles (1.0 = a dead heat)."""
        costs = sorted(self.table[block].values())
        return costs[1] / costs[0] if len(costs) > 1 and costs[0] \
            else float("inf")

    def lines(self) -> List[str]:
        names: List[str] = []
        for costs in self.table.values():
            for s in costs:
                if s not in names:
                    names.append(s)
        out = ["# --schedule auto: per-block candidate cycles "
               "(pick = row argmin; margin = runner-up/pick)",
               ",".join(["block"] + names + ["pick", "margin"])]
        for block, costs in self.table.items():
            cols = [block]
            cols += [format(costs[s], ".4g") if s in costs else "-"
                     for s in names]
            cols += [self.picks[block], f"{self.margin(block):.3f}x"]
            out.append(",".join(cols))
        return out

    def to_json(self) -> Dict[str, object]:
        return {"table": {b: dict(c) for b, c in self.table.items()},
                "picks": dict(self.picks)}


def explain_auto(ir: IRProgram, *, pipeline: str = "v3",
                 pe: Optional[PEConfig] = None,
                 tile_rows: int = 4) -> AutoExplanation:
    """Surface the per-schedule cost table the auto pass optimizes (the
    exact table — ``compiler.auto_schedule_costs`` — not a re-derivation),
    plus each block's pick and margin."""
    from repro_torch.cfu.compiler import auto_schedule_costs
    raw = auto_schedule_costs(ir, pipeline=pipeline, pe=pe,
                              tile_rows=tile_rows)
    table = {b: {s.value: c for s, c in costs.items()}
             for b, costs in raw.items()}
    picks = {b: min(costs, key=costs.get).value
             for b, costs in raw.items()}
    return AutoExplanation(table=table, picks=picks)


# ---------------------------------------------------------------------------
# Roofline points (rendered via the shared repro_torch.roofline.points helper)
# ---------------------------------------------------------------------------


def roofline_point(rep: TimingReport, name: str, *,
                   sram_port_bytes: Optional[int] = None,
                   dram_cycles_per_byte: Optional[float] = None
                   ) -> RooflinePoint:
    """One ``TimingReport`` as a roofline point: achieved MACs/cycle vs
    the engine ceiling and both port ceilings evaluated at this point's
    arithmetic intensity.

    The engine ceiling is ``macs / max(stage busy cycles)`` — the rate if
    the busiest pipeline stage were the only constraint (perfect v3
    overlap, no fill, no stalls). Port ceilings exclude weight bytes:
    boot-resident weights never cross a port at frame time.
    """
    w = sram_port_bytes if sram_port_bytes is not None else SRAM_PORT_BYTES
    d = dram_cycles_per_byte if dram_cycles_per_byte is not None \
        else CYC_PER_DRAM_BYTE
    macs = float(rep.macs)
    dram_data = float(max(rep.dram_bytes - rep.weight_bytes, 0))
    sram = float(rep.sram_bytes)
    ceilings: Dict[str, float] = {}
    if rep.stage_cycles:
        busiest = max(rep.stage_cycles.values())
        ceilings["engine"] = macs / busiest if busiest else float("inf")
    ceilings["dram_port"] = (macs / dram_data) * (1.0 / d) if dram_data \
        else float("inf")
    ceilings["sram_port"] = (macs / sram) * float(w) if sram \
        else float("inf")
    return RooflinePoint(name=name, ops=macs, cycles=rep.total_cycles,
                         ceilings=ceilings,
                         bytes_by_port={"dram_port": dram_data,
                                        "sram_port": sram})


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------


def attribution_lines(attr, *, per_phase: bool = False) -> List[str]:
    """CSV-ish report lines for either attribution flavour."""
    multi = isinstance(attr, MultiStreamAttribution)
    total = attr.interval_cycles if multi else attr.total_cycles
    kind = ("round interval" if multi
            else f"stream total (batch {attr.batch})")
    out = [f"# cycle attribution [{attr.pipeline}]: {kind} = {total:.6g} "
           f"cycles, top bound = {attr.top}",
           "category,cycles,share"]
    for c in CATEGORIES:
        v = attr.categories[c]
        out.append(f"{c},{v:.6g},{attr.share(c):.1%}")
    if multi:
        out.append(f"# slowest core: core{attr.slowest_core}")
        for i, a in enumerate(attr.per_core):
            out.append(f"core{i},{a.total_cycles:.6g},top={a.top}")
    elif per_phase:
        out.append("phase,cycles,bound,top")
        for p in attr.per_phase:
            top = max(CATEGORIES, key=lambda c: p.categories[c])
            out.append(f"{p.label},{p.total_cycles:.6g},{p.bound},"
                       f"{top if p.bound != 'idle' else '-'}")
    return out


def what_if_lines(rows: Sequence[WhatIf]) -> List[str]:
    """The ranked next-optimization table."""
    out = ["# what-if sensitivity (ranked by cycles saved; re-running the "
           "model at each perturbed config reproduces new_cycles exactly)",
           "what_if,base_cycles,new_cycles,cycles_saved,speedup"]
    for r in rows:
        out.append(f"{r.name},{r.base_cycles:.6g},{r.new_cycles:.6g},"
                   f"{r.cycles_saved:.6g},{r.speedup:.3f}x")
    return out
