"""The device under test: a compiled CFU program as a pipelined server.

Wraps one compiled program — a single-core ``isa.Program`` or an N-core
``compiler.MultiStreamProgram`` — together with its batch-cost model
(``timing.BatchCostModel`` / ``MultiStreamCostModel``: one instruction
walk, any batch priced from the cached phases) and exposes the two
quantities a discrete-event dispatcher needs per dispatched frame group
of B requests:

* ``entry_interval_cycles(B)`` — how long the device front door stays
  busy: the next group may enter one initiation interval later. For the
  N-core frame pipeline this is ``analyze_multistream(batch=B)``'s
  steady-state ``interval_cycles`` (slowest core round vs the serialized
  DRAM port); for a single core it equals the full service time.
* ``group_latency_cycles(B)`` — arrival-to-exit time of the group:
  ``cycles_for_frames(B)`` (the group traverses all N pipeline stages,
  one round each) for multi-stream, ``total_cycles`` for single.

These are exactly the executor's semantics: ``MultiStreamRunner``'s
canonical schedule starts group *g* on core 0 in round *g* and retires
it from core N-1 in round *g + N - 1* — entry every interval, exit N
intervals later. The differential spot checker (``serve.check``) holds
the simulator to that story bit-exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

from repro_torch.cfu.compiler import MultiStreamProgram
from repro_torch.cfu.timing import (BatchCostModel, MultiStreamCostModel,
                              MultiStreamReport, PEConfig, TimingReport)

Report = Union[TimingReport, MultiStreamReport]


class ServiceModel:
    """Batch-priced pipelined-server view of one compiled CFU program."""

    def __init__(self, prog, pipeline: str = "v3",
                 pe: Optional[PEConfig] = None,
                 freq_hz: float = 300e6,
                 max_batch: int = 64,
                 sram_port_bytes: Optional[int] = None,
                 handoff_sync_cycles: Optional[float] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.prog = prog
        self.pipeline = pipeline
        self.freq_hz = float(freq_hz)
        self.max_batch = max_batch
        self.is_multistream = isinstance(prog, MultiStreamProgram)
        if self.is_multistream:
            self._cost = MultiStreamCostModel(
                prog, pipeline, pe=pe, sram_port_bytes=sram_port_bytes,
                handoff_sync_cycles=handoff_sync_cycles)
            self.n_stages = self._cost.n_cores
        else:
            self._cost = BatchCostModel(
                prog, pipeline, pe=pe, sram_port_bytes=sram_port_bytes,
                handoff_sync_cycles=handoff_sync_cycles)
            self.n_stages = 1
        self._reports: Dict[int, Report] = {}

    def emit_model_trace(self, tracer, batch: int = 1, *,
                         pid_base: int = 0) -> float:
        """Emit the device's modeled per-phase timeline (one frame group
        at ``batch``) into ``tracer`` — the reference lane a serving trace
        is read against. Returns the end timestamp."""
        if self.is_multistream:
            return self._cost.emit_trace(tracer, batch, pid_base=pid_base)
        tracer.process_name(pid_base, "core0-model (cycle time)")
        return self._cost.emit_trace(tracer, batch, pid=pid_base)

    # --- pricing ----------------------------------------------------------

    def report(self, batch: int) -> Report:
        if not 1 <= batch <= self.max_batch:
            raise ValueError(
                f"batch {batch} outside [1, {self.max_batch}]")
        rep = self._reports.get(batch)
        if rep is None:
            rep = self._reports[batch] = self._cost.report(batch)
        return rep

    def entry_interval_cycles(self, batch: int) -> float:
        rep = self.report(batch)
        return (rep.interval_cycles if self.is_multistream
                else rep.total_cycles)

    def group_latency_cycles(self, batch: int) -> float:
        rep = self.report(batch)
        return (rep.cycles_for_frames(batch) if self.is_multistream
                else rep.total_cycles)

    def energy_pj(self, batch: int) -> float:
        """Total energy of serving one group of ``batch`` frames."""
        return self.report(batch).energy_pj["total"]

    def core_busy_cycles(self, batch: int) -> List[float]:
        """Per-core busy time while one group traverses the pipeline."""
        rep = self.report(batch)
        if self.is_multistream:
            return [r.total_cycles + r.handoff_cycles
                    for r in rep.per_stream]
        return [rep.total_cycles]

    # --- throughput ceilings (used by the adaptive policy + planner) ------

    def service_rate_qps(self, batch: int) -> float:
        """Saturated throughput at fixed group size: B frames enter every
        initiation interval."""
        return batch * self.freq_hz / self.entry_interval_cycles(batch)

    def slo_feasible(self, slo_cycles: float) -> bool:
        """Whether ANY group size meets the SLO unloaded — i.e. whether
        even a lone batch-1 request fits its pipe traversal under the
        deadline. An infeasible SLO means every request violates by
        construction, regardless of policy."""
        return self.group_latency_cycles(1) <= slo_cycles

    def best_batch_under_slo(self, slo_cycles: float) -> int:
        """Largest (throughput-maximal) group size whose unloaded pipe
        traversal still fits the SLO.

        Raises ``ValueError`` when not even batch 1 fits: silently
        returning 1 used to let an unmeetable SLO configure a policy that
        then violated on 100% of requests with no hint the deadline was
        impossible for this device. Check :meth:`slo_feasible` first to
        branch instead of catching.
        """
        if not self.slo_feasible(slo_cycles):
            raise ValueError(
                f"SLO of {slo_cycles:.0f} cycles is infeasible: a lone "
                f"batch-1 group needs {self.group_latency_cycles(1):.0f} "
                "cycles to traverse the pipeline — every request would "
                "violate. Relax the SLO or use a faster device config.")
        best, best_rate = 1, 0.0
        for b in range(1, self.max_batch + 1):
            if self.group_latency_cycles(b) > slo_cycles:
                break
            rate = self.service_rate_qps(b)
            if rate > best_rate:
                best, best_rate = b, rate
        return best

    # --- description (for JSON reports) -----------------------------------

    def describe(self) -> Dict[str, object]:
        d: Dict[str, object] = {
            "pipeline": self.pipeline,
            "n_stages": self.n_stages,
            "freq_mhz": self.freq_hz / 1e6,
            "multistream": self.is_multistream,
        }
        if self.is_multistream:
            d["pe_per_core"] = [dataclasses.asdict(p)
                                for p in self.prog.meta["pe_per_core"]]
            d["hetero"] = self.prog.meta.get("hetero", False)
        return d
