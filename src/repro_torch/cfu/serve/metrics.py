"""Serving metrics: latency percentiles, throughput, utilization, energy.

Collected incrementally by the dispatcher (per arrival / dispatch /
completion) and summarized once at the end. Latency is request
completion minus request arrival — queueing + batching wait + the
group's modeled pipeline traversal — in cycles, converted to ms at the
configured clock. Utilization is per-core busy time over the simulated
horizon (a 2-core pipeline serving stem-heavy groups shows the imbalance
directly). Energy is frame-weighted over the dispatched groups, so
bigger batches show their amortization (weights loaded once per group,
leak scaled by occupancy).

Latency decomposition (the serving half of the perf doctor): every
completed request's latency splits into :data:`LATENCY_COMPONENTS` —

* ``queue_wait``      — the device front door was busy with earlier
  groups (up to the request's FIRST dispatch).
* ``batch_formation`` — the door was free but the policy held the
  request to grow its batch.
* ``dropout_replay``  — first dispatch to final dispatch: zero unless a
  core dropout voided the request's in-flight group and replayed it.
* ``service_exec``    — the final group's initiation interval (the
  device's own round time for that batch size).
* ``pipeline_fill``   — the rest of the pipe traversal beyond one
  interval (the N-core fill a lone group pays).

The components are exhaustive and sum to ``latency`` **bit-exactly** per
request (same ULP-repair discipline as ``repro_torch.cfu.doctor``).

Per-core busy time is tracked against PHYSICAL core ids: a
``DropoutEvent`` removes the dead core from the live map, so
post-dropout dispatches credit the surviving cores' own slots, and the
work a voided group never actually executed (the flight fraction after
the drop instant) is un-credited rather than left inflating
utilization. Work the voided group DID do before the drop stays
counted, on the cores where it accrued.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.cfu.doctor import _conserve
from repro_torch.cfu.trace import CAT_SERVE, NULL_TRACER, Tracer

#: Canonical order of the request-latency decomposition; conservation
#: sums (and the summary renderer) follow this order.
LATENCY_COMPONENTS = ("queue_wait", "batch_formation", "dropout_replay",
                      "service_exec", "pipeline_fill")

#: Trace pid of the serving layer — offset far above the per-core model
#: pids so device timeline and request timeline coexist in one file.
SERVE_PID = 1000


@dataclasses.dataclass
class RequestRecord:
    rid: int
    t_arrival: float
    t_dispatch: Optional[float] = None
    t_complete: Optional[float] = None
    batch_id: Optional[int] = None
    # first-dispatch bookkeeping for the latency decomposition; sticky —
    # a dropout replay unwinds t_dispatch/batch_id but never these, so
    # (t_dispatch - t_first_dispatch) is exactly the replay penalty
    t_first_dispatch: Optional[float] = None
    first_free_t: Optional[float] = None   # device-free time at 1st dispatch

    @property
    def latency(self) -> Optional[float]:
        if self.t_complete is None:
            return None
        return self.t_complete - self.t_arrival


@dataclasses.dataclass
class BatchRecord:
    bid: int
    size: int
    t_entry: float
    t_complete: float       # scheduled exit; phantom if ``voided``
    energy_pj: float
    rids: List[int]
    voided: bool = False    # killed by a core dropout before completing
    entry_interval: float = 0.0   # front-door occupancy of this group
    # per-core busy credited at dispatch + the PHYSICAL core each entry
    # landed on, so a dropout can un-credit exactly what it voids
    busy_cycles: List[float] = dataclasses.field(default_factory=list)
    core_map: List[int] = dataclasses.field(default_factory=list)


class MetricsCollector:
    def __init__(self, n_cores: int, freq_hz: float,
                 tracer: Optional[Tracer] = None,
                 slo_cycles: Optional[float] = None,
                 slo_target: float = 0.99):
        if not 0.0 < slo_target < 1.0:
            raise ValueError(
                f"slo_target must be in (0, 1), got {slo_target}")
        self.n_cores = n_cores
        self.freq_hz = freq_hz
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.slo_cycles = slo_cycles
        self.slo_target = slo_target
        self.slo_violations = 0
        self.requests: List[RequestRecord] = []
        self.batches: List[BatchRecord] = []
        self.core_busy = [0.0] * n_cores
        # physical ids of the live cores, in stage order: dispatch i-th
        # busy entry -> core_busy[_core_map[i]]; a dropout removes its id
        self._core_map: List[int] = list(range(n_cores))
        self.dropouts: List[Dict[str, object]] = []
        self.queue_trace: List[tuple] = []   # (time, depth) at each change
        # in-flight batch slots for trace rendering: slot i is free again
        # at _slot_free[i]; a dispatched group takes the first free slot,
        # so overlapping in-flight groups land on separate thread rows
        self._slot_free: List[float] = []
        self.tracer.process_name(SERVE_PID, "serving (sim-cycle time)")
        self.tracer.thread_name(SERVE_PID, 0, "markers")

    # --- recording --------------------------------------------------------

    def on_arrival(self, rid: int, t: float, depth: int) -> None:
        assert rid == len(self.requests), "rids must be dense and ordered"
        self.requests.append(RequestRecord(rid=rid, t_arrival=t))
        self.queue_trace.append((t, depth))
        self.tracer.counter("queue_depth", t, depth, pid=SERVE_PID,
                            series="depth")

    def _alloc_slot(self, t_entry: float, t_complete: float) -> int:
        for i, free in enumerate(self._slot_free):
            if free <= t_entry:
                self._slot_free[i] = t_complete
                return i
        self._slot_free.append(t_complete)
        slot = len(self._slot_free) - 1
        self.tracer.thread_name(SERVE_PID, slot + 1,
                                f"in-flight slot {slot}")
        return slot

    def on_dispatch(self, bid: int, rids: List[int], t_entry: float,
                    t_complete: float, energy_pj: float,
                    busy_cycles: List[float], depth: int,
                    free_t: float = 0.0,
                    entry_interval: Optional[float] = None) -> None:
        if len(busy_cycles) != len(self._core_map):
            raise ValueError(
                f"dispatch carries {len(busy_cycles)} per-core busy "
                f"entries but {len(self._core_map)} cores are live")
        if entry_interval is None:     # single-server degenerate default
            entry_interval = t_complete - t_entry
        core_map = list(self._core_map)
        self.batches.append(BatchRecord(
            bid=bid, size=len(rids), t_entry=t_entry,
            t_complete=t_complete, energy_pj=energy_pj, rids=list(rids),
            entry_interval=entry_interval,
            busy_cycles=list(busy_cycles), core_map=core_map))
        for rid in rids:
            r = self.requests[rid]
            r.t_dispatch = t_entry
            r.batch_id = bid
            if r.t_first_dispatch is None:
                r.t_first_dispatch = t_entry
                r.first_free_t = free_t
        for i, b in enumerate(busy_cycles):
            self.core_busy[core_map[i]] += b
        self.queue_trace.append((t_entry, depth))
        self.tracer.counter("queue_depth", t_entry, depth, pid=SERVE_PID,
                            series="depth")
        slot = self._alloc_slot(t_entry, t_complete)
        self.tracer.span(f"batch{bid} (B={len(rids)})", t_entry,
                         t_complete - t_entry, pid=SERVE_PID, tid=slot + 1,
                         cat=CAT_SERVE,
                         args={"bid": bid, "size": len(rids),
                               "energy_pj": energy_pj})

    def on_complete(self, rids: List[int], t: float) -> None:
        for rid in rids:
            self.requests[rid].t_complete = t
            if self.slo_cycles is not None:
                lat = self.requests[rid].latency
                if lat is not None and lat > self.slo_cycles:
                    self.slo_violations += 1
                    self.tracer.instant(
                        "slo_violation", t, pid=SERVE_PID, tid=0,
                        cat=CAT_SERVE,
                        args={"rid": rid, "latency_cycles": lat,
                              "slo_cycles": self.slo_cycles})

    def on_dropout(self, t: float, core: int, replayed_rids: List[int],
                   voided_bids: List[int], n_cores: int) -> None:
        """A core died: its in-flight requests go back to the queue.

        The voided batches' dispatch bookkeeping is unwound (their
        requests will be re-dispatched by the degraded device). Busy
        time splits honestly at the drop instant: the flight fraction a
        voided group completed before ``t`` stays counted (that work WAS
        done, and hiding it would flatter the failover), while the
        remainder — cycles the dead pipeline never executed — is
        un-credited from each physical core's slot. The dead core then
        leaves the live map, so later dispatches (with one fewer busy
        entry) credit the surviving cores' own slots instead of
        shifting everything down one index.
        """
        for rid in replayed_rids:
            self.requests[rid].t_dispatch = None
            self.requests[rid].batch_id = None
        for bid in voided_bids:
            b = self.batches[bid]
            b.voided = True
            span = b.t_complete - b.t_entry
            done = 1.0 if span <= 0 else min(
                1.0, max(0.0, (t - b.t_entry) / span))
            for i, busy in enumerate(b.busy_cycles):
                self.core_busy[b.core_map[i]] -= (1.0 - done) * busy
        if core in self._core_map:
            self._core_map.remove(core)
        self.dropouts.append({
            "t_cycles": t, "core": core,
            "n_replayed": len(replayed_rids),
            "n_batches_voided": len(voided_bids),
            "n_cores_after": n_cores})
        self.tracer.instant(
            "core_dropout", t, pid=SERVE_PID, tid=0, cat=CAT_SERVE,
            args={"core": core, "replayed": len(replayed_rids),
                  "voided_bids": list(voided_bids)})

    # --- latency decomposition + SLO burn ---------------------------------

    def decompose(self, rid: int) -> Optional[Dict[str, float]]:
        """Split one completed request's latency into
        :data:`LATENCY_COMPONENTS` — exhaustive, each >= 0, summing to
        ``latency`` bit-exactly. ``None`` until the request completes."""
        r = self.requests[rid]
        if r.t_complete is None or r.batch_id is None:
            return None
        b = self.batches[r.batch_id]
        # the instant the request STOPPED waiting on a busy front door:
        # the door's free time, clamped into [arrival, first dispatch]
        m = min(max(r.t_arrival, r.first_free_t), r.t_first_dispatch)
        comp = {
            "queue_wait": m - r.t_arrival,
            "batch_formation": r.t_first_dispatch - m,
            "dropout_replay": r.t_dispatch - r.t_first_dispatch,
            "service_exec": b.entry_interval,
            "pipeline_fill": max(
                0.0, (r.t_complete - r.t_dispatch) - b.entry_interval),
        }
        _conserve(comp, r.latency, f"request {rid} latency decomposition",
                  order=LATENCY_COMPONENTS)
        return comp

    def burn_rates(self) -> Optional[Dict[str, object]]:
        """SLO error-budget burn: ``violation_fraction / (1 - target)``.

        1.0 means violations land exactly at the budgeted rate; above
        1.0 the budget is burning down faster than the SLO allows. The
        windowed rate splits completions (in completion order) into up
        to 10 equal windows and reports the worst — a short brown-out
        (a dropout replay storm) shows up here long before it moves the
        overall rate. ``None`` until the SLO is set and something
        completed."""
        if self.slo_cycles is None:
            return None
        done = sorted((r for r in self.requests if r.t_complete is not None),
                      key=lambda r: r.t_complete)
        if not done:
            return None
        viol = np.array([r.latency > self.slo_cycles for r in done],
                        dtype=float)
        budget = 1.0 - self.slo_target
        frac = float(viol.mean())
        n_windows = min(10, viol.size)
        windows = np.array_split(viol, n_windows)
        worst = max(float(w.mean()) for w in windows)
        return {
            "slo_target": self.slo_target,
            "violation_fraction": frac,
            "burn_rate": frac / budget,
            "burn_rate_max_windowed": worst / budget,
            "n_windows": n_windows,
        }

    # --- summary ----------------------------------------------------------

    def summary(self) -> Dict[str, object]:
        lat = np.array([r.latency for r in self.requests
                        if r.latency is not None])
        served = int(lat.size)
        n_arr = len(self.requests)
        horizon = max((b.t_complete for b in self.batches
                       if not b.voided), default=0.0)
        ms = 1e3 / self.freq_hz
        out: Dict[str, object] = {
            "n_arrivals": n_arr,
            "n_served": served,
            "drained": served == n_arr,
            "n_batches": len(self.batches),
            "horizon_cycles": horizon,
            "horizon_s": horizon / self.freq_hz,
        }
        if served:
            pct = {p: float(np.percentile(lat, p)) for p in (50, 95, 99)}
            out.update({
                "latency_p50_cycles": pct[50],
                "latency_p95_cycles": pct[95],
                "latency_p99_cycles": pct[99],
                "latency_p50_ms": pct[50] * ms,
                "latency_p95_ms": pct[95] * ms,
                "latency_p99_ms": pct[99] * ms,
                "latency_mean_ms": float(lat.mean()) * ms,
                "latency_max_ms": float(lat.max()) * ms,
            })
            comps = [self.decompose(r.rid) for r in self.requests
                     if r.t_complete is not None]
            out["latency_breakdown_cycles"] = {
                k: float(np.mean([c[k] for c in comps]))
                for k in LATENCY_COMPONENTS}
            out["latency_breakdown_ms"] = {
                k: v * ms
                for k, v in out["latency_breakdown_cycles"].items()}
        if horizon > 0:
            out["throughput_qps"] = served * self.freq_hz / horizon
            out["utilization"] = [b / horizon for b in self.core_busy]
        if self.batches:
            sizes = np.array([b.size for b in self.batches])
            frames = int(sizes.sum())
            out["mean_batch"] = float(sizes.mean())
            out["batch_hist"] = {
                int(s): int(n) for s, n in
                zip(*np.unique(sizes, return_counts=True))}
            out["energy_per_frame_uj"] = float(
                sum(b.energy_pj for b in self.batches) / frames / 1e6)
        if self.queue_trace:
            depths = np.array([d for _, d in self.queue_trace])
            out["queue_depth_mean"] = float(depths.mean())
            out["queue_depth_max"] = int(depths.max())
        if self.slo_cycles is not None:
            out["slo_cycles"] = self.slo_cycles
            out["slo_violations"] = self.slo_violations
            burn = self.burn_rates()
            if burn is not None:
                out["slo_burn"] = burn
        if self.dropouts:      # keys only exist when a dropout occurred
            out["dropouts"] = list(self.dropouts)
            out["n_replayed"] = int(
                sum(d["n_replayed"] for d in self.dropouts))
        return out
