"""The serving simulator: arrivals -> queue -> policy -> device.

One :class:`ServingSimulator` owns a FIFO request queue, a batching
policy, and a :class:`~repro_torch.cfu.serve.service.ServiceModel` device, and
plays a seeded arrival schedule through them as a discrete-event loop:

* ``arrival``    — the request joins the queue; the policy is consulted.
* ``entry_free`` — the device front door frees up (one initiation
  interval after the previous group entered); the policy is consulted.
* ``poll``       — a policy deadline (batching timeout) fires; consult.
* ``complete``   — a dispatched group exits the pipeline; its requests'
  latencies are final.
* ``dropout``    — a core dies mid-simulation (:class:`DropoutEvent`):
  the device is swapped for its degraded (survivors-only) twin, every
  in-flight group is voided and its requests re-queued at the FRONT of
  the queue in original order (the failover replay — the executor-level
  analogue, ``faults.run_with_dropout``, proves the replay bit-exact),
  and late ``complete`` events for voided groups are ignored as stale.
  Requests are still conserved; the p99 impact of the dropout is just
  the summary diff against the same run without the event.

Dispatching a group of B requests at time t occupies the front door
until ``t + entry_interval_cycles(B)`` and completes at
``t + group_latency_cycles(B)`` — the initiation-interval/latency split
of the frame pipeline (``timing.analyze_multistream``), so an N-core
device overlaps up to N in-flight groups exactly like the executor's
canonical round schedule. Single-core devices degenerate to a busy
server (interval == latency).

Honesty: if a :class:`~repro_torch.cfu.serve.check.DifferentialSpotCheck` is
attached, sampled dispatched batches are ALSO executed bit-exactly
through the golden executor mid-simulation; a divergence aborts the run
(``SpotCheckError``) rather than produce free-floating numbers.

Determinism: arrivals are a precomputed seeded schedule, policies are
deterministic, and the event queue breaks time ties by insertion order —
so one seed fixes the event log exactly (tested).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.cfu.serve import events as ev
from repro_torch.cfu.serve.check import DifferentialSpotCheck
from repro_torch.cfu.serve.metrics import MetricsCollector
from repro_torch.cfu.serve.policies import Policy, QueueView
from repro_torch.cfu.serve.service import ServiceModel

# log entries: ("arrival", t, rid) / ("dispatch", t, bid, size, rids)
#            / ("complete", t, bid) / ("poll", t)
#            / ("dropout", t, core, voided_bids) / ("stale_complete", t, bid)
LogEntry = Tuple


@dataclasses.dataclass(frozen=True)
class DropoutEvent:
    """One core dies at ``at_cycles``: serve the rest of the run on
    ``degraded`` (the surviving-cores service model — compile the same
    network with ``streams - 1``), replaying every in-flight request.
    ``repartition_cycles`` is the failover dead time before the degraded
    device accepts its first group (checkpoint restore + re-partition
    DMA); 0 models instant failover."""

    at_cycles: float
    degraded: ServiceModel
    core: int = 0
    repartition_cycles: float = 0.0


@dataclasses.dataclass
class SimResult:
    summary: Dict[str, object]
    event_log: List[LogEntry]
    metrics: MetricsCollector

    @property
    def requests(self):
        return self.metrics.requests

    @property
    def batches(self):
        return self.metrics.batches


class ServingSimulator:
    def __init__(self, service: ServiceModel, policy: Policy,
                 arrivals: np.ndarray,
                 spot_check: Optional[DifferentialSpotCheck] = None,
                 max_events: Optional[int] = None,
                 tracer=None, slo_cycles: Optional[float] = None,
                 slo_target: float = 0.99,
                 dropout: Optional[DropoutEvent] = None):
        self.service = service
        self.dropout = dropout
        self.policy = policy
        self.arrivals = np.asarray(arrivals, dtype=float)
        if self.arrivals.ndim != 1:
            raise ValueError("arrivals must be a 1-D array of cycle times")
        if np.any(np.diff(self.arrivals) < 0):
            raise ValueError("arrivals must be sorted")
        self.spot_check = spot_check
        self.tracer = tracer           # observes only; None = no tracing
        self.slo_cycles = slo_cycles   # SLO-violation instants + summary
        self.slo_target = slo_target   # availability target for burn rates
        # every request needs an arrival, a dispatch consult, a share of
        # one completion, and possibly a poll: 8x + slack is generous,
        # and hitting it means a policy is livelocking — fail loudly.
        self.max_events = max_events or (8 * len(self.arrivals) + 256)

    def run(self) -> SimResult:
        q = ev.EventQueue()
        queue: collections.deque = collections.deque()   # rids, FIFO
        arrival_time: List[float] = list(self.arrivals)
        metrics = MetricsCollector(n_cores=self.service.n_stages,
                                   freq_hz=self.service.freq_hz,
                                   tracer=self.tracer,
                                   slo_cycles=self.slo_cycles,
                                   slo_target=self.slo_target)
        log: List[LogEntry] = []
        service = self.service    # swapped for the degraded twin on dropout
        next_entry = 0.0          # earliest cycle the device can accept
        next_bid = 0
        poll_at: Optional[float] = None   # earliest outstanding POLL
        inflight: Dict[int, List[int]] = {}   # bid -> rids, until COMPLETE
        voided: set = set()                   # bids killed by a dropout

        for rid, t in enumerate(arrival_time):
            q.push(t, ev.ARRIVAL, rid=rid)
        if self.dropout is not None:
            q.push(self.dropout.at_cycles, ev.DROPOUT)

        def try_dispatch(now: float):
            nonlocal next_entry, next_bid, poll_at
            while True:
                view = QueueView(
                    now=now, queue_len=len(queue),
                    oldest_arrival=(arrival_time[queue[0]] if queue
                                    else None),
                    device_ready=next_entry <= now,
                    next_entry_time=next_entry)
                n = self.policy.decide(view)
                if n <= 0:
                    if queue and view.device_ready:
                        # holding by choice: honour the policy's deadline
                        deadline = self.policy.next_deadline(view)
                        if deadline is not None and (
                                poll_at is None or deadline < poll_at):
                            deadline = max(deadline, now)
                            q.push(deadline, ev.POLL)
                            poll_at = deadline
                    return
                n = min(n, len(queue), service.max_batch)
                rids = [queue.popleft() for _ in range(n)]
                bid = next_bid
                next_bid += 1
                free_t = next_entry   # when the front door last freed up
                interval = service.entry_interval_cycles(n)
                latency = service.group_latency_cycles(n)
                next_entry = now + interval
                t_done = now + latency
                q.push(next_entry, ev.ENTRY_FREE)
                q.push(t_done, ev.COMPLETE, bid=bid, rids=rids)
                inflight[bid] = list(rids)
                metrics.on_dispatch(
                    bid=bid, rids=rids, t_entry=now, t_complete=t_done,
                    energy_pj=service.energy_pj(n),
                    busy_cycles=service.core_busy_cycles(n),
                    depth=len(queue),
                    free_t=free_t, entry_interval=interval)
                log.append(("dispatch", now, bid, n, tuple(rids)))
                if self.spot_check is not None and \
                        self.spot_check.wants(bid):
                    self.spot_check.check(bid, n)

        n_events = 0
        while q:
            e = q.pop()
            n_events += 1
            if n_events > self.max_events:
                raise RuntimeError(
                    f"simulation exceeded {self.max_events} events — "
                    f"the policy {self.policy.name!r} is not making "
                    f"progress")
            if e.kind == ev.ARRIVAL:
                rid = e.payload["rid"]
                self.policy.observe_arrival(e.time)
                queue.append(rid)
                metrics.on_arrival(rid, e.time, depth=len(queue))
                log.append(("arrival", e.time, rid))
                try_dispatch(e.time)
            elif e.kind == ev.ENTRY_FREE:
                try_dispatch(e.time)
            elif e.kind == ev.POLL:
                if poll_at is not None and e.time >= poll_at:
                    poll_at = None
                log.append(("poll", e.time))
                try_dispatch(e.time)
            elif e.kind == ev.COMPLETE:
                bid = e.payload["bid"]
                if bid in voided:
                    # the pipeline that would have produced this result
                    # died; its requests were already re-queued
                    log.append(("stale_complete", e.time, bid))
                    continue
                inflight.pop(bid, None)
                metrics.on_complete(e.payload["rids"], e.time)
                log.append(("complete", e.time, bid))
            elif e.kind == ev.DROPOUT:
                d = self.dropout
                dead_bids = sorted(inflight)
                replay = [rid for bid in dead_bids for rid in inflight[bid]]
                voided.update(dead_bids)
                inflight.clear()
                # re-queue in original dispatch order, at the queue FRONT:
                # in-flight work has queue priority over waiting arrivals
                queue.extendleft(reversed(replay))
                service = d.degraded
                next_entry = e.time + d.repartition_cycles
                metrics.on_dropout(e.time, core=d.core,
                                   replayed_rids=replay,
                                   voided_bids=dead_bids,
                                   n_cores=service.n_stages)
                log.append(("dropout", e.time, d.core, tuple(dead_bids)))
                q.push(next_entry, ev.ENTRY_FREE)
            else:
                raise ValueError(f"unknown event kind {e.kind!r}")

        summary = metrics.summary()
        summary["policy"] = self.policy.describe()
        summary["device"] = self.service.describe()
        if self.dropout is not None:
            summary["device_degraded"] = self.dropout.degraded.describe()
        if self.spot_check is not None:
            summary["spot_checks"] = self.spot_check.summary()
        return SimResult(summary=summary, event_log=log, metrics=metrics)
