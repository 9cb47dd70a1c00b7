"""Dynamic-batching policies: when to dispatch how many queued requests.

The dispatcher consults the policy with a :class:`QueueView` snapshot at
every decision point (a request arrives, the device frees up, a policy
timer fires) and the policy answers with a group size to dispatch now
(0 = keep holding). A holding policy may also name a deadline — the
dispatcher schedules a POLL event so timeouts fire at exact simulated
times, not "next arrival".

* ``immediate``  — dispatch as soon as the device can accept, up to
  ``batch_cap`` requests at once. ``batch_cap=1`` is the classic
  no-batching baseline the serving gate compares against.
* ``timeout``    — fixed-size-with-timeout (the standard serving
  batcher): wait for ``batch_cap`` requests, but never make the oldest
  request wait longer than ``timeout_cycles`` before dispatching
  whatever is queued.
* ``adaptive``   — model-predictive window: estimates the arrival rate
  (EWMA of inter-arrival gaps) and asks the device's cost model for the
  smallest group size whose saturated service rate clears that load
  with margin — batching exactly as much as the load requires and the
  SLO allows, with its timeout set to the remaining latency headroom.

All policies are deterministic functions of the observed event history,
so a fixed seed fixes the whole simulation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.cfu.serve.service import ServiceModel


@dataclasses.dataclass(frozen=True)
class QueueView:
    """What a policy may look at when deciding."""

    now: float                       # current simulated time (cycles)
    queue_len: int                   # requests waiting
    oldest_arrival: Optional[float]  # arrival time of the head request
    device_ready: bool               # the device can accept a group now
    next_entry_time: float           # earliest cycle the device frees up


class Policy:
    """Base: subclasses override :meth:`decide` (and optionally
    :meth:`next_deadline` / :meth:`observe_arrival`)."""

    name = "base"

    def decide(self, q: QueueView) -> int:
        raise NotImplementedError

    def next_deadline(self, q: QueueView) -> Optional[float]:
        """When a holding decision must be revisited (None = only on the
        next arrival/completion)."""
        return None

    def observe_arrival(self, t: float) -> None:
        """Called once per arrival, in order (adaptive state hook)."""

    def describe(self) -> Dict[str, object]:
        return {"policy": self.name}


class ImmediatePolicy(Policy):
    name = "immediate"

    def __init__(self, batch_cap: int = 1):
        if batch_cap < 1:
            raise ValueError(f"batch_cap must be >= 1, got {batch_cap}")
        self.batch_cap = batch_cap

    def decide(self, q: QueueView) -> int:
        if not q.device_ready or q.queue_len == 0:
            return 0
        return min(q.queue_len, self.batch_cap)

    def describe(self):
        return {"policy": self.name, "batch_cap": self.batch_cap}


class TimeoutPolicy(Policy):
    name = "timeout"

    def __init__(self, batch_cap: int = 4, timeout_cycles: float = 1.5e6):
        if batch_cap < 1:
            raise ValueError(f"batch_cap must be >= 1, got {batch_cap}")
        if timeout_cycles < 0:
            raise ValueError(f"timeout_cycles must be >= 0, "
                             f"got {timeout_cycles}")
        self.batch_cap = batch_cap
        self.timeout_cycles = timeout_cycles

    def decide(self, q: QueueView) -> int:
        if not q.device_ready or q.queue_len == 0:
            return 0
        if q.queue_len >= self.batch_cap:
            return self.batch_cap
        # the SAME float expression as next_deadline, so a poll scheduled
        # at the deadline always finds the timeout expired (comparing
        # `now - oldest >= timeout` instead can round the other way and
        # livelock the poll loop at one instant)
        if q.now >= q.oldest_arrival + self.timeout_cycles:
            return q.queue_len
        return 0

    def next_deadline(self, q: QueueView) -> Optional[float]:
        if q.queue_len == 0:
            return None
        return q.oldest_arrival + self.timeout_cycles

    def describe(self):
        return {"policy": self.name, "batch_cap": self.batch_cap,
                "timeout_cycles": self.timeout_cycles}


class AdaptivePolicy(Policy):
    """Load-tracking window: batch as much as the estimated arrival rate
    needs (with ``margin`` headroom) and the SLO permits, no more."""

    name = "adaptive"

    def __init__(self, service: ServiceModel, slo_cycles: float,
                 batch_cap: int = 8, margin: float = 1.25,
                 ewma_alpha: float = 0.1):
        if batch_cap < 1:
            raise ValueError(f"batch_cap must be >= 1, got {batch_cap}")
        self.service = service
        self.slo_cycles = slo_cycles
        self.batch_cap = batch_cap
        self.margin = margin
        self.ewma_alpha = ewma_alpha
        self._last_arrival: Optional[float] = None
        self._gap_ewma: Optional[float] = None   # cycles between arrivals
        self._target = 1                         # current window (hysteresis)
        # the SLO bounds the usable window regardless of load
        self._slo_cap = max(1, min(
            batch_cap, service.best_batch_under_slo(slo_cycles)))
        # ... and so does the service-rate curve: past the knee where
        # batching stops buying throughput (fill is amortized, the
        # interval scales linearly), a bigger group is pure latency loss.
        # The knee = the smallest window within 2% of the best rate.
        best = max(service.service_rate_qps(b)
                   for b in range(1, self._slo_cap + 1))
        self._knee = next(b for b in range(1, self._slo_cap + 1)
                          if service.service_rate_qps(b) >= 0.98 * best)

    def observe_arrival(self, t: float) -> None:
        if self._last_arrival is not None:
            gap = t - self._last_arrival
            if self._gap_ewma is None:
                self._gap_ewma = gap
            else:
                a = self.ewma_alpha
                self._gap_ewma = (1 - a) * self._gap_ewma + a * gap
        self._last_arrival = t

    def _desired_batch(self) -> int:
        if self._gap_ewma is None or self._gap_ewma <= 0:
            return 1
        need_qps = self.margin * self.service.freq_hz / self._gap_ewma
        for b in range(1, self._knee + 1):
            if self.service.service_rate_qps(b) >= need_qps:
                return b
        return self._knee

    def _target_batch(self) -> int:
        # hysteresis: one step per call toward the estimate. The raw EWMA
        # rate spikes on every Poisson clump (a few short gaps in a row),
        # and chasing it dispatches oversized groups whose latency blows
        # the p99; stepping needs the spike to PERSIST before the window
        # grows, and decays it one step per dispatch when it passes.
        desired = self._desired_batch()
        if desired > self._target:
            self._target += 1
        elif desired < self._target:
            self._target -= 1
        return self._target

    def _timeout(self, target: int) -> float:
        # a target of 1 means the load doesn't need batching: dispatch
        # immediately. Otherwise the fill-wait must stay SMALL — every
        # cycle spent waiting comes straight out of the p99 — so spend at
        # most a small slice of the SLO (and never more than a quarter of
        # the headroom the target group's own traversal leaves).
        if target <= 1:
            return 0.0
        head = self.slo_cycles - self.service.group_latency_cycles(target)
        return max(0.0, min(self.slo_cycles / 15.0, 0.25 * head))

    def decide(self, q: QueueView) -> int:
        if not q.device_ready or q.queue_len == 0:
            return 0
        target = self._target_batch()
        # dispatch EXACTLY the load-sized window: an oversized clump-drain
        # group would spend latency budget on throughput the load doesn't
        # need (a stale-low rate estimate self-corrects — the clump raises
        # the EWMA, which raises the target)
        if q.queue_len >= target:
            return target
        # same float expression as next_deadline (see TimeoutPolicy)
        if q.now >= q.oldest_arrival + self._timeout(target):
            return q.queue_len
        return 0

    def next_deadline(self, q: QueueView) -> Optional[float]:
        # read-only: uses the current window without stepping it (only
        # decide() advances the hysteresis)
        if q.queue_len == 0:
            return None
        return q.oldest_arrival + self._timeout(self._target)

    def describe(self):
        return {"policy": self.name, "batch_cap": self.batch_cap,
                "slo_cycles": self.slo_cycles, "margin": self.margin,
                "slo_cap": self._slo_cap}


POLICIES: Dict[str, str] = {
    "immediate": "dispatch on arrival, up to batch_cap (1 = no batching)",
    "timeout": "fixed-size-with-timeout: fill batch_cap or dispatch at "
               "timeout_cycles, whichever first",
    "adaptive": "model-predictive window sized to the EWMA arrival rate "
                "under the latency SLO",
}


def make_policy(name: str, service: Optional[ServiceModel] = None,
                batch_cap: Optional[int] = None,
                timeout_cycles: Optional[float] = None,
                slo_cycles: Optional[float] = None) -> Policy:
    """Build a policy from CLI-ish arguments (None = the policy default)."""
    if name == "immediate":
        return ImmediatePolicy(batch_cap=batch_cap or 1)
    if name == "timeout":
        kw = {}
        if batch_cap is not None:
            kw["batch_cap"] = batch_cap
        if timeout_cycles is not None:
            kw["timeout_cycles"] = timeout_cycles
        return TimeoutPolicy(**kw)
    if name == "adaptive":
        if service is None or slo_cycles is None:
            raise ValueError("adaptive policy needs service= and "
                             "slo_cycles= (it plans against the device's "
                             "cost model)")
        kw = {"service": service, "slo_cycles": slo_cycles}
        if batch_cap is not None:
            kw["batch_cap"] = batch_cap
        return AdaptivePolicy(**kw)
    raise ValueError(f"unknown policy {name!r}; want {sorted(POLICIES)}")
