"""Discrete-event core: a deterministic cycle-stamped event queue.

Time is measured in CFU clock cycles (float — the cost model's phase
sums are floats). Determinism contract: pops are ordered by
``(time, seq)`` where ``seq`` is the global insertion number, so two
runs that push the same events in the same order pop them in the same
order — no wall clock, no id()-based tie-breaks, no hash iteration.
The event log (every processed event, in pop order) is therefore a
complete, replayable fingerprint of a simulation; the determinism test
asserts two same-seed runs produce identical logs.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, List, Optional, Tuple

# Event kinds (strings, not an enum: they go straight into JSON logs).
ARRIVAL = "arrival"        # a request joins the queue
POLL = "poll"              # a policy timer (e.g. batching timeout) fires
ENTRY_FREE = "entry_free"  # the device can accept the next frame group
COMPLETE = "complete"      # a dispatched group exits the pipeline
DROPOUT = "dropout"        # a core dies: degrade the device, replay inflight


@dataclasses.dataclass(frozen=True)
class Event:
    time: float
    seq: int
    kind: str
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def sort_key(self) -> Tuple[float, int]:
        return (self.time, self.seq)


class EventQueue:
    """Min-heap of events with a stable global tie-break."""

    def __init__(self):
        self._heap: List[Tuple[float, int, Event]] = []
        self._seq = 0

    def push(self, time: float, kind: str, **payload) -> Event:
        ev = Event(time=time, seq=self._seq, kind=kind, payload=payload)
        heapq.heappush(self._heap, (time, self._seq, ev))
        self._seq += 1
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[2]

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
