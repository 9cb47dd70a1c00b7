"""Cycle-attributed tracing + CFU performance-counter bank.

One event model serves every layer of the simulator — the golden
executor, the cycle/energy cost model, the multi-core frame pipeline,
and the request-level serving simulator — so their timelines land in ONE
trace file and diff cleanly against each other:

* **Spans** ("X" complete events): a named interval on a (pid, tid)
  track. The cost model emits one span per BAR-delimited phase whose
  duration IS the phase's modeled cycles (the exactness invariant: span
  durations sum to ``TimingReport.total_cycles`` bit-for-bit, because
  they are computed by the same expression). The executor emits the same
  phase schema on its own process, stamped in retired instructions (the
  interpreter has no clock); the serving simulator emits one span per
  dispatched batch, stamped in simulated cycles.
* **Counters** ("C" events): sampled counter tracks — queue depth over
  simulated time, cumulative DRAM/SRAM bytes over a modeled timeline,
  per-boundary handoff cycles per core.
* **Instants** ("i" events): point markers — SLO violations at request
  completion, ``HandoffViolation`` diagnostics at the violating step.

The exporter writes Chrome trace-event JSON (the ``traceEvents`` array
format), loadable directly in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``. ``pid`` maps to a process row (one per CFU core,
plus one for the serving layer), ``tid`` to a thread row within it
(engine/phase/batch slot). Timestamps are emitted in the tracer's native
unit — cycles for model/serving tracks, retired instructions for
executor tracks — with 1 unit = 1 Perfetto microsecond (the viewer's
"us" axis therefore reads as cycles; the ``clock`` metadata records the
unit). Serialization is deterministic: events are written in emission
order with sorted keys, so one seed fixes the JSON byte-for-byte
(tested in tests/test_cfu_trace.py).

:class:`NullTracer` is the default everywhere: every emit method is a
no-op ``pass``, nothing allocates, and no simulated number depends on
tracing — all golden fingerprints are byte-identical with tracing on or
off (the trace *observes* the same arithmetic, it never participates).

:class:`CounterBank` is the CSR-style hardware view the real
CFU-on-RISC-V would expose next to its datapath (arXiv 2511.21232): a
fixed register file of retired-instruction counts per opcode, byte
movement per memory space and direction, MAC ops per engine, weight
(re)load traffic, and stall/handoff cycles. ``executor.ExecStats`` and
``timing.TimingReport`` both render into it, which is what makes
modeled-vs-executed diffs a dict comparison.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

# Event categories (the "cat" field — Perfetto's filter chips).
CAT_PHASE = "phase"          # BAR-delimited compute/transfer phases
CAT_EXEC = "exec"            # golden-executor timeline (instruction time)
CAT_SERVE = "serve"          # request-level serving events
CAT_COUNTER = "counter"
CAT_MARK = "mark"


@dataclasses.dataclass
class CounterBank:
    """CSR-style performance-counter register file of one CFU core.

    Byte counters follow the aligned ``ExecStats``/``TimingReport``
    convention: data bytes are summed over the whole lockstep batch,
    weight bytes are counted once per LD_WGT executed (boot-resident
    streaming). ``retired`` counts instructions per opcode (the stream
    is batch-independent, so these never scale with batch); ``macs``
    counts executed multiply-accumulates per engine, summed over the
    batch. ``stall_cycles``/``handoff_cycles`` only have meaning on the
    cost-model side (the executor has no clock and leaves them 0).
    """

    retired: Dict[str, int] = dataclasses.field(default_factory=dict)
    macs: Dict[str, int] = dataclasses.field(default_factory=dict)
    dram_rd_bytes: int = 0
    dram_wr_bytes: int = 0
    sram_rd_bytes: int = 0
    sram_wr_bytes: int = 0
    weight_bytes: int = 0
    weight_reloads: int = 0
    check_bytes: int = 0         # bytes swept by CHK_* detection words
    stall_cycles: float = 0.0
    handoff_cycles: float = 0.0

    def as_csrs(self) -> Dict[str, float]:
        """Flat name -> value view (the CSR address map, alphabetical)."""
        out: Dict[str, float] = {
            "dram_rd_bytes": self.dram_rd_bytes,
            "dram_wr_bytes": self.dram_wr_bytes,
            "sram_rd_bytes": self.sram_rd_bytes,
            "sram_wr_bytes": self.sram_wr_bytes,
            "weight_bytes": self.weight_bytes,
            "weight_reloads": self.weight_reloads,
            "check_bytes": self.check_bytes,
            "stall_cycles": self.stall_cycles,
            "handoff_cycles": self.handoff_cycles,
        }
        for op in sorted(self.retired):
            out[f"retired.{op}"] = self.retired[op]
        for eng in sorted(self.macs):
            out[f"macs.{eng}"] = self.macs[eng]
        return out

    def diff(self, other: "CounterBank") -> Dict[str, float]:
        """Non-zero CSR deltas ``self - other`` (modeled vs executed)."""
        a, b = self.as_csrs(), other.as_csrs()
        keys = sorted(set(a) | set(b))
        return {k: a.get(k, 0) - b.get(k, 0) for k in keys
                if a.get(k, 0) != b.get(k, 0)}


class Tracer:
    """Collects cycle-stamped events; exports Chrome trace-event JSON."""

    def __init__(self, clock: str = "cycles"):
        self.clock = clock
        self.events: List[Dict[str, Any]] = []
        self._named_pids: Dict[int, str] = {}
        self._named_tids: Dict[tuple, str] = {}

    # --- emission ----------------------------------------------------------

    def span(self, name: str, ts: float, dur: float, *, pid: int = 0,
             tid: int = 0, cat: str = CAT_PHASE,
             args: Optional[Dict[str, Any]] = None) -> None:
        ev: Dict[str, Any] = {"name": name, "cat": cat, "ph": "X",
                              "ts": ts, "dur": dur, "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, ts: float, value, *, pid: int = 0,
                series: str = "value") -> None:
        """One counter sample; ``value`` may be a number or a dict of
        series -> number (stacked tracks in Perfetto)."""
        args = dict(value) if isinstance(value, dict) else {series: value}
        self.events.append({"name": name, "cat": CAT_COUNTER, "ph": "C",
                            "ts": ts, "pid": pid, "args": args})

    def instant(self, name: str, ts: float, *, pid: int = 0, tid: int = 0,
                cat: str = CAT_MARK,
                args: Optional[Dict[str, Any]] = None) -> None:
        ev: Dict[str, Any] = {"name": name, "cat": cat, "ph": "i",
                              "ts": ts, "pid": pid, "tid": tid, "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def process_name(self, pid: int, name: str) -> None:
        if self._named_pids.get(pid) == name:
            return
        self._named_pids[pid] = name
        self.events.append({"name": "process_name", "ph": "M", "pid": pid,
                            "tid": 0, "args": {"name": name}})

    def thread_name(self, pid: int, tid: int, name: str) -> None:
        if self._named_tids.get((pid, tid)) == name:
            return
        self._named_tids[(pid, tid)] = name
        self.events.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": tid, "args": {"name": name}})

    def counter_bank(self, bank: CounterBank, ts: float, *, pid: int = 0,
                     prefix: str = "csr") -> None:
        """Dump a whole counter bank as one sample per CSR group."""
        csrs = bank.as_csrs()
        bytes_track = {k: csrs[k] for k in
                       ("dram_rd_bytes", "dram_wr_bytes",
                        "sram_rd_bytes", "sram_wr_bytes", "weight_bytes")}
        self.counter(f"{prefix}.bytes", ts, bytes_track, pid=pid)
        retired = {k.split(".", 1)[1]: v for k, v in csrs.items()
                   if k.startswith("retired.")}
        if retired:
            self.counter(f"{prefix}.retired", ts, retired, pid=pid)
        macs = {k.split(".", 1)[1]: v for k, v in csrs.items()
                if k.startswith("macs.")}
        if macs:
            self.counter(f"{prefix}.macs", ts, macs, pid=pid)

    # --- queries (used by the exactness tests) ------------------------------

    def spans(self, *, pid: Optional[int] = None,
              cat: Optional[str] = None) -> List[Dict[str, Any]]:
        return [e for e in self.events if e["ph"] == "X"
                and (pid is None or e["pid"] == pid)
                and (cat is None or e.get("cat") == cat)]

    def span_cycles(self, *, pid: Optional[int] = None,
                    cat: Optional[str] = None) -> float:
        """Sum of span durations on a track — the quantity the exactness
        invariant pins to ``TimingReport.total_cycles``."""
        return sum(e["dur"] for e in self.spans(pid=pid, cat=cat))

    def last_counter(self, name: str, *, pid: Optional[int] = None
                     ) -> Optional[Dict[str, Any]]:
        for e in reversed(self.events):
            if e["ph"] == "C" and e["name"] == name \
                    and (pid is None or e["pid"] == pid):
                return e["args"]
        return None

    # --- export -------------------------------------------------------------

    def to_chrome(self) -> Dict[str, Any]:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "otherData": {"clock": self.clock,
                              "exporter": "repro_torch.cfu.trace"}}

    def to_json(self) -> str:
        """Deterministic serialization: emission order, sorted keys."""
        return json.dumps(self.to_chrome(), sort_keys=True,
                          separators=(",", ":"))

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())


class NullTracer(Tracer):
    """The zero-overhead default: every emit method is a bare ``pass``.

    Simulator code calls tracer methods unconditionally; with the null
    tracer nothing is recorded and nothing allocates, and because tracing
    never feeds back into any computed quantity, every golden fingerprint
    is byte-identical whether a real tracer is attached or not.
    """

    def __init__(self):
        super().__init__()

    def span(self, name, ts, dur, *, pid=0, tid=0, cat=CAT_PHASE,
             args=None):
        pass

    def counter(self, name, ts, value, *, pid=0, series="value"):
        pass

    def instant(self, name, ts, *, pid=0, tid=0, cat=CAT_MARK, args=None):
        pass

    def process_name(self, pid, name):
        pass

    def thread_name(self, pid, tid, name):
        pass

    def counter_bank(self, bank, ts, *, pid=0, prefix="csr"):
        pass


#: Shared no-op instance — ``tracer or NULL_TRACER`` is the idiom.
NULL_TRACER = NullTracer()
