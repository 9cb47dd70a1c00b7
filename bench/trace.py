"""Traced runs: spans around the port's dispatch entries, and what the
profiler's trace says of the device.

A traced run wraps each entry that its per-layer metrics name
(``"repro_torch.kernels.ops:ffn"``) in a ``record_function`` span, from the
benchmark's own files: the port's callers look the entry up through its
module, so they call the wrapper. The wrapper also keeps each call's
argument shapes, from which ``cost`` counts the work. The kernels a span
launched are those inside the device-side range that the profiler records
for it; where a later change replays them without Python (a CUDA graph),
the names seen under the span in the eager warm-up pick them out instead.
A traced window runs twice (``harness.traced_passes``): under a profile of
the device alone, whose busy time and work the idle share and MFU read,
and with the host's ops and the spans, which the rooflines and the idle
gaps read; recording the host's ops slows a host-bound window.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib
import re
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

import torch

SPAN = "bench::"
WINDOW = "bench::window"
TOP = 10
HIDDEN = ("profiler::", "[memory]")    # the profiler's own records


def _shape(a):
    """A tensor as (shape, bytes per element); anything else as itself."""
    if isinstance(a, torch.Tensor):
        return tuple(a.shape), a.element_size()
    return a


class Spans:
    """Wraps each ``"module:attribute"`` entry in a span while in use;
    ``calls[entry]`` holds the argument shapes of each call made while
    ``recording`` is set."""

    def __init__(self, entries):
        self.entries = sorted(set(entries))
        self.calls: Dict[str, list] = {e: [] for e in self.entries}
        self.recording = False          # keep calls and mark spans
        self._saved: list = []

    def __enter__(self):
        for entry in self.entries:
            mod_name, attr = entry.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(entry, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    def clear(self) -> None:
        """Forget the calls recorded so far."""
        for calls in self.calls.values():
            calls.clear()

    def _wrap(self, entry: str, fn: Callable) -> Callable:
        from torch.profiler import record_function
        name = SPAN + entry
        calls = self.calls[entry]

        def wrapped(*args, **kw):
            if not self.recording:
                return fn(*args, **kw)
            calls.append((tuple(_shape(a) for a in args),
                          {k: _shape(v) for k, v in kw.items()}))
            with record_function(name):
                return fn(*args, **kw)
        return wrapped


def kernel_name(name: str) -> str:
    """A device operation's name without namespace, template arguments and
    parameters."""
    m = re.search(r"(\w+)[<(]", name.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else name


@dataclasses.dataclass
class Trace:
    """The device's side of a traced window."""

    window_s: float
    busy_s: float
    span_kernel_s: Dict[str, float]        # entry -> device s under its spans
    span_names: Dict[str, Set[str]]        # entry -> kernel names under it
    device_ops: List[Tuple[str, float]]    # (name, s), most time first
    idle_gaps: List[Tuple[str, float]]     # (host op, s), longest first


@dataclasses.dataclass
class Event:
    name: str
    on_device: bool
    start: float                           # microseconds
    end: float
    thread: int
    annotation: bool                       # a span, not an operation


def events(prof) -> List[Event]:
    """The profile's events as the profiler recorded them: read straight
    from its results, which skips the tree of host ops that
    ``prof.events()`` builds and takes minutes over a long window."""
    from torch.autograd import DeviceType
    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()          # times from it, exact in floats
    out = []
    for e in results.events():
        name = e.name()
        if name.startswith(HIDDEN):
            continue
        out.append(Event(name, e.device_type() == DeviceType.CUDA,
                         (e.start_ns() - t0) * 1e-3,
                         (e.end_ns() - t0) * 1e-3, e.start_thread_id(),
                         name.startswith(SPAN) or e.is_user_annotation()))
    return out


def _contained(kernels, ranges) -> List[Tuple[float, float, str]]:
    """The kernels (start, end, name) that lie inside one of ``ranges``."""
    ranges = sorted(ranges)
    starts = [r[0] for r in ranges]
    out = []
    for k in kernels:
        i = bisect.bisect_right(starts, k[0]) - 1
        if i >= 0 and k[1] <= ranges[i][1]:
            out.append(k)
    return out


def read(prof, entries, names_seen: Optional[Dict[str, Set[str]]] = None
         ) -> Trace:
    """Reduce a ``torch.profiler.profile`` over one ``WINDOW`` span to a
    ``Trace``.

    The kernels a span launched are those inside the device-side range the
    profiler records for the span (it follows launches that no torch op
    wraps, such as the DSC kernel's ``ctypes`` call). ``names_seen``: the
    kernel names under each entry's spans in the eager warm-up, the
    fallback where the window holds no such range."""
    evs = events(prof)
    windows = [e for e in evs if e.name == WINDOW and not e.on_device]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} {WINDOW} spans")
    w0, w1 = windows[0].start, windows[0].end
    device, cpu, ranges = [], [], {e: [] for e in entries}
    for e in evs:
        s, t = e.start, e.end
        if e.on_device:
            s, t = max(s, w0), min(t, w1)
            if t <= s:
                continue
            entry = e.name[len(SPAN):]
            if entry in ranges:
                ranges[entry].append((s, t))
            elif not e.annotation:
                device.append((s, t, e.name))
        elif e.thread == windows[0].thread and e.name != WINDOW:
            cpu.append((s, t, e.name))

    merged = _merge(device)
    busy = sum(t - s for s, t in merged)
    gaps, last = [], w0
    for s, t in merged:
        if s > last:
            gaps.append((last, s))
        last = max(last, t)
    if w1 > last:
        gaps.append((last, w1))

    by_name: Dict[str, float] = {}
    for s, t, name in device:
        by_name[name] = by_name.get(name, 0.0) + (t - s) * 1e-6

    span_s, span_names = {}, {}
    for entry in entries:
        inside = _contained(device, ranges[entry])
        span_names[entry] = {name for _, _, name in inside}
        span_s[entry] = sum(t - s for s, t, _ in inside) * 1e-6
        if not ranges[entry] and names_seen and names_seen.get(entry):
            span_s[entry] = sum(by_name.get(n, 0.0)
                                for n in names_seen[entry])

    return Trace(
        window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
        span_kernel_s=span_s, span_names=span_names,
        device_ops=_by_kernel(device),
        idle_gaps=_attribute(gaps, cpu)[:TOP])


def _merge(intervals) -> List[List[float]]:
    """The union of (start, end, ...) intervals, as sorted [start, end]."""
    merged: List[List[float]] = []
    for s, t, *_ in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def _by_kernel(device) -> List[Tuple[str, float]]:
    """Device seconds by kernel name (``kernel_name``), most first."""
    out: Dict[str, float] = {}
    for s, t, name in device:
        short = kernel_name(name)
        out[short] = out.get(short, 0.0) + (t - s) * 1e-6
    return sorted(out.items(), key=lambda kv: -kv[1])[:TOP]


def read_device(prof, window_s: float) -> Trace:
    """Reduce a profile of the device alone over a window of ``window_s``
    seconds (the host's clock) to the ``Trace`` fields it can give: the
    busy time, as the union of the device's operations, and the
    operations that took most time. It holds no spans and no host ops."""
    device = [(e.start, e.end, e.name) for e in events(prof)
              if e.on_device and not e.annotation]
    busy = sum(t - s for s, t in _merge(device)) * 1e-6
    return Trace(window_s=window_s, busy_s=busy, span_kernel_s={},
                 span_names={}, device_ops=_by_kernel(device), idle_gaps=[])


def _attribute(gaps, cpu) -> List[Tuple[str, float]]:
    """Idle seconds by the innermost host op running at each gap's middle
    (``host between ops`` where none runs)."""
    cpu = sorted(cpu)
    starts = [c[0] for c in cpu]
    out: Dict[str, float] = {}
    active: list = []
    j = 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) / 2
        k = bisect.bisect_right(starts, mid)
        active.extend(cpu[j:k])
        j = max(j, k)
        active = [c for c in active if c[1] >= mid]
        name = max(active)[2] if active else "host between ops"
        out[name] = out.get(name, 0.0) + (g1 - g0) * 1e-6
    return sorted(out.items(), key=lambda kv: -kv[1])


def profiled(fn: Callable, spans: Spans, host: bool = True):
    """Run ``fn()`` under the profiler inside a ``WINDOW`` span; returns
    (fn's result, the profiler, the window's seconds on the host's clock).
    ``host``: record the host's ops and the spans' calls and spans too;
    otherwise the device's operations alone, which costs the host little."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if host or not acts:
        acts = [ProfilerActivity.CPU] + acts
    with profile(activities=acts) as prof:
        spans.recording = host
        t = time.perf_counter()
        try:
            with record_function(WINDOW):
                out = fn()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        finally:
            spans.recording = False
        wall = time.perf_counter() - t
    return out, prof, wall
