#!/usr/bin/env python3
"""Host cost of the port's spans (``runtime.trace.span``) on one card.

    python3 probes/span_cost.py [--calls N]

Times N empty spans back to back: with no profile running, under a
profile of the host and the card, and under a profile of the card alone;
beside them ``record_function`` with no profile and under the first
profile. Counts the spans of one 80x80 int8 MobileNet frame through the DSC
kernel, and lists the device-side events of a span around that frame,
which show whether the profiler gives the port's spans a device-side
range. Then runs frames in closed loops under each profile with the spans
on and off, in turns, and counts the garbage collector's pauses. Prints
microseconds per span and frames a second, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import collections
import gc
import subprocess
import sys
import time
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import (ProfilerActivity, profile,  # noqa: E402
                            record_function)

from repro_torch.models import mobilenetv2  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402


def per_span_us(enter, calls: int) -> float:
    """Best of three runs of ``calls`` empty ``with enter():`` blocks."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(calls):
            with enter():
                pass
        best = min(best, time.perf_counter() - t0)
    return best / calls * 1e6


def frames_under_profiles(frame, both, seconds: float = 3.0) -> None:
    """Frames a second in closed loops under each profile, the spans on
    (as they run) and off (the flag they read held false), in turns off,
    on, on, off; with the seconds the garbage collector took in each."""
    paused = []

    def gc_clock(phase, info):
        if phase == "start":
            paused.append(-time.perf_counter())
        else:
            paused[-1] += time.perf_counter()
    gc.callbacks.append(gc_clock)
    on_flag = trace._profiler
    try:
        for label, acts in (("host and card", both),
                            ("card alone", [ProfilerActivity.CUDA])):
            for spans_on in (False, True, True, False):
                trace._profiler = (on_flag if spans_on else
                                   types.SimpleNamespace(
                                       _is_profiler_enabled=False))
                paused.clear()
                trace.clear()
                n = 0
                with profile(activities=acts):
                    end = time.perf_counter() + seconds
                    while time.perf_counter() < end:
                        frame()
                        n += 1
                state = "on" if spans_on else "off"
                print(f"profile of {label}, spans {state}: "
                      f"{n / seconds:.2f} frames/s, {len(paused)} "
                      f"collections, {sum(paused):.4f} s", flush=True)
    finally:
        trace._profiler = on_flag
        gc.callbacks.remove(gc_clock)
        trace.clear()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=200_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("span_cost: no CUDA device", file=sys.stderr)
        return 2
    n = args.calls
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    rows = [
        ("span, no profile", None, lambda: trace.span("x")),
        ("record_function, no profile", None,
         lambda: record_function("x")),
        ("span, profile of host and card", both, lambda: trace.span("x")),
        ("record_function, profile of host and card", both,
         lambda: record_function("x")),
        ("span, profile of the card alone", [ProfilerActivity.CUDA],
         lambda: trace.span("x")),
    ]
    for label, acts, enter in rows:
        if acts is None:
            us = per_span_us(enter, n)
        else:
            with profile(activities=acts):
                us = per_span_us(enter, n // 10)
            trace.clear()
        print(f"{label}: {us:.4f} us a span", flush=True)

    net = mobilenetv2.init_and_quantize(0, device="cuda")
    img = np.random.default_rng(0).standard_normal(
        (1, 80, 80, 3)).astype(np.float32)

    def frame():
        return mobilenetv2.forward_batch(img, net, use_kernel=True,
                                         return_quantized=True).cpu()
    for _ in range(20):
        frame()
    t0 = time.perf_counter()
    for _ in range(500):
        frame()
    print(f"frame, no profile: {(time.perf_counter() - t0) / 500 * 1e3:.4f} "
          f"ms", flush=True)
    trace.clear()
    with profile(activities=both) as prof:
        frame()
        torch.cuda.synchronize()
    spans = collections.Counter(r.name for r in trace.records())
    print(f"spans a frame: {sum(spans.values())} {dict(spans)}")
    frames_under_profiles(frame, both)
    device = collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA
        and e.name().startswith(trace.PREFIX))
    print(f"device-side events of the port's spans: {dict(device)}")

    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {limit}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
