#!/usr/bin/env python3
"""What the port's spans cost each pass of a traced benchmark run on one
card: one traced run of a cell, with the spans set per profiled pass.

    python3 probes/host_pass.py --spans on,on,on [--workload CELL] \
        [--seed N] [--seconds S] [--device cuda]

``--spans`` gives the spans of the traced warm-up, the device-only pass and
the host pass, in that order: ``on`` (as they run), ``off`` (the flag they
read held false, so they return the null context) or ``bare`` (the
profiler's event alone: no record, no args). Run it in a fresh process for
each setting, in turns, since profiles of the host slow one another within
a process. Prints the harness's ``# traced pass`` lines (items a second in
each pass) and the result line's per-layer metrics.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import harness  # noqa: E402
from bench import trace as bench_trace  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402

ON, SPAN = trace._profiler, trace.span
OFF = types.SimpleNamespace(_is_profiler_enabled=False)


def bare(name: str):
    """The span's profiler event alone: no record, no args."""
    if not ON._is_profiler_enabled:
        return trace._OFF
    return _Bare(name)


class _Bare:
    __slots__ = ("fn",)

    def __init__(self, name: str):
        self.fn = torch._C._profiler._RecordFunctionFast(trace.PREFIX + name)

    def __enter__(self) -> None:
        self.fn.__enter__()

    def __exit__(self, *exc) -> None:
        self.fn.__exit__(*exc)


def set_spans(mode: str) -> None:
    trace._profiler = OFF if mode == "off" else ON
    trace.span = bare if mode == "bare" else SPAN


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spans", default="on,on,on")
    ap.add_argument("--workload", default="mbv2-vww-int8.frame_b1")
    ap.add_argument("--seed", type=int, default=3_500_000_001)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    modes = args.spans.split(",")
    if len(modes) != 3 or set(modes) - {"on", "off", "bare"}:
        ap.error("--spans takes three of on, off, bare")
    profiled, passes = bench_trace.profiled, []

    def per_pass(fn, spans, host=True):
        set_spans(modes[len(passes)])
        passes.append(host)
        try:
            return profiled(fn, spans, host)
        finally:
            set_spans("on")

    bench_trace.profiled = per_pass
    p = harness.plan(args.workload)
    out = harness.run(p, args.seed, args.seconds, True, args.device,
                      time.perf_counter())
    assert passes == [True, False, True], passes
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    print(json.dumps({"spans": args.spans, "correct": out["correct"],
                      "metrics": metrics}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
