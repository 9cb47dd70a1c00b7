"""The metrics read from the port's own spans (``repro_torch.runtime.trace``):
``dsc_host_us.*`` and ``step_host_ms.*``, in traced runs of the smoke cells
on the CPU, and their readers without spans."""

import statistics
import sys

import pytest

from bench import harness
from bench import trace as bench_trace
from bench.harness import Record
from repro_torch import runtime
from repro_torch.runtime import trace

# cell -> (the step's span, metrics read from spans)
CELLS = {
    "mbv2-vww-int8.frame_b1": (
        "mbv2.forward_batch", {"dsc_host_us.frame", "step_host_ms.frame"}),
    "mbv2-vww-int8.offline_b256": (
        "mbv2.forward_batch",
        {"dsc_host_us.offline", "step_host_ms.offline"}),
    "glm4-9b.decode_b16": ("lm.decode_step", {"step_host_ms.decode"}),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_runs_read_the_ports_spans(smoke_root, cell, monkeypatch):
    """Each metric reads above 0, from the device-only pass's records: one
    step record for each step of that pass's record, and the DSC calls
    inside them."""
    name, want = CELLS[cell]
    views, passes = [], []
    profiled = bench_trace.profiled

    def marked(fn, spans, host=True):
        kept = trace.records()
        first = kept[-1].index + 1 if kept else 0   # the pass's first index
        out = profiled(fn, spans, host)
        passes.append((host, first))
        return out

    class Kept(harness.View):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            views.append(self)

    monkeypatch.setattr(bench_trace, "profiled", marked)
    monkeypatch.setattr(harness, "View", Kept)
    p = harness.plan(cell, smoke_root)
    out = harness.run(p, 2**31 + 21, 0.3, True, "cpu", 0.0)
    assert out["correct"] is True
    got = {k for k in out["metrics"]
           if k.split(".")[0] in ("dsc_host_us", "step_host_ms")}
    assert got == want
    assert all(out["metrics"][k]["value"] > 0 for k in want)

    (v,) = views
    assert [h for h, _ in passes] == [True, False, True]
    (_, first), (_, last) = passes[1:]
    in_pass = [r for r in trace.records(name) if first <= r.index < last]
    assert len(in_pass) == len(v.rec.work) > 0
    step = next(k for k in want if k.startswith("step_host_ms"))
    assert out["metrics"][step]["value"] == statistics.median(
        r.end_ns - r.start_ns for r in in_pass) * 1e-6
    dsc = next((k for k in want if k.startswith("dsc_host_us")), None)
    if dsc:
        calls = [r for r in trace.records("dsc_block")
                 if first <= r.index < last]
        assert len(calls) == 7 * len(in_pass)
        assert out["metrics"][dsc]["value"] == statistics.median(
            r.end_ns - r.start_ns for r in calls) * 1e-3


def view_with_calls(reader, n=3):
    return harness.View(cfg={}, rec=Record(1.0, [], n, n, [()] * n, None),
                        setup_s=0.0, peaks={},
                        calls={e: [((), {})] * n for e in reader.SPANS})


@pytest.mark.parametrize("metric", ["dsc_host_us.frame", "step_host_ms.frame",
                                    "step_host_ms.decode"])
def test_readers_give_nothing_without_records(smoke_root, metric,
                                              monkeypatch):
    reader = harness.plan(next(c for c, (_, m) in CELLS.items()
                               if metric in m), smoke_root).metric(metric)
    trace.clear()
    assert reader.read(view_with_calls(reader)) is None
    # a port from before the tracer existed
    monkeypatch.delattr(runtime, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    assert reader.read(view_with_calls(reader)) is None
    # no calls counted
    assert reader.read(harness.View(cfg={}, rec=None, setup_s=0.0,
                                     peaks={})) is None
