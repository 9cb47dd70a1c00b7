"""One run of one cell: set-up, the measured window, the check, the result.

``run`` is the whole of a run but the look for a card, which ``run.py``
makes first; the tests drive ``run`` on the CPU at small sizes. A cell is
found by its name in ``BENCHMARK.json``, and everything it uses by the names
there (see the package's docstring).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from bench import peaks, trace

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Record:
    """What a window did: what the end-to-end metrics and the check read."""

    seconds: float                 # the window's length as asked
    latencies_s: List[float]       # per request, every request started
    items: int                     # images or tokens on the host in time
    attempted: int                 # requests started (one that raises
                                   # ends the run, so none fails)
    work: List[tuple]              # what ``cost`` counts, every request
    outputs: Any                   # what the traffic kind's check compares


@dataclasses.dataclass
class Check:
    """A number compared with its limit: it passes at or below the limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class View:
    """What a metric's reader sees."""

    cfg: dict
    rec: Record
    setup_s: float
    peaks: dict
    trace: Optional[trace.Trace] = None
    calls: Optional[Dict[str, list]] = None


def load_module(path: Path):
    """Import a file of the benchmark by its path (names may hold dots)."""
    name = f"bench._found_{abs(hash(str(path.resolve()))):x}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


@dataclasses.dataclass
class Plan:
    """A cell and everything found for it by name."""

    name: str
    chips: int
    cfg: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    def module(self, *parts: str):
        return load_module(self.root.joinpath("bench", *parts))

    @property
    def family(self):
        return self.module("families", self.cfg["family"] + ".py")

    @property
    def reference(self):
        return self.module("reference", self.cfg["family"] + ".py")

    @property
    def kind(self):
        return self.module("traffic", self.mix["kind"] + ".py")

    def metric(self, name: str):
        """``metrics/<name>.py``, else the reader its kind shares,
        ``metrics/<name before the first dot>.py``: ``mfu.decode`` is read
        by ``mfu.py`` unless ``mfu.decode.py`` is there."""
        own = self.root / "bench" / "metrics" / (name + ".py")
        if own.exists():
            return load_module(own)
        return self.module("metrics", name.split(".")[0] + ".py")


def plan(cell: str, root: Path = ROOT) -> Plan:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json; one of "
                       f"{sorted(cells)}")
    w = cells[cell]
    cfgs = {c["name"]: c for c in spec["configs"]}
    cfg = json.loads((root / cfgs[w["config"]]["file"]).read_text())
    mix = json.loads((root / "bench" / "workloads" /
                      (w["traffic"] + ".json")).read_text())
    limits = json.loads((root / "bench" / "limits" /
                         (cell + ".json")).read_text())
    return Plan(cell, w["chips"], cfg, mix, limits,
                [m for m in spec["end_to_end"] if _reports(m, cell)],
                [m for m in spec["per_layer"] if _reports(m, cell)], root)


def seed_key(seed: int) -> int:
    """The seed as the non-negative integer the generators take."""
    return seed % (1 << 64)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_line(count: int) -> str:
    """The card's name, its power limit and the number of cards."""
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=30,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "power limit not read"
    return f"{name}, {limit}, {count} of {torch.cuda.device_count()} cards"


def forbidden_modules() -> List[str]:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def worst(check_lists: List[List[Check]]) -> List[Check]:
    """Each number compared at its worst over several passes' checks."""
    out: Dict[str, Check] = {}
    for checks in check_lists:
        for c in checks:
            if c.name not in out or c.value > out[c.name].value:
                out[c.name] = c
    return list(out.values())


def traced_passes(kind, system, data, mix: dict, seconds: float,
                  spans: trace.Spans, names_seen):
    """The traced window, run twice: first under a profile of the device
    alone, which costs the host little, for the device's busy and idle
    time and the work done in it; then with the host's ops and the spans
    as well, for the kernels under each span and what the host did in each
    idle gap. A traffic kind's ``traced(system, data, mix, seconds,
    profiled)`` picks what the profile holds; by default its window.
    Returns (the two passes' records, the ``Trace`` of both)."""
    run_pass = getattr(kind, "traced", None) or (
        lambda s, d, m, secs, profiled: profiled(
            lambda: kind.window(s, d, m, secs)))
    passes = []
    for host in (False, True):
        rec, prof, wall = run_pass(
            system, data, mix, seconds,
            lambda fn, host=host: trace.profiled(fn, spans, host=host))
        t = time.perf_counter()
        tr = (trace.read(prof, spans.entries, names_seen) if host
              else trace.read_device(prof, wall))
        del prof
        passes.append((rec, tr))
        print(f"# traced pass, {'with host ops' if host else 'device alone'}"
              f": {rec.items} items in {tr.window_s:.6f} s "
              f"({rec.items / tr.window_s:.6f} /s), busy {tr.busy_s:.6f} s; "
              f"read in {time.perf_counter() - t:.3f} s", file=sys.stderr,
              flush=True)
    (dev_rec, dev), (host_rec, tr) = passes
    return [dev_rec, host_rec], dataclasses.replace(
        tr, window_s=dev.window_s, busy_s=dev.busy_s,
        device_ops=dev.device_ops)


def run(p: Plan, seed: int, seconds: float, traced: bool, device,
        t0: float) -> dict:
    """The run: returns the result line's object, with ``checks`` last."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    key = seed_key(seed)
    marks = [("start", time.perf_counter())]
    system = p.family.System(p.cfg, key, device)
    marks.append(("system", time.perf_counter()))
    kind = p.kind
    data = kind.inputs(p.mix, p.cfg, key, device)
    marks.append(("inputs", time.perf_counter()))
    kind.warm(system, data, p.mix)
    sync(device)
    marks.append(("warm-up", time.perf_counter()))

    entries = [e for m in p.per_layer
               for e in getattr(p.metric(m["name"]), "SPANS", ())]
    tr = None
    with trace.Spans(entries if traced else ()) as spans:
        if traced:
            _, prof, _ = trace.profiled(
                lambda: kind.warm(system, data, p.mix), spans)
            names_seen = trace.read(prof, spans.entries).span_names
            spans.clear()
            marks.append(("traced warm-up", time.perf_counter()))
        setup_s = time.perf_counter() - t0
        steps = ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b) in
                          zip([("", t0)] + marks, marks))
        print(f"# set-up {setup_s:.3f} s: {steps}", file=sys.stderr,
              flush=True)
        if traced:
            secs = min(seconds, p.mix.get("trace_seconds", seconds))
            recs, tr = traced_passes(kind, system, data, p.mix, secs, spans,
                                     names_seen)
            rec = recs[0]
        else:
            rec = kind.window(system, data, p.mix, seconds)
            recs = [rec]
            sync(device)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind.release(data)
    if on_card:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    checks = worst([kind.check(system, data, p.mix, r, p.reference, p.limits,
                               key) for r in recs])
    print(f"# check {time.perf_counter() - t:.3f} s", file=sys.stderr,
          flush=True)
    if not checks:
        raise RuntimeError(f"{p.name}: the check compared no number; the "
                           f"limits file names none that it reads")
    view = View(p.cfg, rec, setup_s,
                peaks.for_device(torch.cuda.get_device_name(0))
                if on_card else peaks.H100, tr, spans.calls)
    metrics = {}
    for m in (p.per_layer if traced else p.end_to_end):
        value = p.metric(m["name"]).read(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": p.chips if on_card else 0, "memory_peak_bytes": peak}
    out = {"correct": all(c.ok for c in checks),
           "attempted": sum(r.attempted for r in recs), "failed": 0,
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                            "idle_gaps": [list(x) for x in tr.idle_gaps]}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    return out
