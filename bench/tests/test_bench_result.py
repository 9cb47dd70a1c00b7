"""The result line's keys, the refusal without a card, and a run that
loads no JAX."""

import json
import subprocess
import sys

import pytest

from bench import harness
from conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["mbv2-vww-int8.frame_b1",
                                  "mbv2-vww-int8.offline_b256",
                                  "glm4-9b.prefill_1500",
                                  "glm4-9b.decode_b16"])
def test_untraced_result_line(smoke_root, cell):
    p = harness.plan(cell, smoke_root)
    out = harness.run(p, 2**31 + 5, 0.4, False, "cpu", 0.0)
    assert list(out) == KEYS + ["checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in p.end_to_end}
    for m in p.end_to_end:
        got = out["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(out)


def test_traced_result_line(smoke_root):
    p = harness.plan("glm4-9b.prefill_1500", smoke_root)
    out = harness.run(p, 9, 0.4, True, "cpu", 0.0)
    assert list(out) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device here: only the work-based share reads anything
    assert set(out["metrics"]) == {"mfu.prefill"}
    json.dumps(out)


@pytest.mark.parametrize("seconds", [0.0, 600.0])
def test_traced_decode_pass_holds_decode_steps_alone(smoke_root, seconds):
    """The decode cell's traced pass starts its profile after the prefill,
    profiles decode steps for its seconds (at least one), and serves the
    whole request for the check."""
    p = harness.plan("glm4-9b.decode_b16", smoke_root)
    key = harness.seed_key(2**31 + 11)
    system = p.family.System(p.cfg, key, "cpu")
    data = p.kind.inputs(p.mix, p.cfg, key, "cpu")
    profiling, prefills = [False], []
    prefill = system.prefill

    def counted(*a, **kw):
        prefills.append(profiling[0])
        return prefill(*a, **kw)
    system.prefill = counted

    def profiled(fn):
        profiling[0] = True
        out = fn()
        profiling[0] = False
        return out, None, 1.0
    rec, _, wall = p.kind.traced(system, data, p.mix, seconds, profiled)
    steps = 1 if seconds == 0 else p.mix["new_tokens"] - 1
    assert prefills == [False] and wall == 1.0
    assert [w[0] for w in rec.work] == ["decode"] * steps
    assert rec.items == p.mix["batch"] * steps
    assert rec.outputs[1][0].shape == (p.mix["batch"], p.mix["new_tokens"])


def test_run_refuses_without_a_card():
    r = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "mbv2-vww-int8.frame_b1", "--seed", "1",
                        "--seconds", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "CUDA card" in r.stderr


def test_a_run_loads_no_jax(smoke_root):
    """A whole CPU run of every cell in a fresh process leaves no module
    whose top-level name is jax, jaxlib, flax or repro."""
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from pathlib import Path
from bench import harness
for cell in ("mbv2-vww-int8.frame_b1", "glm4-9b.decode_b16"):
    harness.run(harness.plan(cell, Path({str(smoke_root)!r})), 3, 0.2,
                False, "cpu", 0.0)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print(harness.forbidden_modules())
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    loaded, found = r.stdout.strip().splitlines()[-2:]
    assert "repro_torch" in loaded
    assert found == "[]"
