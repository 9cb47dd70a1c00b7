"""A configuration, a traffic mix, a cell and metrics added as new files,
with entries in BENCHMARK.json, are found with no other edit; a metric of a
kind that has its reader needs no file."""

import json

from conftest import smoke_copy

from bench import harness


def test_added_files_are_found(tmp_path):
    root = smoke_copy(tmp_path)
    b = root / "bench"
    cfg = json.loads((b / "configs" / "mbv2-vww-int8.json").read_text())
    cfg["img_hw"] = 40
    (b / "configs" / "mbv2-half.json").write_text(json.dumps(cfg))
    (b / "workloads" / "frames_b2.json").write_text(json.dumps(
        {"kind": "frames", "batch": 2, "pool": 3, "resident": False}))
    (b / "limits" / "mbv2-half.frames_b2.json").write_text(json.dumps(
        {"logit_mismatches": {"limit": 0}}))
    (b / "metrics" / "requests_done.py").write_text(
        "def read(v):\n    return float(v.rec.attempted)\n")
    (b / "metrics" / "requests_traced.py").write_text(
        "def read(v):\n    return float(len(v.rec.latencies_s))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = "mbv2-half.frames_b2"
    spec["configs"].append({"name": "mbv2-half", "source": "test",
                            "file": "bench/configs/mbv2-half.json",
                            "reduced": ["img_hw"], "why": "test"})
    spec["workloads"].append({"name": cell, "config": "mbv2-half",
                              "traffic": "frames_b2", "chips": 1,
                              "why": "test"})
    spec["end_to_end"].append({"name": "requests_done", "unit": "requests",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock", "workloads": [cell]})
    spec["per_layer"].append({"name": "requests_traced", "unit": "requests",
                              "better": "higher", "source": "host_clock",
                              "layer": "client", "moves": "requests_done",
                              "workloads": [cell]})
    # a metric of a kind that has its reader: no file of its own
    spec["per_layer"].append({"name": "mfu.frames_b2", "unit": "%",
                              "better": "higher", "source": "device_trace",
                              "layer": "model step", "moves": "requests_done",
                              "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    p = harness.plan(cell, root)
    assert p.cfg["img_hw"] == 40 and p.mix["batch"] == 2
    out = harness.run(p, 7, 0.3, False, "cpu", 0.0)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"requests_done", "setup_s"}
    assert out["metrics"]["requests_done"]["value"] == out["attempted"] > 0
    out = harness.run(p, 7, 0.3, True, "cpu", 0.0)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"requests_traced", "mfu.frames_b2"}
    assert out["metrics"]["mfu.frames_b2"]["value"] > 0
