#!/usr/bin/env python3
"""One traced benchmark run, then the kernel plans its launches ran.

    python3 probes/ffn_plan_records.py --workload W --seed N [--seconds S]

Runs ``bench/run.py --trace 1`` in this process (its result line is printed
as it prints it), then reads the port's ``dsc.plan``, ``ffn.plan`` and
``flash.plan`` records, which the profiled passes kept
(``runtime.trace.records``), and prints one line per distinct plan: how
many launches ran it, and its args (DSC: tile rows, grid, units, shared
memory; FFN: d_model slices, d_ff groups, cluster, grid, columns per block,
the resident clusters planned for; flash: the bf16 grid).
"""

from __future__ import annotations

import argparse
import collections
import json
import runpy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    run = runpy.run_path(str(ROOT / "bench" / "run.py"), run_name="bench_run")
    rc = run["main"](["--workload", args.workload, "--seed", str(args.seed),
                      "--seconds", str(args.seconds), "--trace", "1"])
    from repro_torch.runtime import trace
    for span in ("dsc.plan", "ffn.plan", "flash.plan"):
        plans = collections.Counter(
            json.dumps(r.args, sort_keys=True) for r in trace.records(span))
        for plan, n in plans.most_common():
            print(f"# {span} x {n}: {plan}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
