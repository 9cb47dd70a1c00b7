"""The readings that the limits of ``bench/limits/`` are set from, for one
cell, many seeds in one process (so the set-up is paid once):

    python3 bench/readings.py --workload <cell> --seconds <s> --seeds 1 2 3 \
        [--control]

For each seed: the weights and traffic drawn from it, a window of
``--seconds`` at the cell's own load, and the check's number for the
program; with ``--control``, also for the control, the reference in the
next lower precision put in the program's place. One JSON line per seed.
Run it on the card; the benchmark's own runs never run the control.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import harness  # noqa: E402


def readings(p, seed: int, seconds: float, control: bool, device) -> dict:
    key = harness.seed_key(seed)
    kind = p.kind
    system = p.family.System(p.cfg, key, device)
    data = kind.inputs(p.mix, p.cfg, key, device)
    kind.warm(system, data, p.mix)
    rec = kind.window(system, data, p.mix, seconds)
    kind.release(data)
    out = {"seed": seed, "requests": rec.attempted,
           "program": {c.name: c.value for c in kind.check(
               system, data, p.mix, rec, p.reference, p.limits, key)}}
    if control:
        out["control"] = kind.control(system, data, p.mix, rec, p.reference,
                                      key)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    p = harness.plan(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        out = readings(p, seed, args.seconds, args.control, args.device)
        out["s"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
