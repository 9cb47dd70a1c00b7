"""Run one cell of the port's benchmark once, on the card(s) of this machine.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` the last line of standard output holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
profiled window. Either way the run checks what the timed path produced
against the plain reference under ``bench/reference/`` and prints each
number compared beside its limit, as the last lines of standard error and
under ``checks`` in the result. Exits non-zero, printing no result, without
as many CUDA cards as the cell asks for, or if JAX or the JAX package was
loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench_cache"
# every build and kernel cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    p = harness.plan(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < p.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {p.chips} CUDA card(s); this machine "
              f"has {have}", file=sys.stderr)
        return 2
    print(f"# device: {harness.device_line(p.chips)}", flush=True)
    print(f"# window drives {p.family.ENTRY}; the check compares "
          f"{p.family.COVERS}", flush=True)
    out = harness.run(p, args.seed, args.seconds, bool(args.trace), "cuda",
                      T0)
    found = harness.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
