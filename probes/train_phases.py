#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s build and training phases alone on one card.

    python3 probes/train_phases.py [--gpu-tests]

Phase 2 (build every kernel), then phases 28-30: the ten smoke archs'
gradients through the flash and fused-FFN kernels against their plain
versions in f32 and bf16, ``launch.train`` on internvl2-1b at full width
with a preemption and a restart from its checkpoint against an
uninterrupted run, and the three remat modes' step time, tokens/s, busy
share and peak memory. ``--gpu-tests`` first runs the card's tests of the
kernels' gradients (``pytest --noconftest -m gpu
tests/test_torch_kernels.py``). It fails as ``chip_smoke.py`` does.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("train_phases: no CUDA device", file=sys.stderr)
        return 2
    cs.say(cs.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cs.phase_build()
    if "--gpu-tests" in sys.argv[1:]:
        rc = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "--noconftest", "-m", "gpu",
             "-p", "no:cacheprovider", "tests/test_torch_kernels.py"],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": "src"},
            timeout=600).returncode
        cs.check(rc == 0, f"gpu tests exited {rc}")
    t0 = time.perf_counter()
    cs.phase_train_grads(device)
    cs.phase_train_entry(device)
    cs.phase_train_remat(device)
    cs.say(f"[train] phases 28-30: {time.perf_counter() - t0:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
