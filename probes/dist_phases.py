#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s build and multi-device phases alone on one card.

    python3 probes/dist_phases.py [--gpu-tests]

Phase 2 (build every kernel), then phases 31-33: gemma2-9b served through
the mesh serving steps on a one-card (1, 1) mesh against the eager path,
internvl2-1b's mesh train step against the meshless one, and five
full-size cells of the dry run on fake ``cuda`` tensors. ``--gpu-tests``
first runs the card's tests of the kernels and their custom ops (``pytest
--noconftest -m gpu tests/test_torch_kernels.py``). It fails as
``chip_smoke.py`` does.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("dist_phases: no CUDA device", file=sys.stderr)
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
    cs.phases_dist(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
