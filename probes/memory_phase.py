#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s build and phase 34 alone on one card, and time
dry-run cells on the card's host.

    python3 probes/memory_phase.py [--cell ARCH/SHAPE/MESH ...]
                                   [--cell-timeout SECONDS]

Phase 2 (build every kernel), then phase 34: one real train step of
rwkv6-3b and of gemma2-9b at full width and two pattern units on the
meshless path, the card's peak allocated bytes over the step's arguments
against the dry run's live estimate of the same step on fake tensors.
Each ``--cell`` then runs ``python -m repro_torch.launch.dryrun`` for that
cell in its own process, stopped after ``--cell-timeout`` seconds (default
150), and its wall seconds, status, ``fits`` and live bytes are printed:
the check of whether a cell is quick enough for phase 33. It fails as
``chip_smoke.py`` does.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def time_cell(cell: str, limit: float) -> None:
    arch, shape, mesh = cell.split("/")
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        try:
            rc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", mesh, "--out", out],
                cwd=ROOT, env={**os.environ, "PYTHONPATH": "src"},
                capture_output=True, timeout=limit).returncode
        except subprocess.TimeoutExpired:
            cs.say(f"[cell] {cell}: still running after {limit:.0f} s, "
                   f"stopped")
            return
        took = time.perf_counter() - t0
        rec = json.loads((Path(out) / f"{arch}__{shape}__{mesh}.json")
                         .read_text())
        live = rec.get("memory", {}).get("temp_bytes")
        cs.say(f"[cell] {cell}: rc {rc}, {took:.2f} s, status "
               f"{rec['status']}, fits {rec.get('fits')}, live {live:,} B "
               f"on fake {rec.get('fake_device')} tensors"
               if live is not None else
               f"[cell] {cell}: rc {rc}, {took:.2f} s, {rec.get('error')}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", action="append", default=[])
    ap.add_argument("--cell-timeout", type=float, default=150.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("memory_phase: no CUDA device", file=sys.stderr)
        return 2
    cs.say(cs.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build()
    cs.phase_memory_check(torch.device("cuda", 0))
    for cell in args.cell:
        time_cell(cell, args.cell_timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
