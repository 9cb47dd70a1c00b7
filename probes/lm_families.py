#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s build and MoE, RG-LRU and RWKV6 phases alone on
one card.

    python3 probes/lm_families.py

Phase 2 (build every kernel, the launchers' plans against the Python
plans), then phases 25-27: qwen2-moe-a2.7b, llama4-scout-17b-a16e (12 of
48 layers), recurrentgemma-9b and rwkv6-3b served through ``launch.serve``
with every flash and FFN call held to its plain version, their profiles,
and their kernel shapes timed. It fails as ``chip_smoke.py`` does; the
last line is the {"kernels": [...]} record of phase 26.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_families: no CUDA device", file=sys.stderr)
        return 2
    cs.say(cs.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cs.phase_build()
    t0 = time.perf_counter()
    runs = {name: cs.phase_arch_serve(name, device, "family")
            for name in cs.FAMILY_ARCHS}
    rows = cs.phase_dense_kernel_times(device, runs, cs.FAMILY_ARCHS, 61)
    cs.dense_summary(runs, "family-summary")
    cs.say(f"[family] phases 25-27: {time.perf_counter() - t0:.2f} s")
    cs.say(json.dumps({"kernels": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
