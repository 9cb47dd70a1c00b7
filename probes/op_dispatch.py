#!/usr/bin/env python3
"""Host cost of launching the flash and FFN kernels through their custom
ops against calling the launchers directly, on one card.

    python3 probes/op_dispatch.py [--calls N]

At gemma2-9b's decode shapes (the FFN at T 4, d_model 3584, d_ff 14336;
flash at B 4, T 16, 16/8 heads of 256), it issues N launches back to back
each way, in the order direct, op, op, direct, and prints the host
microseconds per launch of each (the card synchronized once at the end of
each run, so a run is host-bound when a launch is shorter than its issue),
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build, flash_attention, fused_ffn  # noqa: E402


def per_launch_us(fn, calls: int) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("op_dispatch: no CUDA device", file=sys.stderr)
        return 2
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).bfloat16()

    x = rand(4, 3584)
    wg, wu = rand(3584, 14336, scale=0.02), rand(3584, 14336, scale=0.02)
    wd = rand(14336, 3584, scale=0.01)
    q, k, v = rand(4, 16, 16, 256), rand(4, 16, 8, 256), rand(4, 16, 8, 256)
    ffn_op = torch.ops.repro_torch.fused_ffn.default
    fa_op = torch.ops.repro_torch.flash_attention.default
    cases = {
        "ffn": (lambda: fused_ffn.fused_ffn_cuda(x, wg, wu, wd, act="gelu"),
                lambda: ffn_op(x, wg, wu, wd, "gelu")),
        "flash": (lambda: flash_attention.flash_attention_cuda(
                      q, k, v, causal=True, softcap=50.0),
                  lambda: fa_op(q, k, v, True, None, 50.0, None)),
    }
    with torch.no_grad():
        for name, (direct, op) in cases.items():
            runs = [("direct", direct), ("op", op), ("op", op),
                    ("direct", direct)]
            got = [(tag, per_launch_us(fn, args.calls)) for tag, fn in runs]
            print(f"[op-dispatch] {name}: host us per launch, "
                  + ", ".join(f"{tag} {us:.3f}" for tag, us in got)
                  + f" ({args.calls} launches a run)")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
