#!/usr/bin/env python3
"""Repeat ``chip_smoke.py``'s f32 flash-attention checks on one card.

    python3 probes/flash_f32_repeat.py [--reps 50]

One process, ``torch.set_num_threads`` fixed at its default. Each repeat
draws the six f32 cases of chip_smoke.py phase 8 (the first repeat with
phase 8's own generator seed, so with its inputs) and records, separately:

- kernel vs the plain version on the card;
- the plain version on the card vs the plain version on the CPU;
- the kernel vs the plain version on the CPU, in float32 and computed in
  float64 and cast to float32;
- whether the kernel's output changes between two launches on the same
  inputs, and whether the CPU plain version's does.

A case fails a comparison when ``torch.allclose(atol=rtol=2e-5)`` does not
hold. The last line is a JSON object with the counts.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402

TOL = 2e-5
CASES = [(128, 128, 64, True, None, None),      # chip_smoke.py phase 8
         (256, 256, 64, True, None, 50.0),
         (128, 384, 64, False, None, None),
         (256, 256, 64, True, 64, None),
         (100, 100, 32, True, None, None),
         (64, 160, 32, False, 48, None)]


def f64_plain(q, k, v, **kw):
    """The plain version computed in float64 on the CPU, cast to float32."""
    return ref.attention_ref(q.double(), k.double(), v.double(),
                             **kw).float()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    threads = torch.get_num_threads()
    torch.set_num_threads(threads)
    dev = torch.device("cuda", 0)
    keys = ["kernel_vs_card_plain", "card_plain_vs_cpu_plain",
            "kernel_vs_cpu_plain", "kernel_vs_cpu_f64", "kernel_nondeterministic",
            "cpu_plain_nondeterministic"]
    fails = {k: 0 for k in keys}
    worst = {k: 0.0 for k in keys}
    worst_case = {}
    n = 0
    for rep in range(args.reps):
        gen = torch.Generator(device=dev).manual_seed(21 + rep)
        for tq, tk, d, causal, window, softcap in CASES:
            q, k, v = ((torch.randn((4, t, d), generator=gen, device=dev))
                       for t in (tq, tk, tk))
            kw = dict(causal=causal, window=window, softcap=softcap)
            got = ops.attention(q, k, v, **kw)
            again = ops.attention(q, k, v, **kw)
            card = ref.attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            qc, kc, vc = q.cpu(), k.cpu(), v.cpu()
            cpu = ref.attention_ref(qc, kc, vc, **kw)
            cpu2 = ref.attention_ref(qc, kc, vc, **kw)
            cpu64 = f64_plain(qc, kc, vc, **kw)
            got_c, card_c = got.cpu(), card.cpu()
            pairs = {"kernel_vs_card_plain": (got_c, card_c),
                     "card_plain_vs_cpu_plain": (card_c, cpu),
                     "kernel_vs_cpu_plain": (got_c, cpu),
                     "kernel_vs_cpu_f64": (got_c, cpu64)}
            for key, (a, b) in pairs.items():
                err = float((a - b).abs().max())
                if err > worst[key]:
                    worst[key] = err
                    worst_case[key] = f"rep {rep} {tq}x{tk}x{d} {kw}"
                if not torch.allclose(a, b, atol=TOL, rtol=TOL):
                    fails[key] += 1
            if not torch.equal(got, again):
                fails["kernel_nondeterministic"] += 1
            if not torch.equal(cpu, cpu2):
                fails["cpu_plain_nondeterministic"] += 1
            n += 1
        if rep % 10 == 9:
            print(f"[repeat] {rep + 1} repeats: failures {fails}", flush=True)
    print(f"[repeat] {n} case runs ({args.reps} repeats x {len(CASES)}), "
          f"torch {torch.__version__}, {threads} CPU threads")
    for key in keys:
        print(f"[repeat] {key}: {fails[key]} of {n}; largest max |diff| "
              f"{worst[key]} ({worst_case.get(key, '-')})")
    print(json.dumps({"case_runs": n, "threads": threads, "failures": fails,
                      "worst": worst}))


if __name__ == "__main__":
    main()
