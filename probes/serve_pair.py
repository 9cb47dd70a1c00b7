#!/usr/bin/env python3
"""Time the LM serving calls of one checkout on one card.

    python3 probes/serve_pair.py TREE [--reps N]

TREE is the root of a checkout; its ``src`` is the package imported, so
two commits are compared by running this script once per tree within one
call, in the order A, B, B, A. At full width and depth, with seeded random
bf16 weights and the flash and fused-FFN kernels (``attn_impl="kernel"``,
``block_impl="fused"``), it times on the host clock (the card synchronized
after each call) ``N`` calls each of:

* hubert-xlarge's ``lm.forward`` on B 4 x 512 seeded frames;
* recurrentgemma-9b's ``lm.prefill`` at B 4, P 512 and its
  ``lm.decode_step`` after it (every step at the same position).

It prints one line per call type with the median, least and greatest ms,
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path


def host_ms(fn, reps: int, warm: int = 2):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree", type=Path)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serve_pair: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import registry
    from repro_torch.models import lm
    import repro_torch
    where = Path(repro_torch.__file__).resolve().parents[2]
    if where != args.tree.resolve():
        print(f"serve_pair: imported {where}, not {args.tree}",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    rows = []

    def cfg_of(name):
        return dataclasses.replace(registry.get(name), attn_impl="kernel",
                                   block_impl="fused")

    cfg = cfg_of("hubert-xlarge")
    params = lm.init_params(cfg, 0, device)
    frames = torch.from_numpy(rng.standard_normal(
        (4, 512, cfg.d_model)).astype(np.float32)).to(device)
    with torch.no_grad():
        rows.append(("hubert-xlarge forward B4 T512", host_ms(
            lambda: lm.forward(params, cfg, frames=frames), args.reps)))
    del params
    torch.cuda.empty_cache()

    cfg = cfg_of("recurrentgemma-9b")
    params = lm.init_params(cfg, 0, device)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 512))).to(
        device)
    state = {}

    def prefill():
        state["logits"], state["cache"] = lm.prefill(
            params, cfg, prompts, max_len=512 + 16)

    def decode():
        token = state["logits"][:, :cfg.vocab].argmax(-1)
        lm.decode_step(params, cfg, state["cache"], token, 512)

    with torch.no_grad():
        rows.append(("recurrentgemma-9b prefill B4 P512",
                     host_ms(prefill, max(3, args.reps // 4))))
        rows.append(("recurrentgemma-9b decode step B4",
                     host_ms(decode, args.reps)))
    for name, ms in rows:
        print(f"[serve-pair] {args.tree}: {name}: median "
              f"{statistics.median(ms):.6f} ms, least {min(ms):.6f}, "
              f"greatest {max(ms):.6f} ({len(ms)} calls)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()
    print(f"[serve-pair] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
