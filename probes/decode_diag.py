#!/usr/bin/env python3
"""Time recurrentgemma-9b's decode step of one checkout three ways.

    python3 probes/decode_diag.py TREE

TREE is the root of a checkout; its ``src`` is the package imported, so
two commits are compared by running this script once per tree within one
call (parent, change, parent, change). At full width and depth, seeded
bf16 weights and the flash and fused-FFN kernels, after a B 4, P 512
prefill, it times ``lm.decode_step`` (every step at the same position):

* ``sync``: 40 steps on the host clock, the card synchronized after each
  (median and least ms);
* ``enqueue``: the host ms to enqueue 5 steps, per step (median of 10);
* ``events``: CUDA events around those 5 steps, per step (median of 10).

A tree whose FFN launches go through the ``repro_torch::fused_ffn``
operator (``kernels.fused_ffn._launch``) is timed as is, then with the
launch calling ``fused_ffn_cuda`` directly (the operator's dispatch
bypassed), then as is again. It prints one ``[diag]`` line per reading.
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import time
from pathlib import Path


def main(tree: Path) -> None:
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(registry.get("recurrentgemma-9b"),
                              attn_impl="kernel", block_impl="fused")
    params = lm.init_params(cfg, 0, dev)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 512))).to(dev)
    with torch.no_grad():
        logits, cache = lm.prefill(params, cfg, prompts, max_len=528)
        tok = logits[:, :cfg.vocab].argmax(-1)

        def step():
            lm.decode_step(params, cfg, cache, tok, 512)

        def measure(tag):
            for _ in range(5):
                step()
            torch.cuda.synchronize()
            sync, enq, dev_ms = [], [], []
            for _ in range(40):
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                sync.append((time.perf_counter() - t0) * 1e3)
            for _ in range(10):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e0.record()
                for _ in range(5):
                    step()
                e1.record()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                enq.append((t1 - t0) * 1e3 / 5)
                dev_ms.append(e0.elapsed_time(e1) / 5)
            print(f"[diag] {tree.name} {tag}: sync median "
                  f"{statistics.median(sync):.3f} min {min(sync):.3f}; "
                  f"enqueue {statistics.median(enq):.3f}; events "
                  f"{statistics.median(dev_ms):.3f}")

        measure("as is")
        from repro_torch.kernels import fused_ffn as F
        if hasattr(F, "_launch"):
            saved = F._launch
            F._launch = lambda x, wg, wu, wd, act: F.fused_ffn_cuda(
                x, wg, wu, wd, act=act)
            measure("ffn op bypassed")
            F._launch = saved
            measure("as is again")


if __name__ == "__main__":
    main(Path(sys.argv[1]).resolve())
