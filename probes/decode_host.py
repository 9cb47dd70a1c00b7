#!/usr/bin/env python3
"""Where a glm4-9b decode step's host time goes, for one checkout.

    python3 probes/decode_host.py [TREE]

TREE (default ``.``) is the root of a checkout; its ``src`` is the package
imported, so two commits are compared by running this script once per tree
within one call (parent, change, change, parent). At the decode_b16 cell's
shapes (B 16, a bf16 cache of 1,148 slots, position 1,100; 32 query heads
over 2 KV heads, d 128) it prints one ``[host]`` line per reading:

* ``op``: the host us to enqueue one call and the device us a call (CUDA
  events over 400 calls) of one KV head's score product, with an f32
  result from bf16 operands (``out_dtype``), in bf16, and in f32;
* ``layer``: the same two numbers for one ``layers.attention_decode``;
* ``step``: the host ms of a whole decode step at full width and depth
  (seeded bf16 weights, the flash and fused-FFN kernels, as the benchmark
  runs them), the card synchronised after each (median of 20), and the
  host ms to enqueue one;
* ``self``: the host ops with the most self time over 5 profiled steps,
  their calls a step and self us a step;
* ``batch``: one decode_b16 request as the benchmark serves it (a prefill
  of 16 x 1,020 ids, then 128 greedy steps, each step's tokens copied to
  the host): the prefill's ms and the steps' median and mean ms.
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import time
from pathlib import Path

N = 400


def _time(fn, n=N):
    """(host us to enqueue one call, device us a call) over n calls."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e6
    end.record()
    torch.cuda.synchronize()
    return host, start.elapsed_time(end) / n * 1e3


def main(tree: Path) -> None:
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    dev = torch.device("cuda", 0)
    print(f"[host] tree {tree} card {torch.cuda.get_device_name(0)} "
          f"torch {torch.__version__}", flush=True)
    cfg = registry.get("glm4-9b")
    b, size, pos = 16, 1148, 1100
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    g = cfg.n_heads_padded // hkv
    gen = torch.Generator(device=dev).manual_seed(0)
    ck = torch.randn((b, size, hkv, hd), generator=gen,
                     device=dev).bfloat16()
    qg = torch.randn((b, hkv, g, hd), generator=gen, device=dev).bfloat16()
    kt, q0 = ck[:, :, 0].transpose(1, 2), qg[:, 0]
    kt32, q32 = kt.float(), q0.float()
    for name, fn in (
            ("out_dtype", lambda: torch.bmm(q0, kt, out_dtype=torch.float32)),
            ("bf16", lambda: torch.bmm(q0, kt)),
            ("f32", lambda: torch.bmm(q32, kt32))):
        host, card = _time(fn)
        print(f"[host] op {name} host_us {host:.2f} device_us {card:.2f}",
              flush=True)

    p = L.init_attention(torch.Generator(device=dev).manual_seed(1), cfg,
                         device=dev, dtype=torch.bfloat16)
    cache = {n: torch.randn((b, size, hkv, hd), generator=gen,
                            device=dev).bfloat16() for n in "kv"}
    x = torch.randn((b, 1, cfg.d_model), generator=gen, device=dev).bfloat16()
    host, card = _time(lambda: L.attention_decode(x, p, cfg, cache, pos,
                                                  local=False), 100)
    print(f"[host] layer attention_decode host_us {host:.2f} "
          f"device_us {card:.2f}", flush=True)
    del p, cache, x, ck

    cfg = dataclasses.replace(cfg, attn_impl="kernel", block_impl="fused")
    params = lm.init_params(cfg, 0, dev, torch.bfloat16)
    kv = lm.init_cache(cfg, b, size, torch.bfloat16, dev)
    tok = torch.randint(0, cfg.vocab, (b,), generator=gen, device=dev)
    with torch.no_grad():
        for _ in range(3):
            lm.decode_step(params, cfg, kv, tok, pos)
        torch.cuda.synchronize()
        sync = []
        for _ in range(20):
            t0 = time.perf_counter()
            lm.decode_step(params, cfg, kv, tok, pos)
            torch.cuda.synchronize()
            sync.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        lm.decode_step(params, cfg, kv, tok, pos)
        enq = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        print(f"[host] step sync_ms {statistics.median(sync):.2f} "
              f"min_ms {min(sync):.2f} enqueue_ms {enq:.2f}", flush=True)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(5):
                lm.decode_step(params, cfg, kv, tok, pos)
            torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in rows[:25]:
        print(f"[host] self {e.key} calls {e.count / 5:.0f} "
              f"self_us {e.self_cpu_time_total / 5:.0f}", flush=True)
    del kv
    prompt = torch.randint(0, cfg.vocab, (b, 1020), generator=gen,
                           device=dev)
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = lm.prefill(params, cfg, prompt, max_len=1148)
            tok = logits.argmax(-1)
            tok.cpu()
            pre = (time.perf_counter() - t0) * 1e3
            ms = []
            for s in range(128):
                t0 = time.perf_counter()
                logits, cache = lm.decode_step(params, cfg, cache, tok,
                                               1020 + s)
                tok = logits.argmax(-1)
                tok.cpu()
                ms.append((time.perf_counter() - t0) * 1e3)
            print(f"[host] batch prefill_ms {pre:.1f} step_median_ms "
                  f"{statistics.median(ms):.2f} step_mean_ms "
                  f"{statistics.fmean(ms):.2f}", flush=True)
            del cache


if __name__ == "__main__":
    main(Path(sys.argv[1] if len(sys.argv) > 1 else ".").resolve())
