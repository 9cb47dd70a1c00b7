#!/usr/bin/env python3
"""Host synchronisations inside the LM step, for one checkout.

    python3 probes/step_syncs.py cell TREE --seed N [--out DIR]
    python3 probes/step_syncs.py families TREE

TREE is the root of a checkout; its ``src`` and ``bench`` are imported, so
two commits are compared by running ``cell`` once per tree on one card, in
turns (parent, change, change, parent).

``cell`` builds the ``glm4-9b.prefill_1500`` cell's system (its weights
drawn on the card from ``--seed``, its prompts from the same seed) and
prints one ``[syncs]`` JSON line:

* ``prefill_syncs`` / ``decode_syncs``: the ``cudaStreamSynchronize``
  events inside one ``lm.prefill`` / ``lm.decode_step`` span of a profile
  of the host and the card, the ids on the host as the cell sends them
  (``host_ids``) and already on the card (``card_ids``);
* ``request_ms``: the median wall ms of 10 requests as the cell serves
  them (ids from the host, the first token back on the host), and
  ``issue_ms``: the median host ms until ``lm.prefill`` returns, before
  the card has finished;
* ``logits_sha256``: the hash of the first prompt's logits, bit for bit
  (written to ``DIR/<tag>.pt`` with ``--out``).

``families`` runs every LM arch of the port at full width, cut to its
leading dense layers plus one pattern unit, through ``lm.prefill`` of 256
ids on the card and one ``lm.decode_step`` (hubert-xlarge: ``lm.forward``)
under the sync debug mode that warns, after a warm-up, and prints per arch
where each synchronisation was issued (the innermost frame in the port).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import statistics
import sys
import time
import traceback
import warnings
from pathlib import Path

SYNC = "cudaStreamSynchronize"


def _import_tree(tree: Path) -> None:
    sys.path[:0] = [str(tree / "src"), str(tree)]


def _syncs_in(prof, span: str) -> int:
    """``cudaStreamSynchronize`` events whose start lies inside the one
    ``repro_torch::<span>`` event of ``prof``."""
    events = prof.events()
    (outer,) = [e for e in events if e.name == f"repro_torch::{span}"]
    r = outer.time_range
    return sum(1 for e in events if e.name == SYNC
               and r.start <= e.time_range.start <= r.end)


def _profiled(fn):
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return prof, out


def cell(tree: Path, seed: int, out: Path | None) -> None:
    _import_tree(tree)
    import torch

    from bench.families import dense_lm
    from bench.traffic import prefill as traffic
    dev = torch.device("cuda", 0)
    cfg = json.loads((tree / "bench/configs/glm4-9b.json").read_text())
    mix = json.loads((tree / "bench/workloads/prefill_1500.json").read_text())
    system = dense_lm.System(cfg, seed, dev)
    data = traffic.inputs(mix, cfg, seed, dev)
    prompt = data.prompts[0]
    t = prompt.shape[1]
    traffic.warm(system, data, mix)
    card = torch.from_numpy(prompt).to(dev)

    def prefill_decode(ids):
        logits, cache = system.prefill(ids, max_len=t + 1)
        return system.decode(cache, logits.argmax(-1), t)

    prefill_decode(card)
    prof_host, _ = _profiled(lambda: traffic.request(system, prompt))
    prof_card, _ = _profiled(lambda: prefill_decode(card))
    walls, issues = [], []
    for j in range(10):
        p = data.prompts[j % len(data.prompts)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = system.prefill(torch.from_numpy(p), max_len=t)
        t1 = time.perf_counter()
        logits.argmax(-1).cpu()
        walls.append((time.perf_counter() - t0) * 1e3)
        issues.append((t1 - t0) * 1e3)
        del cache
    _, logits = traffic.request(system, prompt)
    raw = logits.float().cpu().contiguous()
    line = {
        "tree": str(tree), "card": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "seed": seed,
        "prefill_syncs": {"host_ids": _syncs_in(prof_host, "lm.prefill"),
                          "card_ids": _syncs_in(prof_card, "lm.prefill")},
        "decode_syncs": {"card_ids": _syncs_in(prof_card, "lm.decode_step")},
        "request_ms": statistics.median(walls),
        "issue_ms": statistics.median(issues),
        "logits_sha256": hashlib.sha256(raw.numpy().tobytes()).hexdigest(),
    }
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        torch.save(raw, out / f"{tree.name or 'tree'}.pt")
    print("[syncs] " + json.dumps(line), flush=True)


def families(tree: Path) -> None:
    _import_tree(tree)
    import torch

    from repro_torch.configs import registry
    from repro_torch.models import lm
    dev = torch.device("cuda", 0)
    src = str(tree / "src")
    names = list(registry.ARCH_NAMES) + list(registry.PORT_ONLY)
    for name in names:
        cfg = registry.get(name)
        cfg = dataclasses.replace(
            cfg, n_layers=cfg.n_dense_layers + len(cfg.pattern),
            attn_impl="kernel", block_impl="fused")
        params = lm.init_params(cfg, seed=31, device=dev)
        gen = torch.Generator(device=dev).manual_seed(31)
        t = 256
        ids = torch.randint(0, cfg.vocab, (1, t + 1), generator=gen,
                            device=dev)

        def step():
            if cfg.frontend == "audio":
                frames = torch.randn((1, t, cfg.d_model), generator=gen,
                                     device=dev)
                return lm.forward(params, cfg, frames=frames)
            _, cache = lm.prefill(params, cfg, ids[:, :t], max_len=t + 1)
            return lm.decode_step(params, cfg, cache, ids[:, t], t)

        step()
        torch.cuda.synchronize()
        sites: dict = {}

        def show(message, category, filename, lineno, file=None, line=None):
            frames = [f for f in traceback.extract_stack()
                      if f.filename.startswith(src)]
            where = (f"{Path(frames[-1].filename).relative_to(src)}:"
                     f"{frames[-1].lineno} {frames[-1].name}"
                     if frames else f"{filename}:{lineno}")
            sites[where] = sites.get(where, 0) + 1

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print("[syncs] " + json.dumps({"arch": name, "layers": cfg.n_layers,
                                       "sites": sites}), flush=True)
        del params
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=["cell", "families"])
    ap.add_argument("tree", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    tree = args.tree.resolve()
    if args.what == "cell":
        cell(tree, args.seed, args.out)
    else:
        families(tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
