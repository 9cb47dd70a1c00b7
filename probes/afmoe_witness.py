#!/usr/bin/env python3
"""Whether the Trinity-Mini cell's logit comparison tells the program's
precision from a lower one, and whether it catches a wrong dispatch.

    python3 probes/afmoe_witness.py [--witness SEED:SHARE ...]
        [--faults SEED ...] [--window S] [--requests N]

``--witness SEED:SHARE``: the benchmark's weights drawn from SEED with
SHARE of each routed expert matrix's variance shared by its layer's
experts (the benchmark's draw: 0.9; 0 draws them apart), N prompts of the
``prefill_8k`` mix, and the largest relative error of the last-position
logits against the f32 reference (``bench/reference/afmoe_lm.py``) of:

* ``program``: the port, as the cell serves it;
* ``ref_bf16_act``: the reference with every RMSNorm's output (the input
  of each of its matrices, and what each block adds to the stream)
  rounded to bf16, as a bf16 serving stack rounds them;
* ``ref_bf16_embed``: the reference with one rounding alone, the scaled
  embedding rounded to bf16 before the first layer;
* ``control``: the reference with fp8 e4m3 matrices (the cell's control).

The two ``ref_`` readings run no code of the port: if they lie as far from
the f32 reference as the program, the distance is the routing's, not the
program's. The weights are drawn in bf16, so the reference with its
matrices cast to bf16 is the f32 reference itself.

``--faults SEED``: the cell's own draw and traffic; for the program and
each planted fault of its dropless dispatch, a window of ``--window``
seconds and the harness's own check (``bench/traffic/prefill.py``'s
``check``) against the cell's limit. The faults: the grouped offsets
shifted by one expert (each group's rows to the previous expert); the
experts permuted; the gates taken from the scores plus the selection
bias; each expert's rows past capacity 640 dropped (the capacity path's
cut at 8,192 tokens). One JSON line per reading. Run it on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

WORKLOAD = "trinity-mini.prefill_8k"
CAPACITY = 640         # 8,192 tokens x 8 / 128 experts x 1.25


@contextlib.contextmanager
def patched(mod, name, fn):
    old = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, old)


def faults(moe, n_experts: int):
    """(name, context manager) of each planted fault."""
    import torch

    offsets, grouped = moe._offsets, moe._grouped
    perm = torch.randperm(n_experts, generator=torch.Generator()
                          .manual_seed(0))

    def shifted(counts):
        o = offsets(counts)
        return torch.cat([o[1:], o[-1:]])

    def permuted(a, w, offs):
        return grouped(a, w[perm.to(w.device)], offs)

    def biased_gates(xf, p, m):
        s = torch.sigmoid(xf.float() @ p["router"])
        ids = torch.topk(s + p["route_bias"], m.top_k, dim=-1)[1]
        g = (s + p["route_bias"]).gather(-1, ids)
        return s, g * (m.route_scale / g.sum(-1, keepdim=True)), ids

    def capacity(a, w, offs):
        row = torch.arange(a.shape[0], dtype=offs.dtype, device=a.device)
        group = torch.searchsorted(offs, row, right=True)
        start = torch.cat([offs.new_zeros(1), offs])[group]
        return grouped(a, w, offs) * ((row - start) < CAPACITY)[:, None]

    return [("none", contextlib.nullcontext()),
            ("offsets_shifted", patched(moe, "_offsets", shifted)),
            ("experts_permuted", patched(moe, "_grouped", permuted)),
            ("gates_from_biased_scores", patched(moe, "_route",
                                                 biased_gates)),
            ("capacity_640", patched(moe, "_grouped", capacity))]


def witness(p, seed: int, share: float, requests: int) -> dict:
    import torch

    from bench import harness
    ref = p.reference
    key = harness.seed_key(seed)
    system = p.family.System(p.cfg, key, "cuda", expert_share=share)
    arch, weights = p.cfg["arch"], system.weights
    data = p.kind.inputs(p.mix, p.cfg, key, "cuda")
    scale = arch["d_model"] ** 0.5
    norm = ref.rms_norm

    class RoundedEmbed:
        def __getitem__(self, ids):
            x = weights["embed"][ids].float() * scale
            return x.bfloat16().float() / scale

    out = {"program": 0.0, "ref_bf16_act": 0.0, "ref_bf16_embed": 0.0,
           "control": 0.0}
    for i in range(requests):
        tok = torch.from_numpy(data.prompts[i]).cuda()
        pos = [tok.shape[1] - 1]
        logits, _ = system.prefill(tok, max_len=tok.shape[1])
        want = ref.logits(weights, arch, tok, pos)
        with patched(ref, "rms_norm",
                     lambda x, s, eps: norm(x, s, eps).bfloat16().float()):
            act = ref.logits(weights, arch, tok, pos)
        emb = ref.logits(dict(weights, embed=RoundedEmbed()), arch, tok, pos)
        low = ref.logits(weights, arch, tok, pos, cast=ref.fp8_matrix)
        for name, got in (("program", logits.float()[:, None]),
                          ("ref_bf16_act", act), ("ref_bf16_embed", emb),
                          ("control", low)):
            err = ref.compare(want, got.argmax(-1), got)["logit_rel_err"]
            out[name] = max(out[name], err)
        torch.cuda.empty_cache()
    del system
    return {"seed": seed, "expert_share": share, "requests": requests,
            **out}


def planted(p, seed: int, window: float):
    from bench import harness
    from repro_torch.models import moe

    key = harness.seed_key(seed)
    system = p.family.System(p.cfg, key, "cuda")
    data = p.kind.inputs(p.mix, p.cfg, key, "cuda")
    p.kind.warm(system, data, p.mix)
    for name, ctx in faults(moe, p.cfg["arch"]["moe"]["n_experts"]):
        with ctx:
            rec = p.kind.window(system, data, p.mix, window)
        (c,) = [c for c in p.kind.check(system, data, p.mix, rec,
                                        p.reference, p.limits, key)
                if c.name == "logit_rel_err"]
        yield {"seed": seed, "fault": name, "requests": rec.attempted,
               "logit_rel_err": c.value, "limit": c.limit,
               "correct": c.value <= c.limit}
    del system


def main(argv=None) -> int:
    import torch

    from bench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--witness", nargs="*", default=[])
    ap.add_argument("--faults", type=int, nargs="*", default=[])
    ap.add_argument("--window", type=float, default=3.0)
    ap.add_argument("--requests", type=int, default=8)
    args = ap.parse_args(argv)
    p = harness.plan(WORKLOAD)

    def done(line):
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()

    for item in args.witness:
        seed, share = item.split(":")
        t = time.perf_counter()
        line = witness(p, int(seed), float(share), args.requests)
        done(dict(line, s=time.perf_counter() - t))
    for seed in args.faults:
        for line in planted(p, seed, args.window):
            print(json.dumps(line), flush=True)
        done({"seed": seed, "faults": "done"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
