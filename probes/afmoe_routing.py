#!/usr/bin/env python3
"""How far the served Trinity-Mini prefill lies from its f32 reference, and
where the distance comes from: the top-8 picks that differ between the two.

    python3 probes/afmoe_routing.py [--seed S] [--requests N] [--layers L]
        [--expert-share A]

With the benchmark's weights (``bench/families/afmoe_lm.py``, drawn on the
card from the seed) and prompts of 8,192 ids (the ``prefill_8k`` mix), it
prints one line per reading:

* ``request``: for each of N requests, the relative error of the program's
  last-position logits and of the fp8 control's (the reference with fp8
  e4m3 weights), each against the f32 reference, and the reference's gap
  below its best at the program's token;
* ``layer``: for the first request, per MoE layer, the share of the 8,192
  tokens whose set of 8 experts differs between the program and the
  reference, the share at the last position so far, and the relative error
  of the router's input over all tokens.

``--layers`` cuts the depth (whole periods after the two dense layers);
``--expert-share A`` sets the share of each routed expert matrix's
variance that its layer's experts share (the benchmark's draw: 0.9; 0 draws
them apart).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    import torch

    from bench import harness
    from bench.reference import afmoe_lm as ref
    from repro_torch.models import moe

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=3100002840)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--expert-share", type=float, default=None)
    args = ap.parse_args(argv)

    p = harness.plan("trinity-mini.prefill_8k")
    cfg = json.loads(json.dumps(p.cfg))
    cfg["arch"]["n_layers"] = args.layers
    share = {} if args.expert_share is None else {
        "expert_share": args.expert_share}
    system = p.family.System(cfg, harness.seed_key(args.seed), "cuda",
                             **share)
    arch = cfg["arch"]
    data = p.kind.inputs(p.mix, cfg, harness.seed_key(args.seed), "cuda")
    prompts = torch.from_numpy(data.prompts[:args.requests, 0]).cuda()

    routes = {"program": [], "reference": []}
    route, ref_routes = moe._route, ref.routes

    def program_route(xf, prm, m):
        out = route(xf, prm, m)
        routes["program"].append((xf.float(), out[2].sort(-1).values))
        return out

    def reference_route(h, prm, m):
        out = ref_routes(h, prm, m)
        routes["reference"].append((h, out[0].sort(-1).values))
        return out

    for i in range(args.requests):
        tok = prompts[i:i + 1]
        if i == 0:
            moe._route, ref.routes = program_route, reference_route
        logits, _ = system.prefill(tok, max_len=tok.shape[1])
        want = ref.logits(system.weights, arch, tok, [tok.shape[1] - 1])
        moe._route, ref.routes = route, ref_routes
        low = ref.logits(system.weights, arch, tok, [tok.shape[1] - 1],
                         cast=ref.fp8_matrix)
        got = ref.compare(want, logits.argmax(-1)[:, None],
                          logits.float()[:, None])
        ctl = ref.compare(want, low.argmax(-1), low)
        print(f"[request] {i}: program {got['logit_rel_err']:.4f} (gap "
              f"{got['token_logit_gap']:.4f}); control "
              f"{ctl['logit_rel_err']:.4f} (gap {ctl['token_logit_gap']:.4f})",
              flush=True)
        if i == 0:
            last = 0.0
            for n, ((hp, ip), (hr, ir)) in enumerate(zip(routes["program"],
                                                         routes["reference"])):
                diff = (ip != ir).any(-1)
                last = max(last, float(diff[-1]))
                err = float((hp - hr).norm() / hr.norm())
                print(f"[layer] {n + arch['n_dense_layers']}: picks differ "
                      f"for {float(diff.float().mean()):.4f} of tokens, the "
                      f"last so far {last:.0f}; router input rel err "
                      f"{err:.5f}", flush=True)
            routes.clear()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
