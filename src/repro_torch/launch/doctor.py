"""CFU perf doctor: cycle-bound attribution, what-ifs, roofline points.

    python -m repro_torch.launch.doctor --block 3rd --schedule fused-rowtile \
        --pe 9,2,56                       # the winograd-gate point
    python -m repro_torch.launch.doctor --net mobilenetv2 --schedule auto
    python -m repro_torch.launch.doctor --network vww --streams 2 \
        --pe-per-core auto-hetero --batch 4
    python -m repro_torch.launch.doctor --block 3rd --per-phase --json out.json

Where ``launch.cfu`` reports WHAT a compiled network costs, this
launcher reports WHY (``repro_torch.cfu.doctor``):

* **Attribution** — every modeled cycle classified into the exhaustive
  bound taxonomy (``doctor.CATEGORIES``: per-engine compute, requant,
  GAP, pipeline fill, DRAM/SRAM port, weight reload, handoff sync); the
  category sums equal the model's ``total_cycles`` (``interval_cycles``
  for ``--streams N``) bit-exactly. ``--per-phase`` adds the per-phase
  rows.
* **What-if sensitivity** — the same program re-priced under finite
  perturbations (one more engine per MAC array, 2x scratch port, free
  handoffs, 2x DRAM port; plus the other schedules when ``--block``
  names a single layer), ranked by cycles saved. Every row's perturbed
  config reproduces its number exactly when re-analyzed fresh.
* **explain-auto** — with ``--schedule auto``, the per-block candidate
  cost table the auto pass argmins over, with pick and margin.
* **Roofline** — achieved MACs/cycle against the engine ceiling and
  both port ceilings at this point's arithmetic intensity, rendered by
  the shared ``repro_torch.roofline.points`` table (one point per core under
  ``--streams N``).

``--json`` writes all of the above as one payload
(``results/cfu/doctor_*.json`` by convention). The serving-side doctor
(latency decomposition + SLO burn) lives in ``launch.serve_cfu
--doctor``.

Port of ``repro.launch.doctor``: host code over the port's compiler and
cost model, whose payload equals the reference CLI's. It needs no device
and no weights. Every cycle it prints is the simulated CFU's.
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.cfu import doctor
from repro_torch.cfu.compiler import (AUTO_HETERO, AUTO_SCHEDULE,
                                MultiStreamProgram, compile_network,
                                compile_vww_network, schedule_names)
from repro_torch.cfu.ir import SCHEDULES, build_chain_ir, build_vww_ir
from repro_torch.cfu.report import PAPER_LAYERS
from repro_torch.cfu.timing import (BatchCostModel, MultiStreamCostModel,
                                    PEConfig)
from repro_torch.configs.vww import VWW
from repro_torch.roofline.points import points_json, points_table


def _parse_pe(text):
    if text is None:
        return None
    parts = [int(t) for t in text.split(",")]
    if len(parts) != 3:
        raise SystemExit("--pe wants exp_pes,dw_lanes,proj_engines")
    return PEConfig(*parts)


def _parse_pe_per_core(text, streams: int):
    if text is None:
        return None
    if streams <= 1:
        raise SystemExit("--pe-per-core needs --streams > 1")
    if text == AUTO_HETERO:
        return AUTO_HETERO
    return [_parse_pe(t) for t in text.split(";")]


def _build_ir(args, specs, hw):
    if args.network:
        return build_vww_ir(specs, hw, img_ch=VWW.img_ch,
                            head_ch=VWW.head_ch, n_classes=VWW.n_classes)
    return build_chain_ir(specs, hw, hw)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    tgt = ap.add_mutually_exclusive_group()
    tgt.add_argument("--network", choices=["vww"], default=None,
                     help="full inference: stem + blocks + head + GAP + FC")
    tgt.add_argument("--net", choices=["mobilenetv2"], default=None,
                     help="DSC bottleneck chain only (paper partitioning)")
    tgt.add_argument("--block", choices=[n for n, _, _ in PAPER_LAYERS],
                     default=None,
                     help="one paper layer at its published size "
                          "(default target when nothing else is given: "
                          "the 3rd block)")
    ap.add_argument("--schedule", default="fused",
                    choices=schedule_names(include_auto=True))
    ap.add_argument("--pipeline", default="v3", choices=["v1", "v2", "v3"])
    ap.add_argument("--batch", type=int, default=1,
                    help="frames per group (multi-stream: per round)")
    ap.add_argument("--streams", type=int, default=1,
                    help="partition across N CFU cores sharing DRAM")
    ap.add_argument("--pe", default=None, metavar="E,D,P",
                    help="engine counts (default: the paper's 9,9,56)")
    ap.add_argument("--pe-per-core", default=None,
                    metavar="E,D,P;...|auto-hetero",
                    help="per-core engine counts for --streams N")
    ap.add_argument("--hw", type=int, default=40,
                    help="feature-map size for --net (stem output)")
    ap.add_argument("--img-hw", type=int, default=VWW.img_hw,
                    help="image size for --network vww")
    ap.add_argument("--tile-rows", type=int, default=4)
    ap.add_argument("--sram-port-bytes", type=int, default=None,
                    help="scratch port width (default 1 B/cycle)")
    ap.add_argument("--handoff-sync-cycles", type=float, default=None,
                    help="double-buffer boundary cost (default 64)")
    ap.add_argument("--dram-cycles-per-byte", type=float, default=None,
                    help="off-chip port cost (default 45.6 cyc/B)")
    ap.add_argument("--per-phase", action="store_true",
                    help="add the per-phase attribution rows")
    ap.add_argument("--json", default=None,
                    help="write the full doctor payload to this path")
    args = ap.parse_args(argv)
    if not (args.network or args.net or args.block):
        args.block = "3rd"

    knobs = {"sram_port_bytes": args.sram_port_bytes,
             "handoff_sync_cycles": args.handoff_sync_cycles,
             "dram_cycles_per_byte": args.dram_cycles_per_byte}
    pe = _parse_pe(args.pe)
    ppc = _parse_pe_per_core(args.pe_per_core, args.streams)

    if args.block:
        name, spec, hw = {n: (n, s, h)
                          for n, s, h in PAPER_LAYERS}[args.block]
        specs, target = [(name, spec)], f"block {args.block} ({hw}x{hw})"
    elif args.net:
        from repro_torch.models import mobilenetv2
        specs, hw = mobilenetv2.block_specs(), args.hw
        target = f"mobilenetv2 DSC chain ({hw}x{hw})"
    else:
        from repro_torch.models import mobilenetv2
        specs, hw = mobilenetv2.block_specs(), args.img_hw
        target = f"vww {hw}x{hw}"
    print(f"# perf doctor: {target}, schedule={args.schedule}, "
          f"pipeline={args.pipeline}, batch={args.batch}, "
          f"streams={args.streams}")

    payload = {"target": target, "schedule": args.schedule,
               "pipeline": args.pipeline, "batch": args.batch,
               "streams": args.streams}

    if args.schedule == AUTO_SCHEDULE:
        expl = doctor.explain_auto(_build_ir(args, specs, hw),
                                   pipeline=args.pipeline, pe=pe,
                                   tile_rows=args.tile_rows)
        print("\n".join(expl.lines()))
        payload["explain_auto"] = expl.to_json()

    if args.network:
        prog = compile_vww_network(specs, hw, args.schedule,
                                   img_ch=VWW.img_ch, head_ch=VWW.head_ch,
                                   n_classes=VWW.n_classes, pe=pe,
                                   streams=args.streams, pe_per_core=ppc,
                                   pipeline=args.pipeline)
    else:
        prog = compile_network(specs, hw, hw, args.schedule, pe=pe,
                               streams=args.streams, pe_per_core=ppc,
                               tile_rows=args.tile_rows,
                               pipeline=args.pipeline)

    multi = isinstance(prog, MultiStreamProgram)
    if multi:
        mm = MultiStreamCostModel(prog, args.pipeline, **knobs)
        attr = doctor.attribute_multistream_model(mm, args.batch)
        rows = doctor.what_if_multistream(prog, args.pipeline,
                                          batch=args.batch, **knobs)
        points = [doctor.roofline_point(
            r, f"core{i}",
            sram_port_bytes=args.sram_port_bytes,
            dram_cycles_per_byte=args.dram_cycles_per_byte)
            for i, r in enumerate(mm.report(args.batch).per_stream)]
    else:
        m = BatchCostModel(prog, args.pipeline, **knobs)
        attr = doctor.attribute_model(m, args.batch)
        rows = doctor.what_if(prog, args.pipeline, batch=args.batch,
                              **knobs)
        if args.block:
            cur = SCHEDULES[args.schedule][0] \
                if args.schedule != AUTO_SCHEDULE \
                else SCHEDULES[prog.meta["block_schedules"][name]][0]
            rows = doctor.rank(rows + doctor.what_if_schedules(
                spec, hw, hw, cur, pipeline=args.pipeline, pe=m.pe,
                batch=args.batch, tile_rows=args.tile_rows, **knobs))
        points = [doctor.roofline_point(
            m.report(args.batch), target,
            sram_port_bytes=args.sram_port_bytes,
            dram_cycles_per_byte=args.dram_cycles_per_byte)]

    print("\n".join(doctor.attribution_lines(attr,
                                             per_phase=args.per_phase)))
    print("\n".join(doctor.what_if_lines(rows)))
    print("\n".join(points_table(points)))
    payload.update({"attribution": attr.to_json(),
                    "what_ifs": [r.to_json() for r in rows],
                    "roofline": points_json(points)})

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"# wrote {args.json}")
    return payload


if __name__ == "__main__":
    main()
