"""CFU simulator launcher: compile, execute, and time a network on the CFU.

    python -m repro_torch.launch.cfu --network vww            # full inference
    python -m repro_torch.launch.cfu --network vww --batch 8 --pe 18,18,112
    python -m repro_torch.launch.cfu --net mobilenetv2 --schedule auto
    python -m repro_torch.launch.cfu --block 3rd --schedule fused-winograd \\
        --pe 9,2,56
    python -m repro_torch.launch.cfu --network vww --streams 3
    python -m repro_torch.launch.cfu --network vww --backend fast \\
        --batch 256 --schedule all
    python -m repro_torch.launch.cfu --device cpu --network vww --backend fast

Port of ``repro.launch.cfu``. The compiler, timing model and golden
executor are numpy on the host; ``--backend fast`` runs the fast path on
``--device`` (default ``cuda``; it raises without a card unless
``--device cpu`` is given), whose fused and row-tile stages launch the
hand-written DSC kernel there. Weights come from a numpy generator seeded
with ``--seed``, so they differ from the reference's.

``--network vww`` lowers a COMPLETE MobileNetV2-VWW inference — stem conv,
bottleneck chain, head 1x1, global average pool, FC — into one instruction
stream (``compile_vww_network``) and, unless ``--no-verify`` is given,
executes the encoded words through the golden executor for batch size 1
AND ``--batch`` images at once (the batched executor runs one stream over
all images in lockstep), checking bit-exactly against
``models.mobilenetv2.forward_int8(..., return_quantized=True)`` per image.

``--net mobilenetv2`` lowers only the bottleneck (DSC) chain, as the
paper's system does (stem/head on the scalar core), at the stem-output
resolution. ``--block`` targets one of the paper's four benchmarked
bottleneck layers at its published feature-map size.

``--schedule`` takes any name from the compiler's schedule registry
(``repro_torch.cfu.SCHEDULES`` — the ``--help`` list is generated from it),
plus ``auto`` (the cost-model pass picks per block; the picks are
printed) and ``all`` (run every registered schedule). ``--streams N``
partitions the op chain across N CFU cores sharing the DRAM port: the
run prints per-core cycles, the steady-state frame interval, and the
DRAM-port contention, and verifies ``executor.run_multistream``
bit-exactly.

``--protect``, ``--fault`` and ``--doctor`` are not ported yet (ROADMAP.md
Queue 1 item 4): they exit with a message.

``--pe`` sets the engine counts baked into the stream's CFG_PE word
(default: the paper's 9,9,56). With ``--streams N``, ``--pe-per-core``
makes the frame pipeline heterogeneous: N semicolon-separated ``E,D,P``
triples (one per core, pipeline order) or ``auto-hetero`` (search a
small per-core allocation space under the homogeneous total engine
budget — big stem core, small tail core). ``--batch`` doubles as the
multi-stream frame-group size: each pipeline round drives a group of B
frames per core in lockstep, and the printed steady-state throughput
(frames/cycle) and energy/frame reflect it. ``--json`` writes the timing
reports to a file (``results/cfu/`` by convention, like launch.dryrun).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.cfu import isa
from repro_torch.cfu.compiler import (AUTO_HETERO, AUTO_SCHEDULE,
                                      MultiStreamProgram, compile_network,
                                      compile_vww_network, schedule_names)
from repro_torch.cfu.executor import run_multistream, run_program
from repro_torch.cfu.ir import SCHEDULES
from repro_torch.cfu.network import random_chain_params, vww_cfu_params
from repro_torch.cfu.report import PAPER_LAYERS, modeled_network_sw_cycles
from repro_torch.cfu.timing import (BatchCostModel, MultiStreamCostModel,
                                    PEConfig, analyze, analyze_multistream)
from repro_torch.cfu.trace import Tracer
from repro_torch.configs.vww import VWW
from repro_torch.core import dsc, quant
from repro_torch.core.fusion import Schedule, modeled_cycles, run_block

NOT_PORTED = ("{} is not ported yet: ROADMAP.md Queue 1 item 4 "
              "(cfu/serve, faults.py, doctor.py, ...)")


def _single_block(seed: int, name: str):
    layer = {n: (s, hw) for n, s, hw in PAPER_LAYERS}[name]
    spec, hw = layer
    rng = np.random.default_rng(seed)
    p32 = dsc.init_dsc_block_f32(rng, spec)
    calib = rng.standard_normal((hw, hw, spec.cin)).astype(np.float32)
    qp = dsc.quantize_dsc_block(p32, spec, calib)
    return [(name, spec)], [qp], hw


def _parse_pe(text) -> PEConfig:
    if text is None:
        return PEConfig()
    parts = [int(t) for t in text.split(",")]
    if len(parts) != 3:
        raise SystemExit("--pe wants exp_pes,dw_lanes,proj_engines")
    return PEConfig(*parts)


def _parse_pe_per_core(text, streams: int):
    """';'-separated E,D,P triples (one per core) or 'auto-hetero'."""
    if text is None:
        return None
    if streams <= 1:
        raise SystemExit("--pe-per-core needs --streams > 1")
    if text == AUTO_HETERO:
        return AUTO_HETERO
    return [_parse_pe(t) for t in text.split(";")]


def _dump_asm(prog, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        if isinstance(prog, MultiStreamProgram):
            for i, p in enumerate(prog.streams):
                f.write(f"; --- stream {i} ---\n")
                f.write(isa.program_to_asm(p))
        else:
            f.write(isa.program_to_asm(prog))
    print(f"# assembly ({len(prog)} instrs) -> {path}")


def _describe_schedule(prog):
    """Per-block picks (one line) — what the auto pass decided."""
    picks = prog.meta.get("block_schedules", {})
    return " ".join(f"{n}:{s}" for n, s in picks.items())


def _runner_for(prog, args, tracer=None):
    """Executor entry matching the compile, returning numpy.
    ``--backend golden`` (default) interprets the encoded words;
    ``--backend fast`` runs the fast path on ``--device`` (one lifted stage
    chain per program fingerprint: same outputs, no per-instruction
    timeline, hence no tracer). The multi-stream golden runner groups
    ``--batch`` frames per pipeline round (batching x pipelining)."""
    if getattr(args, "backend", "golden") == "fast":
        from repro_torch.cfu import fastpath

        def run_fast(p, x, params):
            return fastpath.run_fast(p, x, params,
                                     device=args.device).cpu().numpy()
        return run_fast
    if not isinstance(prog, MultiStreamProgram):
        def run1(p, x, params):
            return run_program(p, x, params, tracer=tracer)
        return run1

    def run(p, x, params):
        in_ndim = len(p.meta["in_shape"])
        n_frames = x.shape[0] if np.asarray(x).ndim > in_ndim else 1
        return run_multistream(p, x, params,
                               batch=max(1, min(args.batch, n_frames)),
                               tracer=tracer)
    return run


def _emit_model_trace(tracer, prog, args, batch: int):
    """Modeled per-phase timeline on pids 100+ (executor lanes sit at
    0..N-1), so one file diffs modeled vs executed side by side."""
    hsc = args.handoff_sync_cycles
    if isinstance(prog, MultiStreamProgram):
        MultiStreamCostModel(prog, args.pipeline, handoff_sync_cycles=hsc
                             ).emit_trace(tracer, batch, pid_base=100)
    else:
        tracer.process_name(100, "core0-model (cycle time)")
        BatchCostModel(prog, args.pipeline, handoff_sync_cycles=hsc
                       ).emit_trace(tracer, batch, pid=100)


def _report_of(prog, args):
    """Timing for either a single stream or a multi-stream compile."""
    if isinstance(prog, MultiStreamProgram):
        rep = analyze_multistream(prog, args.pipeline, batch=args.batch,
                                  handoff_sync_cycles=args.
                                  handoff_sync_cycles)
        if prog.meta["streams"] != prog.meta["streams_requested"]:
            print(f"#   NOTE: {prog.meta['streams_requested']} streams "
                  f"requested, only {prog.meta['streams']} schedulable "
                  f"units — compiled {prog.meta['streams']} cores")
        for i, (p, r) in enumerate(zip(prog.streams, rep.per_stream)):
            ops = ",".join(prog.meta["partition"][i])
            pe_i = prog.meta["pe_per_core"][i]
            print(f"#   stream {i}: {len(p)} instrs, "
                  f"pe=({pe_i.exp_pes},{pe_i.dw_lanes},{pe_i.proj_engines}),"
                  f" {r.total_cycles:.3e} cyc [{ops}]")
        print(f"#   steady-state interval {rep.interval_cycles:.3e} cyc "
              f"(batch {rep.batch}/round, handoff {rep.handoff_cycles:.0f}"
              f" cyc), DRAM-port contention "
              f"{rep.dram_contention_cycles:.3e} cyc, throughput "
              f"x{rep.throughput_speedup_vs_single:.2f} vs one core")
        print(f"#   frames/cycle {rep.frames_per_cycle:.3e}, energy/frame "
              f"{rep.energy_per_frame_pj / 1e6:.2f} uJ, pipeline fill "
              f"{rep.pipeline_fill_cycles:.3e} cyc")
        # per-frame steady-state cycles: comparable to the sw_v0 baseline
        # (and to batch=1) whatever the frame-group size
        cycles = rep.interval_cycles / rep.batch
        return rep, cycles
    rep = analyze(prog, args.pipeline,
                  handoff_sync_cycles=args.handoff_sync_cycles)
    return rep, rep.total_cycles


def _asdict(rep, prog=None):
    d = dataclasses.asdict(rep)
    if isinstance(prog, MultiStreamProgram):
        # actual core count (the partition has at most one unit per core,
        # so a large --streams may clamp), next to the request
        d["streams"] = prog.meta["streams"]
        d["streams_requested"] = prog.meta["streams_requested"]
        d["pe_per_core"] = [dataclasses.asdict(p)
                            for p in prog.meta["pe_per_core"]]
        d["hetero"] = prog.meta["hetero"]
        d["frames_per_cycle"] = rep.frames_per_cycle
        d["energy_per_frame_pj"] = rep.energy_per_frame_pj
    return d


def _run_vww(args, pe: PEConfig, schedules, tracer=None):
    """Full-network mode: compile, time, and batch-verify a VWW inference."""
    from repro_torch.models import mobilenetv2 as mnv2
    hw, batch = args.img_hw, args.batch
    # the CFU's weights live on the host; the fast path moves them per call
    net = mnv2.init_and_quantize(args.seed, img_hw=hw, head_ch=VWW.head_ch,
                                 n_classes=VWW.n_classes, device="cpu")
    specs = mnv2.block_specs()
    params = vww_cfu_params(net)
    sw_cycles = modeled_network_sw_cycles(
        specs, hw, img_ch=VWW.img_ch, head_ch=VWW.head_ch,
        n_classes=VWW.n_classes)

    print(f"# CFU simulation: full VWW inference ({hw}x{hw}x{VWW.img_ch}, "
          f"stem+{len(specs)} blocks+head+GAP+FC), batch={batch}, "
          f"pe=({pe.exp_pes},{pe.dw_lanes},{pe.proj_engines}), "
          f"pipeline={args.pipeline}, streams={args.streams}, "
          f"pe_per_core={args.pe_per_core}")
    print("schedule,n_instr,cycles,speedup_vs_sw_v0,dram_bytes,sram_bytes,"
          "sram_buffer_bytes,energy_uJ,verified_b1,verified_bN,exec_s")
    results = {"target": f"vww {hw}x{hw}", "pipeline": args.pipeline,
               "batch": batch, "pe": dataclasses.asdict(pe),
               "streams": args.streams,
               "sw_v0_cycles": sw_cycles, "schedules": {}}
    imgs_q = ref = None
    if not args.no_verify:
        # schedule-independent: quantize once, reference-infer once
        rng = np.random.default_rng(args.seed)
        imgs = rng.standard_normal(
            (batch, hw, hw, VWW.img_ch)).astype(np.float32)
        imgs_q = quant.quantize(imgs, net.qp_img).numpy()
        ref = mnv2.forward_batch(imgs, net.to(args.device),
                                 return_quantized=True).cpu().numpy()
    for sched in schedules:
        prog = compile_vww_network(specs, hw, sched, img_ch=VWW.img_ch,
                                   head_ch=VWW.head_ch,
                                   n_classes=VWW.n_classes, pe=pe,
                                   streams=args.streams,
                                   pe_per_core=_parse_pe_per_core(
                                       args.pe_per_core, args.streams),
                                   pipeline=args.pipeline)
        if sched == AUTO_SCHEDULE:
            print(f"# auto picks: {_describe_schedule(prog)}")
        if args.asm:
            _dump_asm(prog, args.asm)
        rep, cycles = _report_of(prog, args)
        if tracer is not None:
            _emit_model_trace(tracer, prog, args, batch)
        runner = _runner_for(prog, args)
        v1 = vn = "-"
        exec_s = 0.0
        if not args.no_verify:
            t0 = time.time()
            y1 = runner(prog, imgs_q[0], params)
            # trace only the batched run (one executor timeline per pid)
            yb = _runner_for(prog, args, tracer=tracer)(
                prog, imgs_q, params)
            exec_s = time.time() - t0
            v1 = bool(np.array_equal(y1, ref[0]))
            vn = bool(np.array_equal(yb, ref))
            if not (v1 and vn):
                raise SystemExit(
                    f"BIT-EXACTNESS FAILURE under {sched} "
                    f"(batch1={v1}, batch{batch}={vn})")
        label = sched if isinstance(sched, str) else sched.value
        dram, sram = rep.dram_bytes, rep.sram_bytes
        # MultiStreamReport has no sram_buffer_bytes (scratch is per-core)
        sbuf = getattr(rep, "sram_buffer_bytes",
                       prog.meta["layout"].sram_size)
        print(f"{label},{len(prog)},{cycles:.3e},"
              f"{sw_cycles / cycles:.1f},{dram},{sram},{sbuf},"
              f"{rep.energy_pj['total'] / 1e6:.2f},{v1},{vn},{exec_s:.2f}")
        results["schedules"][label] = _asdict(rep, prog)
    return results


def _run_chain(args, pe: PEConfig, schedules, tracer=None):
    """DSC-chain / single-block modes (the paper's CFU partitioning)."""
    if args.block:
        specs, params, hw = _single_block(args.seed, args.block)
        target = f"block {args.block} ({hw}x{hw})"
    else:
        from repro_torch.models import mobilenetv2
        hw = args.hw
        specs = mobilenetv2.block_specs()
        params = random_chain_params(args.seed, specs, hw)
        target = f"mobilenetv2 DSC chain ({hw}x{hw} stem output)"

    # v0 software baseline over the same chain (calibrated cycle model)
    h = w = hw
    sw_cycles = 0.0
    for _, spec in specs:
        sw_cycles += modeled_cycles(spec, h, w, Schedule.V0_LAYER_BY_LAYER)
        h, w = spec.out_hw(h, w)

    print(f"# CFU simulation: {target}, schedules={schedules}, "
          f"pipeline={args.pipeline}, streams={args.streams}")
    print("schedule,n_instr,cycles,speedup_vs_sw_v0,dram_bytes,sram_bytes,"
          "sram_buffer_bytes,energy_uJ,verified,exec_s")
    results = {"target": target, "pipeline": args.pipeline,
               "pe": dataclasses.asdict(pe), "streams": args.streams,
               "sw_v0_cycles": sw_cycles, "schedules": {}}
    for sched in schedules:
        prog = compile_network(specs, hw, hw, sched, pe=pe,
                               streams=args.streams,
                               pe_per_core=_parse_pe_per_core(
                                   args.pe_per_core, args.streams),
                               pipeline=args.pipeline)
        if sched == AUTO_SCHEDULE:
            print(f"# auto picks: {_describe_schedule(prog)}")
        if args.asm:
            _dump_asm(prog, args.asm)
        rep, cycles = _report_of(prog, args)
        if tracer is not None:
            _emit_model_trace(tracer, prog, args, 1)
        runner = _runner_for(prog, args, tracer=tracer)
        verified, exec_s = "-", 0.0
        if not args.no_verify:
            rng = np.random.default_rng(args.seed)
            x_f = rng.standard_normal(
                (hw, hw, specs[0][1].cin)).astype(np.float32)
            x_q = quant.quantize(x_f, params[0].qp_in).numpy()
            t0 = time.time()
            y = runner(prog, x_q, params)
            exec_s = time.time() - t0
            ref = torch.from_numpy(x_q).to(args.device)
            for qp in params:
                ref = run_block(ref, qp.to(args.device),
                                Schedule.V0_LAYER_BY_LAYER)
            verified = bool(np.array_equal(y, ref.cpu().numpy()))
            if not verified:
                raise SystemExit(f"BIT-EXACTNESS FAILURE under {sched}")
        dram, sram = rep.dram_bytes, rep.sram_bytes
        # MultiStreamReport has no sram_buffer_bytes (scratch is per-core)
        sbuf = getattr(rep, "sram_buffer_bytes",
                       prog.meta["layout"].sram_size)
        print(f"{sched},{len(prog)},{cycles:.3e},"
              f"{sw_cycles / cycles:.1f},{dram},{sram},{sbuf},"
              f"{rep.energy_pj['total'] / 1e6:.2f},{verified},{exec_s:.2f}")
        results["schedules"][sched] = _asdict(rep, prog)
    return results


def main(argv=None):
    schedule_help = "; ".join(f"{name}: {desc}"
                              for name, (_, desc) in SCHEDULES.items())
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    tgt = ap.add_mutually_exclusive_group()
    tgt.add_argument("--network", choices=["vww"], default=None,
                     help="full inference: stem + blocks + head + GAP + FC")
    tgt.add_argument("--net", choices=["mobilenetv2"], default=None,
                     help="DSC bottleneck chain only (paper partitioning)")
    tgt.add_argument("--block", choices=[n for n, _, _ in PAPER_LAYERS])
    ap.add_argument("--schedule", default="fused",
                    choices=schedule_names(include_auto=True) + ["all"],
                    help=f"schedule registry: {schedule_help}; "
                         "auto = cost-model pick per block; "
                         "all = every registered schedule")
    ap.add_argument("--pipeline", default="v3", choices=["v1", "v2", "v3"])
    ap.add_argument("--streams", type=int, default=1,
                    help="partition the op chain across N CFU cores "
                         "sharing the DRAM port")
    ap.add_argument("--pe-per-core", default=None,
                    metavar="E,D,P;E,D,P|auto-hetero",
                    help="per-core engine counts for --streams N "
                         "(semicolon-separated triples in pipeline order) "
                         "or 'auto-hetero' (search allocations under the "
                         "homogeneous total budget)")
    ap.add_argument("--hw", type=int, default=40,
                    help="input feature-map size for --net (stem output)")
    ap.add_argument("--img-hw", type=int, default=VWW.img_hw,
                    help="image size for --network vww")
    ap.add_argument("--batch", type=int, default=VWW.batch,
                    help="batched-executor image count for --network vww")
    ap.add_argument("--pe", default=None, metavar="E,D,P",
                    help="engine counts exp_pes,dw_lanes,proj_engines "
                         "(default 9,9,56 — the paper's arrays)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="golden",
                    choices=["golden", "fast"],
                    help="verify executor: the word interpreter (golden) "
                         "or the fast path lifted once per program "
                         "fingerprint (fast; same bit-exact outputs)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the fast path and the reference forward "
                         "run; cuda raises without a card")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the bit-exact golden-model execution")
    ap.add_argument("--protect", action="store_true",
                    help="not ported yet (ROADMAP.md Queue 1 item 4)")
    ap.add_argument("--fault", default=None,
                    choices=["weights", "instr", "sram", "dram"],
                    help="not ported yet (ROADMAP.md Queue 1 item 4)")
    ap.add_argument("--doctor", action="store_true",
                    help="not ported yet (ROADMAP.md Queue 1 item 4)")
    ap.add_argument("--asm", default=None,
                    help="dump the text assembly of the stream to this path")
    ap.add_argument("--json", default=None,
                    help="write timing reports as JSON to this path")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Perfetto-loadable Chrome trace: modeled "
                         "per-phase timeline (pids 100+, cycle time) plus "
                         "the golden executor's timeline (pids 0..N-1, "
                         "retired-instruction time); single schedule only")
    ap.add_argument("--handoff-sync-cycles", type=float, default=None,
                    help="per-boundary double-buffer handoff cost for the "
                         "multi-core pipeline (default: timing."
                         "HANDOFF_SYNC_CYCLES = 64)")
    args = ap.parse_args(argv)

    for flag in ("protect", "fault", "doctor"):
        if getattr(args, flag):
            raise SystemExit(NOT_PORTED.format(f"--{flag}"))
    resolve_device(args.device)

    pe = _parse_pe(args.pe)
    schedules = (schedule_names() if args.schedule == "all"
                 else [args.schedule])
    tracer = None
    if args.trace:
        if len(schedules) > 1:
            raise SystemExit("--trace wants a single --schedule "
                             "(one timeline per pid)")
        if args.backend == "fast":
            raise SystemExit("--trace needs --backend golden (the fast "
                             "path has no per-instruction timeline)")
        tracer = Tracer(clock="cycles (model) / instrs (exec)")

    if args.network:
        results = _run_vww(args, pe, schedules, tracer=tracer)
    else:
        results = _run_chain(args, pe, schedules, tracer=tracer)

    if tracer is not None:
        tracer.save(args.trace)
        print(f"# trace ({len(tracer.events)} events) -> {args.trace} "
              f"(open at https://ui.perfetto.dev)")

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
        print(f"# wrote {args.json}")


if __name__ == "__main__":
    main()
