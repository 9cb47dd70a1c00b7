"""Request-level CFU serving simulation: arrivals, batching, SLOs.

    python -m repro_torch.launch.serve_cfu --rate 150 --policy timeout \
        --streams 2 --pe-per-core auto-hetero
    python -m repro_torch.launch.serve_cfu --rate 200 --policy adaptive \
        --arrivals bursty --requests 500
    python -m repro_torch.launch.serve_cfu --plan --streams 2 \
        --pe-per-core auto-hetero --slo-ms 30
    python -m repro_torch.launch.serve_cfu --rate 200 --streams 2 \
        --dropout-at-ms 50 --repartition-ms 1    # core dies mid-run
    python -m repro_torch.launch.serve_cfu --img-hw 80 --backend fast \
        --spot-checks 4                         # checks on the card
    python -m repro_torch.launch.serve_cfu --device cpu --spot-checks 0

Port of ``repro.launch.serve_cfu``. The simulator is host code; only the
spot checks touch ``--device`` (default ``cuda``, resolved at start: it
raises without a card unless ``--device cpu`` is given, also under
``--plan`` and ``--spot-checks 0``). There the fast path and the checks'
reference inference launch the hand-written DSC kernel. Weights come from
a numpy generator seeded with ``--seed``, so the spot checks' outputs
differ from the reference CLI's; the simulator's summary does not. Every
cycle, QPS and latency printed is the simulated CFU's at ``--freq-mhz``,
not the card's.

Where ``repro_torch.launch.cfu`` executes and times single frames or lockstep
batches, this launcher runs the REQUEST level above it (``cfu.serve``):
a seeded discrete-event simulation of requests arriving at ``--rate``
QPS against the compiled VWW network serving on 1..N CFU cores, with a
dynamic-batching policy (``immediate`` / ``timeout`` / ``adaptive``)
deciding how arrivals group into dispatched frame batches. Each
dispatched batch is priced by the calibrated cost model
(``timing.analyze`` / ``analyze_multistream``) at its actual size; the
run reports p50/p95/p99 latency, throughput, per-core utilization,
queue depths and energy/frame.

Honesty: unless ``--spot-checks 0``, sampled dispatched batches are ALSO
executed mid-simulation and compared bit-exactly against
``models.mobilenetv2.forward_batch`` (plus a frame-accounting
cross-check executor-vs-model); a divergence aborts the run.
``--backend fast`` runs those checks through the fast path on
``--device`` (milliseconds per check instead of a second, so
million-request runs can afford many), with every 4th sampled batch
still re-executed by the word interpreter and asserted fast == golden.

``--plan`` runs the capacity planner instead of a single rate: for every
policy it searches the max sustainable QPS under ``--slo-ms`` (at
``--freq-mhz``) by bisection of full simulations, and prints the
frontier plus a p99-vs-rate curve. ``--json`` writes either payload for
downstream tooling.
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch import resolve_device
from repro_torch.cfu.serve.arrivals import ARRIVALS
from repro_torch.cfu.serve.check import DifferentialSpotCheck
from repro_torch.cfu.serve.planner import (DEFAULT_SLO_MS, build_vww_service,
                                     plan_capacity, simulate)
from repro_torch.cfu.serve.policies import POLICIES
from repro_torch.cfu.serve.report import (curve_table, doctor_lines,
                                    frontier_table, summary_lines)
from repro_torch.configs.vww import VWW


def _parse_pe(text):
    from repro_torch.cfu.timing import PEConfig
    if text is None:
        return None
    parts = [int(t) for t in text.split(",")]
    if len(parts) != 3:
        raise SystemExit("--pe wants exp_pes,dw_lanes,proj_engines")
    return PEConfig(*parts)


def _parse_pe_per_core(text, streams: int):
    from repro_torch.cfu.compiler import AUTO_HETERO
    if text is None:
        return None
    if streams <= 1:
        raise SystemExit("--pe-per-core needs --streams > 1")
    if text == AUTO_HETERO:
        return AUTO_HETERO
    return [_parse_pe(t) for t in text.split(";")]


def _spot_checker(args, service, device):
    """Build the golden-executor anchor (needs the quantized net): the
    CFU parameters on the host, the network on ``device``."""
    from repro_torch.cfu.network import vww_cfu_params
    from repro_torch.models import mobilenetv2 as mnv2
    print(f"# quantizing the {args.img_hw}x{args.img_hw} VWW network for "
          f"differential spot checks on {device} (--spot-checks 0 skips)")
    net = mnv2.init_and_quantize(args.seed, img_hw=args.img_hw,
                                 head_ch=VWW.head_ch,
                                 n_classes=VWW.n_classes, device="cpu")
    params = vww_cfu_params(net)
    return DifferentialSpotCheck.for_vww(
        service.prog, net.to(device), params, img_hw=args.img_hw,
        img_ch=VWW.img_ch, max_checks=args.spot_checks, seed=args.seed,
        backend=args.backend)


def main(argv=None):
    policy_help = "; ".join(f"{n}: {d}" for n, d in POLICIES.items())
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--rate", type=float, default=100.0,
                    help="offered load, requests/second")
    ap.add_argument("--policy", default="timeout",
                    choices=sorted(POLICIES),
                    help=f"batching policy — {policy_help}")
    ap.add_argument("--batch-cap", type=int, default=None,
                    help="max frames per dispatched batch "
                         "(default: policy-specific)")
    ap.add_argument("--timeout-ms", type=float, default=2.0,
                    help="batching timeout for --policy timeout")
    ap.add_argument("--arrivals", default="poisson", choices=ARRIVALS)
    ap.add_argument("--arrival-trace", default=None,
                    help="JSON arrival-trace path for --arrivals trace")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Perfetto-loadable Chrome trace of the "
                         "run: device model timeline (pids 100+), queue "
                         "depth, per-batch dispatch spans and SLO-"
                         "violation instants (pid 1000); simulate mode "
                         "only")
    ap.add_argument("--requests", type=int, default=400,
                    help="number of requests to simulate")
    ap.add_argument("--slo-ms", type=float, default=DEFAULT_SLO_MS,
                    help="latency SLO (drives adaptive policy + --plan)")
    ap.add_argument("--slo-target", type=float, default=0.99,
                    help="availability target behind the SLO: the burn "
                         "rate divides the violation fraction by the "
                         "error budget 1-target")
    ap.add_argument("--doctor", action="store_true",
                    help="print the serving perf-doctor view: per-request "
                         "latency decomposition (queue wait / batch "
                         "formation / dropout replay / service / pipeline "
                         "fill; bit-exact per request) and SLO burn "
                         "rates; simulate mode only")
    ap.add_argument("--freq-mhz", type=float, default=300.0,
                    help="CFU clock (the paper's 300 MHz)")
    ap.add_argument("--img-hw", type=int, default=24,
                    help="VWW input resolution of the served network "
                         "(24 keeps spot-check execution snappy; the "
                         "deployment size is 80)")
    ap.add_argument("--schedule", default="fused")
    ap.add_argument("--pipeline", default="v3", choices=["v1", "v2", "v3"])
    ap.add_argument("--streams", type=int, default=1,
                    help="CFU cores (frame pipeline) serving the network")
    ap.add_argument("--pe", default=None, metavar="E,D,P",
                    help="engine counts (default: the paper's 9,9,56)")
    ap.add_argument("--pe-per-core", default=None,
                    metavar="E,D,P;...|auto-hetero",
                    help="per-core engine counts for --streams N")
    ap.add_argument("--sram-port-bytes", type=int, default=None,
                    help="on-chip scratch port width (default 1 B/cycle)")
    ap.add_argument("--handoff-sync-cycles", type=float, default=None,
                    help="per-boundary double-buffer handoff cost "
                         "(default: timing.HANDOFF_SYNC_CYCLES = 64)")
    ap.add_argument("--spot-checks", type=int, default=2,
                    help="max dispatched batches to execute bit-exactly "
                         "through the golden executor (0 = skip)")
    ap.add_argument("--backend", default="golden",
                    choices=["golden", "fast"],
                    help="spot-check executor: the word interpreter "
                         "(golden) or the fast path on --device, which "
                         "still cross-checks every 4th sampled batch "
                         "against the interpreter — 'fast' makes "
                         "million-request runs affordable")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the spot checks' fast path and reference "
                         "inference run; cuda raises without a card")
    ap.add_argument("--plan", action="store_true",
                    help="capacity planning: per-policy max sustainable "
                         "QPS under --slo-ms instead of one --rate run")
    ap.add_argument("--dropout-at-ms", type=float, default=None,
                    help="kill one core at this simulated time: the run "
                         "degrades to streams-1 cores, replays in-flight "
                         "requests, and reports the p99 delta vs the "
                         "same run without the dropout (needs "
                         "--streams >= 2; simulate mode only)")
    ap.add_argument("--dropout-core", type=int, default=None,
                    help="which core dies at --dropout-at-ms "
                         "(default: the last)")
    ap.add_argument("--repartition-ms", type=float, default=0.0,
                    help="failover dead time before the degraded device "
                         "accepts work (checkpoint restore + repartition)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None,
                    help="write the result payload to this path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    freq_hz = args.freq_mhz * 1e6
    slo_cycles = args.slo_ms * 1e-3 * freq_hz
    service = build_vww_service(
        args.img_hw, streams=args.streams, pe=_parse_pe(args.pe),
        pe_per_core=_parse_pe_per_core(args.pe_per_core, args.streams),
        schedule=args.schedule, pipeline=args.pipeline, freq_hz=freq_hz,
        sram_port_bytes=args.sram_port_bytes,
        handoff_sync_cycles=args.handoff_sync_cycles)
    dev = service.describe()
    print(f"# CFU serving simulator: VWW {args.img_hw}x{args.img_hw}, "
          f"{service.n_stages} core(s)"
          + (" (hetero)" if dev.get("hetero") else "")
          + f", schedule={args.schedule}, pipeline={args.pipeline}, "
          f"SLO {args.slo_ms} ms @ {args.freq_mhz:.0f} MHz")

    if args.plan:
        policy_grid = [
            {"name": name, "batch_cap": args.batch_cap,
             "timeout_cycles": args.timeout_ms * 1e-3 * freq_hz}
            for name in sorted(POLICIES)]
        plan = plan_capacity({"device": service}, policy_grid,
                             slo_cycles, n_requests=args.requests,
                             seed=args.seed, curve_points=4)
        payload = {"mode": "plan", "slo_ms": args.slo_ms,
                   "device": dev, **plan}
        print("\n".join(frontier_table(plan)))
        if plan["p99_curves"]:
            print("\n".join(curve_table(plan)))
        else:
            print("# no policy is SLO-feasible on this device — "
                  "no p99 curve to plot")
    else:
        spot = (_spot_checker(args, service, device)
                if args.spot_checks > 0 else None)
        tracer = None
        if args.trace:
            from repro_torch.cfu.trace import Tracer
            tracer = Tracer(clock="cycles")
            # reference lane: the device's modeled per-phase timeline for
            # one max-batch frame group, next to the request-level lanes
            service.emit_model_trace(tracer, service.max_batch,
                                     pid_base=100)
        dropout = None
        if args.dropout_at_ms is not None:
            if args.streams < 2:
                raise SystemExit("--dropout-at-ms needs --streams >= 2 "
                                 "(a 1-core device has no survivors)")
            from repro_torch.cfu.serve.dispatcher import DropoutEvent
            degraded = build_vww_service(
                args.img_hw, streams=args.streams - 1,
                pe=_parse_pe(args.pe),
                pe_per_core=_parse_pe_per_core(
                    args.pe_per_core, args.streams - 1)
                if args.streams - 1 > 1 else None,
                schedule=args.schedule, pipeline=args.pipeline,
                freq_hz=freq_hz, sram_port_bytes=args.sram_port_bytes,
                handoff_sync_cycles=args.handoff_sync_cycles)
            dropout = DropoutEvent(
                at_cycles=args.dropout_at_ms * 1e-3 * freq_hz,
                degraded=degraded,
                core=(args.dropout_core if args.dropout_core is not None
                      else args.streams - 1),
                repartition_cycles=args.repartition_ms * 1e-3 * freq_hz)
        res = simulate(service, args.policy, args.rate,
                       n_requests=args.requests, seed=args.seed,
                       arrival_kind=args.arrivals,
                       trace_path=args.arrival_trace,
                       slo_cycles=slo_cycles,
                       slo_target=args.slo_target,
                       batch_cap=args.batch_cap,
                       timeout_cycles=args.timeout_ms * 1e-3 * freq_hz,
                       spot_check=spot, tracer=tracer, dropout=dropout)
        if tracer is not None:
            tracer.save(args.trace)
            print(f"# trace ({len(tracer.events)} events) -> {args.trace}"
                  f" (open at https://ui.perfetto.dev)")
        print("\n".join(summary_lines(res.summary)))
        if args.doctor:
            print("\n".join(doctor_lines(res.summary)))
        if dropout is not None:
            # the failover price: same seed, same arrivals, no dropout
            base = simulate(service, args.policy, args.rate,
                            n_requests=args.requests, seed=args.seed,
                            arrival_kind=args.arrivals,
                            trace_path=args.arrival_trace,
                            slo_cycles=slo_cycles,
                            batch_cap=args.batch_cap,
                            timeout_cycles=args.timeout_ms * 1e-3
                            * freq_hz)
            d99 = (res.summary.get("latency_p99_ms", float("nan"))
                   - base.summary.get("latency_p99_ms", float("nan")))
            print(f"# dropout at {args.dropout_at_ms} ms: "
                  f"{res.summary.get('n_replayed', 0)} request(s) "
                  f"replayed, p99 {base.summary.get('latency_p99_ms', 0):.2f}"
                  f" -> {res.summary.get('latency_p99_ms', 0):.2f} ms "
                  f"(delta {d99:+.2f} ms)")
            res.summary["p99_delta_ms_vs_no_dropout"] = d99
        slo_ok = res.summary.get("latency_p99_cycles",
                                 float("inf")) <= slo_cycles
        print(f"# SLO {args.slo_ms} ms p99: "
              f"{'MET' if slo_ok else 'MISSED'}")
        payload = {"mode": "simulate", "slo_ms": args.slo_ms,
                   **res.summary}

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2, default=str)
        print(f"# wrote {args.json}")
    return payload


if __name__ == "__main__":
    main()
