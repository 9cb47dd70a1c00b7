"""Capacity planning: max sustainable QPS under a latency SLO.

``max_sustainable_qps`` answers the deployment question for ONE device
config + policy: the highest Poisson arrival rate at which the simulated
p99 latency still meets the SLO (and the queue drains), found by
geometric bisection between a near-zero load and the device's saturated
service ceiling. Every probe is a full seeded simulation, so queueing
and batching-wait effects are in the number — not just the service-time
ceiling.

``plan_capacity`` sweeps it over a grid: arrival process x policy x
device config (streams, per-core PE allocation, batch cap), emitting one
JSON-able row per cell plus a p99-vs-rate curve for the winning cell —
the figure a serving paper plots. ``build_vww_service`` compiles the
device configs (timing needs no weights, so planning never touches
params; the differential anchoring lives in the simulator's spot
checks).

Determinism: per-probe seeds are derived with ``zlib.crc32`` over the
config labels (stable across processes, unlike ``hash``), so a planner
run is exactly reproducible from its base seed.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Sequence

from repro_torch.cfu.serve.arrivals import DEFAULT_FREQ_HZ, make_arrivals
from repro_torch.cfu.serve.dispatcher import ServingSimulator
from repro_torch.cfu.serve.policies import make_policy
from repro_torch.cfu.serve.service import ServiceModel

DEFAULT_SLO_MS = 30.0           # the serving gate's SLO: 30 ms @ 300 MHz
DEFAULT_N_REQUESTS = 400
_MAX_WIDENINGS = 6              # bracket cap: up to 2^6 x the 1.05-ceiling


def derive_seed(base: int, *labels) -> int:
    """Stable sub-seed from a base seed + string-able labels."""
    text = ":".join(str(x) for x in (base,) + labels)
    return zlib.crc32(text.encode()) & 0x7FFFFFFF


def rate_label(rate: float) -> str:
    """Collision-free seed label for a probe rate: the full float bits.

    The old ``f"{rate:.6f}"`` label collapsed any two probes agreeing to
    six decimals (tight ``tol`` + high ceilings get there) onto ONE seed,
    silently correlating their verdicts; ``float.hex()`` is exact, so
    distinct rates always draw independent arrival streams.
    """
    return float(rate).hex()


def build_vww_service(img_hw: int, streams: int = 1,
                      pe=None, pe_per_core=None,
                      schedule: str = "fused", pipeline: str = "v3",
                      freq_hz: float = DEFAULT_FREQ_HZ,
                      max_batch: int = 16,
                      sram_port_bytes: Optional[int] = None,
                      handoff_sync_cycles: Optional[float] = None,
                      ) -> ServiceModel:
    """Compile a full-VWW device config into a :class:`ServiceModel`."""
    from repro_torch.cfu.compiler import compile_vww_network
    from repro_torch.configs.vww import VWW
    from repro_torch.models.mobilenetv2 import block_specs
    prog = compile_vww_network(block_specs(), img_hw, schedule,
                               img_ch=VWW.img_ch, head_ch=VWW.head_ch,
                               n_classes=VWW.n_classes, pe=pe,
                               streams=streams, pe_per_core=pe_per_core,
                               pipeline=pipeline)
    return ServiceModel(prog, pipeline, freq_hz=freq_hz,
                        max_batch=max_batch,
                        sram_port_bytes=sram_port_bytes,
                        handoff_sync_cycles=handoff_sync_cycles)


def simulate(service: ServiceModel, policy_name: str, rate_qps: float,
             n_requests: int = DEFAULT_N_REQUESTS, seed: int = 0,
             arrival_kind: str = "poisson",
             trace_path: Optional[str] = None,
             slo_cycles: Optional[float] = None,
             batch_cap: Optional[int] = None,
             timeout_cycles: Optional[float] = None,
             spot_check=None, tracer=None,
             rescale_to_rate: bool = False,
             dropout=None, slo_target: float = 0.99):
    """One seeded simulation at a fixed rate (the planner's probe).

    ``tracer`` (a ``repro_torch.cfu.trace.Tracer``) records the request-level
    timeline — queue depth, batch spans, SLO instants — without touching
    any simulated number. ``rescale_to_rate`` makes trace replays honour
    ``rate_qps`` (see ``arrivals.trace``); ``dropout`` (a
    ``dispatcher.DropoutEvent``) kills a core mid-run, degrading the
    device and replaying in-flight requests — run the same probe with
    and without it and diff the p99 to price the failover.
    """
    policy = make_policy(policy_name, service=service,
                         batch_cap=batch_cap,
                         timeout_cycles=timeout_cycles,
                         slo_cycles=slo_cycles)
    arrivals = make_arrivals(arrival_kind, rate_qps, n_requests,
                             freq_hz=service.freq_hz, seed=seed,
                             trace_path=trace_path,
                             rescale_to_rate=rescale_to_rate)
    sim = ServingSimulator(service, policy, arrivals,
                           spot_check=spot_check, tracer=tracer,
                           slo_cycles=slo_cycles, slo_target=slo_target,
                           dropout=dropout)
    res = sim.run()
    res.summary["rate_qps"] = rate_qps
    res.summary["arrival_kind"] = arrival_kind
    res.summary["seed"] = seed
    return res


def _feasible(summary: Dict[str, object], slo_cycles: float) -> bool:
    return bool(summary.get("drained")) and \
        summary.get("latency_p99_cycles", float("inf")) <= slo_cycles


def max_sustainable_qps(service: ServiceModel, policy_name: str,
                        slo_cycles: float,
                        n_requests: int = DEFAULT_N_REQUESTS,
                        seed: int = 0, tol: float = 0.02,
                        arrival_kind: str = "poisson",
                        batch_cap: Optional[int] = None,
                        timeout_cycles: Optional[float] = None,
                        ) -> Dict[str, object]:
    """Geometric bisection for the highest SLO-feasible arrival rate.

    The bracket starts at [2% , 105%] of the device's saturated service
    ceiling (the best fixed-batch rate the policy's cap allows); each
    probe is one full simulation. Returns the frontier row: the max rate,
    the summary AT that rate, and the probe ladder for inspection.
    """
    if arrival_kind == "trace":
        raise ValueError("rate bisection over a fixed trace is "
                         "meaningless — replay the trace with simulate()")
    # the ceiling must price batches the policy can actually dispatch:
    # read the cap off a throwaway policy so defaults stay in one place
    cap = make_policy(policy_name, service=service,
                      batch_cap=batch_cap,
                      slo_cycles=slo_cycles).batch_cap
    ceiling = max(service.service_rate_qps(b)
                  for b in range(1, min(cap, service.max_batch) + 1))

    def probe(rate: float):
        s = derive_seed(seed, policy_name, rate_label(rate))
        return simulate(service, policy_name, rate,
                        n_requests=n_requests, seed=s,
                        arrival_kind=arrival_kind,
                        slo_cycles=slo_cycles, batch_cap=batch_cap,
                        timeout_cycles=timeout_cycles).summary

    lo, hi = 0.02 * ceiling, 1.05 * ceiling
    best_summary = probe(lo)
    if not _feasible(best_summary, slo_cycles):
        return {"policy": policy_name, "max_qps": 0.0,
                "service_ceiling_qps": ceiling, "at_max": best_summary,
                "probes": [{"rate_qps": lo, "feasible": False}]}
    probes = [{"rate_qps": lo, "feasible": True}]
    lo_qps = lo
    # Probe the upper endpoint instead of assuming it infeasible: the
    # ceiling is a FIXED-batch estimate, and a policy with adaptive
    # windows can beat it — clamping the answer below the truth. While
    # ``hi`` stays feasible, widen the bracket geometrically (bounded, so
    # a pathological always-feasible model still terminates).
    s_hi = probe(hi)
    hi_ok = _feasible(s_hi, slo_cycles)
    probes.append({"rate_qps": hi, "feasible": hi_ok,
                   "p99_ms": s_hi.get("latency_p99_ms")})
    for _ in range(_MAX_WIDENINGS):
        if not hi_ok:
            break
        lo_qps, best_summary = hi, s_hi
        hi *= 2.0
        s_hi = probe(hi)
        hi_ok = _feasible(s_hi, slo_cycles)
        probes.append({"rate_qps": hi, "feasible": hi_ok,
                       "p99_ms": s_hi.get("latency_p99_ms")})
    if hi_ok:                 # feasible even after every widening
        return {"policy": policy_name, "max_qps": hi,
                "service_ceiling_qps": ceiling, "slo_cycles": slo_cycles,
                "bracket_exhausted": True,
                "at_max": s_hi, "probes": probes}
    while hi / lo_qps > 1 + tol:
        mid = (lo_qps * hi) ** 0.5
        s = probe(mid)
        ok = _feasible(s, slo_cycles)
        probes.append({"rate_qps": mid, "feasible": ok,
                       "p99_ms": s.get("latency_p99_ms")})
        if ok:
            lo_qps, best_summary = mid, s
        else:
            hi = mid
    return {"policy": policy_name, "max_qps": lo_qps,
            "service_ceiling_qps": ceiling,
            "slo_cycles": slo_cycles,
            "at_max": best_summary, "probes": probes}


def p99_curve(service: ServiceModel, policy_name: str,
              rates: Sequence[float], slo_cycles: float,
              n_requests: int = DEFAULT_N_REQUESTS, seed: int = 0,
              batch_cap: Optional[int] = None,
              timeout_cycles: Optional[float] = None,
              ) -> List[Dict[str, object]]:
    """p99 (and mean batch / energy) vs offered rate — the report figure."""
    rows = []
    for rate in rates:
        s = simulate(service, policy_name, rate, n_requests=n_requests,
                     seed=derive_seed(seed, "curve", policy_name,
                                      rate_label(rate)),
                     slo_cycles=slo_cycles, batch_cap=batch_cap,
                     timeout_cycles=timeout_cycles).summary
        rows.append({
            "rate_qps": rate,
            "p50_ms": s.get("latency_p50_ms"),
            "p99_ms": s.get("latency_p99_ms"),
            "throughput_qps": s.get("throughput_qps"),
            "mean_batch": s.get("mean_batch"),
            "energy_per_frame_uj": s.get("energy_per_frame_uj"),
            "drained": s.get("drained"),
        })
    return rows


def plan_capacity(devices: Dict[str, ServiceModel],
                  policies: Sequence[Dict[str, object]],
                  slo_cycles: float,
                  n_requests: int = DEFAULT_N_REQUESTS,
                  seed: int = 0,
                  curve_points: int = 6) -> Dict[str, object]:
    """The full sweep: device config x policy -> max sustainable QPS.

    ``policies`` rows are ``{"name": ..., "batch_cap": ..,
    "timeout_cycles": ..}`` dicts (missing keys = policy defaults). The
    result carries one frontier row per cell, the winning cell, and a
    p99-vs-rate curve for the winner's device under every policy (the
    comparison figure).
    """
    cells = []
    for dev_label, service in devices.items():
        for spec in policies:
            row = max_sustainable_qps(
                service, spec["name"], slo_cycles,
                n_requests=n_requests,
                seed=derive_seed(seed, dev_label, spec["name"]),
                batch_cap=spec.get("batch_cap"),
                timeout_cycles=spec.get("timeout_cycles"))
            row["device"] = dev_label
            row["device_info"] = service.describe()
            cells.append(row)
    best = max(cells, key=lambda r: r["max_qps"])
    curves = {}
    if best["max_qps"] > 0:      # nothing is SLO-feasible: no curve to plot
        win_dev = devices[best["device"]]
        top = 1.1 * max(r["max_qps"] for r in cells
                        if r["device"] == best["device"])
        rates = [top * (i + 1) / (curve_points + 1)
                 for i in range(curve_points)]
        for spec in policies:
            curves[spec["name"]] = p99_curve(
                win_dev, spec["name"], rates, slo_cycles,
                n_requests=n_requests,
                seed=derive_seed(seed, "curve", best["device"]),
                batch_cap=spec.get("batch_cap"),
                timeout_cycles=spec.get("timeout_cycles"))
    return {"slo_cycles": slo_cycles, "n_requests": n_requests,
            "cells": cells,
            "best": {"device": best["device"],
                     "policy": best["policy"],
                     "max_qps": best["max_qps"]},
            "p99_curves_device": best["device"],
            "p99_curves": curves}
