"""Render serving-simulation and capacity-planner JSON as tables.

Pure formatting — everything here takes the dict payloads produced by
``dispatcher.SimResult.summary`` / ``planner.plan_capacity`` (the same
payloads the ``--json`` flags write) and returns lines, so the CLI, the
benchmark and the README all print the same tables.
"""

from __future__ import annotations

from typing import Dict, List


def _fmt(x, spec=".3g") -> str:
    return "-" if x is None else format(x, spec)


def summary_lines(s: Dict[str, object]) -> List[str]:
    """One simulation run -> human-readable report lines."""
    out = []
    pol = s.get("policy", {})
    dev = s.get("device", {})
    out.append(
        f"# policy={pol.get('policy')} cap={pol.get('batch_cap', '-')} "
        f"device: {dev.get('n_stages')} core(s) @ "
        f"{_fmt(dev.get('freq_mhz'), '.0f')} MHz"
        + (" (hetero)" if dev.get("hetero") else ""))
    out.append(
        f"served {s.get('n_served')}/{s.get('n_arrivals')} requests "
        f"in {_fmt(s.get('horizon_s'))} s "
        f"({_fmt(s.get('throughput_qps'))} QPS), "
        f"{s.get('n_batches')} batches "
        f"(mean {_fmt(s.get('mean_batch'))}/dispatch), "
        f"drained={s.get('drained')}")
    out.append(
        f"latency ms: p50 {_fmt(s.get('latency_p50_ms'))}  "
        f"p95 {_fmt(s.get('latency_p95_ms'))}  "
        f"p99 {_fmt(s.get('latency_p99_ms'))}  "
        f"mean {_fmt(s.get('latency_mean_ms'))}  "
        f"max {_fmt(s.get('latency_max_ms'))}")
    util = s.get("utilization")
    if util:
        cores = " ".join(f"core{i}={u:.0%}" for i, u in enumerate(util))
        out.append(f"utilization: {cores}; queue depth mean "
                   f"{_fmt(s.get('queue_depth_mean'))} max "
                   f"{s.get('queue_depth_max')}")
    if s.get("energy_per_frame_uj") is not None:
        out.append(f"energy/frame: "
                   f"{_fmt(s.get('energy_per_frame_uj'), '.2f')} uJ")
    sc = s.get("spot_checks")
    if sc:
        out.append(f"differential spot checks: {sc['n_checks']} batch(es) "
                   f"executed bit-exactly "
                   f"(sizes {sc['checked_sizes']}) — "
                   f"{'OK' if sc['all_bit_exact'] else 'FAILED'}")
    return out


def doctor_lines(s: Dict[str, object]) -> List[str]:
    """Perf-doctor view of one run: where each served request's latency
    went (``metrics.LATENCY_COMPONENTS``, summed bit-exactly per request)
    and how fast the SLO error budget is burning."""
    out: List[str] = []
    bd = s.get("latency_breakdown_ms")
    if bd:
        out.append("# latency decomposition (mean ms per served request; "
                   "per-request components sum to latency bit-exactly)")
        out.append("component,mean_ms,share")
        total = sum(bd.values())
        for k, v in bd.items():
            share = v / total if total else 0.0
            out.append(f"{k},{_fmt(v, '.4g')},{share:.1%}")
    burn = s.get("slo_burn")
    if burn:
        out.append(
            f"# SLO burn: target {burn['slo_target']:.1%} (budget "
            f"{1.0 - burn['slo_target']:.1%}), violations "
            f"{burn['violation_fraction']:.2%} -> burn rate "
            f"{burn['burn_rate']:.2f}x overall, worst window "
            f"{burn['burn_rate_max_windowed']:.2f}x "
            f"(of {burn['n_windows']}); >1x exhausts the budget")
    return out


def frontier_table(plan: Dict[str, object]) -> List[str]:
    """Planner cells -> CSV-ish frontier table (the bench's output)."""
    out = ["device,policy,max_qps,ceiling_qps,p99_ms_at_max,"
           "mean_batch_at_max,energy_uj_at_max"]
    for c in plan["cells"]:
        at = c.get("at_max", {})
        out.append(
            f"{c['device']},{c['policy']},{c['max_qps']:.1f},"
            f"{c['service_ceiling_qps']:.1f},"
            f"{_fmt(at.get('latency_p99_ms'))},"
            f"{_fmt(at.get('mean_batch'))},"
            f"{_fmt(at.get('energy_per_frame_uj'))}")
    b = plan["best"]
    out.append(f"# best: {b['policy']} on {b['device']} -> "
               f"{b['max_qps']:.1f} QPS sustainable")
    return out


def curve_table(plan: Dict[str, object]) -> List[str]:
    """p99-vs-rate curves of every policy on the winning device."""
    out = [f"# p99 vs offered rate on device "
           f"{plan['p99_curves_device']!r} "
           f"(SLO {plan['slo_cycles']:.3g} cycles)",
           "policy,rate_qps,p50_ms,p99_ms,mean_batch,energy_uj,drained"]
    for name, rows in plan["p99_curves"].items():
        for r in rows:
            out.append(
                f"{name},{r['rate_qps']:.1f},{_fmt(r['p50_ms'])},"
                f"{_fmt(r['p99_ms'])},{_fmt(r['mean_batch'])},"
                f"{_fmt(r['energy_per_frame_uj'])},{r['drained']}")
    return out
