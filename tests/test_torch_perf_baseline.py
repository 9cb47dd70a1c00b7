"""The port reproduces the pinned serving, faults and doctor fingerprints.

``benchmarks/perf_baseline.json`` pins the reference's modeled numbers;
``benchmarks/check_regression.py:81-280`` computes them. This file
computes the ``serving``, ``faults`` and ``doctor`` sections with the
port at the same parameters (the reference's fault-chain weights carried
across where weights enter) and holds them to the pinned file with that
script's own comparison: exact keys exactly, cycle / QPS keys within its
2%. It reads the baseline and never writes it. The fingerprints are also
held ``==`` to the reference computed in the same test, and where the
reference no longer reproduces a pinned key (``REF_DIVERGES``), the port
is held to the reference alone.
"""

import json
import os

import numpy as np
import pytest

from benchmarks import bench_faults, check_regression as cr
from repro.cfu import compiler as jcompiler
from repro.cfu import doctor as jdoctor
from repro.cfu import executor as jexecutor
from repro.cfu import faults as jfaults
from repro.cfu import isa as jisa
from repro.cfu.ir import SCHEDULES as JSCHEDULES
from repro.cfu.report import PAPER_LAYERS as JLAYERS
from repro.cfu.serve import planner as jplanner
from repro.cfu.timing import PEConfig as JPE
from repro.models import mobilenetv2 as jmnv2
from repro_torch.cfu import compiler as tcompiler
from repro_torch.cfu import doctor as tdoctor
from repro_torch.cfu import executor as texecutor
from repro_torch.cfu import faults as tfaults
from repro_torch.cfu import isa as tisa
from repro_torch.cfu.ir import SCHEDULES as TSCHEDULES
from repro_torch.cfu.report import PAPER_LAYERS as TLAYERS
from repro_torch.cfu.serve import planner as tplanner
from repro_torch.cfu.timing import PEConfig as TPE
from repro_torch.core.dsc import DSCBlockSpec
from repro_torch.models import mobilenetv2 as tmnv2

from test_torch_dsc import to_numpy

# Pinned keys the reference itself no longer reproduces on this tree:
# check_regression's conservation flag sums the categories with the
# builtin ``sum``, which Python 3.12 made compensated (Neumaier). The
# doctor's contract is the left-to-right sum, which the 2-core interval
# meets bit for bit; the compensated sum lands 4.7e-10 off. The port is
# held to the reference's value there.
REF_DIVERGES = {"doctor.vww2core_conservation_exact"}

BASELINE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "perf_baseline.json")

PKG = {
    "ref": dict(planner=jplanner, compiler=jcompiler, doctor=jdoctor,
                executor=jexecutor, faults=jfaults, isa=jisa, PE=JPE,
                mnv2=jmnv2, layers=JLAYERS, schedules=JSCHEDULES),
    "port": dict(planner=tplanner, compiler=tcompiler, doctor=tdoctor,
                 executor=texecutor, faults=tfaults, isa=tisa, PE=TPE,
                 mnv2=tmnv2, layers=TLAYERS, schedules=TSCHEDULES),
}


def serving(pkg):
    """check_regression's section 4."""
    m = PKG[pkg]
    service = m["planner"].build_vww_service(
        cr.IMG_HW, streams=2, pe=m["PE"](*cr.BASE_PE),
        pe_per_core="auto-hetero", freq_hz=cr.FREQ_MHZ * 1e6)
    ceiling = max(service.service_rate_qps(b) for b in range(1, 9))
    s = m["planner"].simulate(service, "timeout", cr.SERVE_RATE_QPS,
                              n_requests=cr.SERVE_REQUESTS,
                              seed=cr.SEED).summary
    return {"service_ceiling_qps": ceiling,
            "rate_qps": cr.SERVE_RATE_QPS,
            "n_served": s["n_served"],
            "n_batches": s["n_batches"],
            "throughput_qps": s.get("throughput_qps", 0.0),
            "latency_p99_ms": s.get("latency_p99_ms", 0.0)}


@pytest.fixture(scope="module")
def fault_setup():
    """bench_faults.reference_setup(): the reference's chain weights, its
    input, and the port's copies of the weights."""
    _, jparams, x_q = bench_faults.reference_setup()
    tparams = [tmnv2.params_from_numpy(to_numpy(p), device="cpu")
               for p in jparams]
    return {"ref": jparams, "port": tparams}, x_q


def faults(pkg, params, x_q):
    """check_regression's section 7; its xb draw follows the serving
    section's fast-path draws on one generator, replayed here."""
    m = PKG[pkg]
    if pkg == "ref":
        specs = list(bench_faults.CAMPAIGN_SPECS)
    else:
        specs = [(n, DSCBlockSpec(cin=s.cin, cmid=s.cmid, cout=s.cout,
                                  stride=s.stride))
                 for n, s in bench_faults.CAMPAIGN_SPECS]
    hw = bench_faults.CAMPAIGN_HW

    def compile_(n_streams):
        kw = {"streams": n_streams} if n_streams > 1 else {}
        return m["compiler"].compile_network(
            specs, hw, hw, bench_faults.CAMPAIGN_SCHEDULE, **kw)

    prog = compile_(1)
    cov = m["faults"].detection_coverage(prog, params, x_q, n_faults=12,
                                         seed=cr.SEED)
    prot = m["faults"].protect_program(prog, params,
                                       activation_checksums=True)
    _, pstats = m["executor"].run_words(m["isa"].encode_program(prot), x_q,
                                        params, prot.meta, return_stats=True)
    rng = np.random.default_rng(cr.SEED)
    rng.standard_normal((8, cr.IMG_HW, cr.IMG_HW, 3))   # section 5's images
    xb = rng.integers(-128, 128, (4, hw, hw, specs[0][1].cin)
                      ).astype(np.int8)
    ms2 = compile_(2)
    base = m["executor"].run_multistream(ms2, xb, params, batch=2)
    y, _ = m["faults"].run_with_dropout(ms2, compile_, xb, params, batch=2,
                                        drop_after_round=2)
    return {**cov, "n_instr_protected": len(prot),
            "check_bytes": pstats.check_bytes,
            "failover_exact": int(np.array_equal(y, base))}


def doctor(pkg):
    """check_regression's section 8."""
    m = PKG[pkg]
    doc, comp, PE = m["doctor"], m["compiler"], m["PE"]
    spec3, hw3 = {n: (s, hw) for n, s, hw in m["layers"]}["3rd"]

    def cons_exact(attr):
        total = getattr(attr, "interval_cycles", None)
        if total is None:
            total = attr.total_cycles
        return int(sum(attr.categories.values()) == total)

    wg_pe = PE(*cr.WINOGRAD_PE)
    a_fused = doc.attribute(
        comp.compile_block(spec3, hw3, hw3, "fused", name="3rd"), "v3")
    p_dw = comp.compile_block(spec3, hw3, hw3, "fused-rowtile", name="3rd",
                              pe=wg_pe)
    a_dw = doc.attribute(p_dw, "v3")
    r_dw = doc.rank(doc.what_if(p_dw, "v3") + doc.what_if_schedules(
        spec3, hw3, hw3, m["schedules"]["fused-rowtile"][0], pipeline="v3",
        pe=wg_pe))
    ms = comp.compile_vww_network(
        m["mnv2"].block_specs(), cr.IMG_HW, "fused", pe=PE(*cr.BASE_PE),
        streams=2, pe_per_core="auto-hetero")
    a_ms = doc.attribute_multistream(ms, "v3", batch=4)
    return {
        "block3_fused_top_pick": a_fused.top,
        "block3_fused_conservation_exact": cons_exact(a_fused),
        "block3_fused_dw_mac_cycles": a_fused.categories["dw_mac"],
        "winograd_gate_top_pick": a_dw.top,
        "winograd_gate_conservation_exact": cons_exact(a_dw),
        "winograd_gate_dw_mac_cycles": a_dw.categories["dw_mac"],
        "winograd_gate_whatif_pick": r_dw[0].name,
        "winograd_gate_whatif_saved_cycles": r_dw[0].cycles_saved,
        "vww2core_top_pick": a_ms.top,
        "vww2core_conservation_exact": cons_exact(a_ms),
        "vww2core_interval_cycles": a_ms.interval_cycles,
        "vww2core_handoff_cycles": a_ms.categories["handoff_sync"],
    }


def _pinned(section):
    with open(BASELINE) as f:
        return json.load(f)[section]


@pytest.mark.parametrize("section", ["serving", "faults", "doctor"])
def test_port_reproduces_pinned_fingerprints(section, fault_setup):
    if section == "faults":
        params, x_q = fault_setup
        got = {p: faults(p, params[p], x_q) for p in PKG}
    else:
        fn = {"serving": serving, "doctor": doctor}[section]
        got = {p: fn(p) for p in PKG}
    assert got["port"] == got["ref"]
    pinned = {section: _pinned(section)}
    rows = cr.compare(pinned, {section: got["port"]})
    ref_rows = cr.compare(pinned, {section: got["ref"]})
    # the port diverges from the pin exactly where the reference does
    assert rows == ref_rows
    assert {r[0] for r in rows} <= REF_DIVERGES, rows
    # check_regression's baseline-independent fault gates, on the port;
    # its conservation gate is checked by the doctor itself (attribute*
    # raise ConservationError unless the left-to-right sums are exact)
    f = got["port"]
    if section == "faults":
        assert f["weights_detected"] == f["weights_faults"] == 12
        assert f["instr_detected"] == f["instr_faults"] == 12
        assert f["failover_exact"] == 1
