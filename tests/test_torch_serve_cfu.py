"""The port's CFU serving simulator against the JAX package's.

Everything in ``cfu/serve`` but the spot checker is host code (numpy,
Python floats) carried over expression for expression, so on the
reference's geometry (tests/test_cfu_serve.py: VWW 16x16, engines
(4, 4, 21), 300 MHz, one core and two auto-hetero cores) its products
must be equal with ``==``: service quantities, arrival arrays, event
logs, summaries (percentiles included), planner rows and report lines.

The spot checker runs real inference. On the CPU its fast path and its
reference inference run the DSC kernel's plain version; with the
reference's network carried across, its records equal the reference's
for both backends. The CLI gives the reference CLI's summary, and raises
without a card unless it is given ``--device cpu``.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.cfu import compiler as jcompiler
from repro.cfu import network as jnetwork
from repro.cfu.serve import arrivals as jarrivals
from repro.cfu.serve import check as jcheck
from repro.cfu.serve import dispatcher as jdispatcher
from repro.cfu.serve import planner as jplanner
from repro.cfu.serve import policies as jpolicies
from repro.cfu.serve import report as jreport
from repro.cfu.serve import service as jservice
from repro.cfu.timing import PEConfig as JPE
from repro.cfu.trace import Tracer as JTracer
from repro.launch import serve_cfu as jcli
from repro.models import mobilenetv2 as jmnv2
from repro_torch.cfu import compiler as tcompiler
from repro_torch.cfu import network as tnetwork
from repro_torch.cfu.serve import arrivals as tarrivals
from repro_torch.cfu.serve import check as tcheck
from repro_torch.cfu.serve import dispatcher as tdispatcher
from repro_torch.cfu.serve import planner as tplanner
from repro_torch.cfu.serve import policies as tpolicies
from repro_torch.cfu.serve import report as treport
from repro_torch.cfu.serve import service as tservice
from repro_torch.cfu.timing import PEConfig as TPE
from repro_torch.cfu.trace import Tracer as TTracer
from repro_torch.models import mobilenetv2 as tmnv2

from test_torch_doctor import plain
from test_torch_dsc import to_numpy

try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:          # optional extra
    HAVE_HYPOTHESIS = False

IMG_HW = 16
FREQ = 300e6
SLO = 0.030 * FREQ
POLICIES = ("immediate", "timeout", "adaptive")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "ref": dict(planner=jplanner, arrivals=jarrivals, policies=jpolicies,
                dispatcher=jdispatcher, service=jservice, report=jreport,
                check=jcheck, compiler=jcompiler, network=jnetwork,
                mnv2=jmnv2, PE=JPE, Tracer=JTracer),
    "port": dict(planner=tplanner, arrivals=tarrivals, policies=tpolicies,
                 dispatcher=tdispatcher, service=tservice, report=treport,
                 check=tcheck, compiler=tcompiler, network=tnetwork,
                 mnv2=tmnv2, PE=TPE, Tracer=TTracer),
}


def _service(pkg, streams, max_batch=16):
    m = PKGS[pkg]
    kw = {"pe_per_core": "auto-hetero"} if streams > 1 else {}
    return m["planner"].build_vww_service(IMG_HW, streams=streams,
                                          pe=m["PE"](4, 4, 21), freq_hz=FREQ,
                                          max_batch=max_batch, **kw)


@pytest.fixture(scope="module", params=[1, 2], ids=["single", "pipe"])
def services(request):
    return {pkg: _service(pkg, request.param) for pkg in PKGS}


def _run(pkg, svc, policy, rate=300.0, n=60, seed=0, tracer=None,
         dropout=None, **kw):
    m = PKGS[pkg]
    kw.setdefault("slo_cycles", SLO)
    pol = m["policies"].make_policy(policy, service=svc, **kw)
    arr = m["arrivals"].poisson(rate, n, freq_hz=FREQ, seed=seed)
    return m["dispatcher"].ServingSimulator(
        svc, pol, arr, tracer=tracer, slo_cycles=kw["slo_cycles"],
        dropout=dropout).run()


# --- the device model ------------------------------------------------------


def test_service_model_quantities_equal(services):
    j, t = services["ref"], services["port"]
    assert t.n_stages == j.n_stages and t.describe() == plain(j.describe())
    for b in range(1, 17):
        assert plain(t.report(b)) == plain(j.report(b))
        assert t.entry_interval_cycles(b) == j.entry_interval_cycles(b)
        assert t.group_latency_cycles(b) == j.group_latency_cycles(b)
        assert t.energy_pj(b) == j.energy_pj(b)
        assert t.core_busy_cycles(b) == j.core_busy_cycles(b)
        assert t.service_rate_qps(b) == j.service_rate_qps(b)
    need = t.group_latency_cycles(1)
    for slo in (need - 1, need, SLO, 1e3 * SLO):
        assert t.slo_feasible(slo) == j.slo_feasible(slo)
        if t.slo_feasible(slo):
            assert t.best_batch_under_slo(slo) == j.best_batch_under_slo(slo)
    with pytest.raises(ValueError, match="infeasible"):
        t.best_batch_under_slo(need - 1)
    with pytest.raises(ValueError, match="outside"):
        t.report(17)


# --- arrivals --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_arrivals_equal(seed, tmp_path):
    for kind in ("poisson", "bursty"):
        for rate in (37.5, 400.0):
            a = jarrivals.make_arrivals(kind, rate, 200, freq_hz=FREQ,
                                        seed=seed)
            b = tarrivals.make_arrivals(kind, rate, 200, freq_hz=FREQ,
                                        seed=seed)
            assert b.dtype == a.dtype and np.array_equal(b, a)
    kw = {"on_fraction": 0.5, "on_mean_s": 0.01}
    assert np.array_equal(
        tarrivals.bursty(90.0, 64, seed=seed, **kw),
        jarrivals.bursty(90.0, 64, seed=seed, **kw))
    ts = np.sort(np.random.default_rng(seed).uniform(0, 2, 50)).tolist()
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"arrivals_s": ts}))
    for n, rescale in ((None, False), (40, False), (50, True)):
        a = jarrivals.make_arrivals("trace", 20.0, n, freq_hz=FREQ,
                                    trace_path=str(path),
                                    rescale_to_rate=rescale)
        b = tarrivals.make_arrivals("trace", 20.0, n, freq_hz=FREQ,
                                    trace_path=str(path),
                                    rescale_to_rate=rescale)
        assert np.array_equal(b, a)
    with pytest.raises(ValueError, match="50 arrivals but 60"):
        tarrivals.trace(str(path), n=60)
    with pytest.raises(ValueError, match="unknown arrival kind"):
        tarrivals.make_arrivals("uniform", 1.0, 1)


# --- the simulator ---------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
def test_simulation_equal(services, policy):
    """Event logs, summaries and the request-level trace events."""
    kw = {"batch_cap": 4} if policy != "immediate" else {}
    jt, tt = JTracer(clock="cycles"), TTracer(clock="cycles")
    jr = _run("ref", services["ref"], policy, rate=500.0, tracer=jt, **kw)
    tr = _run("port", services["port"], policy, rate=500.0, tracer=tt, **kw)
    assert tr.event_log == jr.event_log
    assert tr.summary == plain(jr.summary)
    assert tt.events == jt.events
    assert plain(tr.requests) == plain(jr.requests)
    assert plain(tr.batches) == plain(jr.batches)
    for rid in range(len(tr.requests)):
        assert tr.metrics.decompose(rid) == jr.metrics.decompose(rid)
    assert treport.summary_lines(tr.summary) == jreport.summary_lines(
        jr.summary)
    assert treport.doctor_lines(tr.summary) == jreport.doctor_lines(
        jr.summary)


def test_dropout_run_equal():
    """tests/test_cfu_faults.py's serving dropout, in both packages."""
    out = {}
    for pkg in PKGS:
        svc = _service(pkg, 2)
        degraded = _service(pkg, 1)
        r0 = _run(pkg, svc, "timeout", n=48,
                  timeout_cycles=0.002 * FREQ)
        disp = [e for e in r0.event_log if e[0] == "dispatch"]
        comp = {e[2]: e[1] for e in r0.event_log if e[0] == "complete"}
        d = disp[len(disp) // 2]
        drop = PKGS[pkg]["dispatcher"].DropoutEvent(
            at_cycles=(d[1] + comp[d[2]]) / 2.0, degraded=degraded, core=1,
            repartition_cycles=1e5)
        out[pkg] = _run(pkg, svc, "timeout", n=48,
                        timeout_cycles=0.002 * FREQ, dropout=drop)
    j, t = out["ref"], out["port"]
    assert t.event_log == j.event_log
    assert t.summary == plain(j.summary)
    assert t.summary["n_replayed"] >= 1 and t.summary["drained"]
    assert treport.summary_lines(t.summary) == jreport.summary_lines(
        j.summary)
    assert treport.doctor_lines(t.summary) == jreport.doctor_lines(
        j.summary)


if HAVE_HYPOTHESIS:

    @settings(deadline=None, max_examples=6,
              suppress_health_check=[HealthCheck.function_scoped_fixture])
    @given(policy=st.sampled_from(POLICIES), cap=st.integers(1, 8),
           rate=st.floats(20.0, 3000.0), n=st.integers(1, 50),
           seed=st.integers(0, 2**16), streams=st.sampled_from([1, 2]))
    def test_property_simulation_equal(policy, cap, rate, n, seed, streams):
        res = {}
        for pkg in PKGS:
            svc = _service(pkg, streams, max_batch=8)
            res[pkg] = _run(pkg, svc, policy, rate=rate, n=n, seed=seed,
                            batch_cap=cap, timeout_cycles=rate * 500.0)
        assert res["port"].event_log == res["ref"].event_log
        assert res["port"].summary == plain(res["ref"].summary)
        assert res["port"].summary["n_served"] == n


# --- the planner -----------------------------------------------------------


def test_seeds_and_labels_equal():
    for base, labels in ((0, ("a", 1)), (12345, ("dev", "timeout", 0.5))):
        assert (tplanner.derive_seed(base, *labels)
                == jplanner.derive_seed(base, *labels))
    for rate in (1.0, 150.0, 1 / 3, 352.3166227210395):
        assert tplanner.rate_label(rate) == jplanner.rate_label(rate)


def test_max_sustainable_qps_equal():
    j, t = _service("ref", 1), _service("port", 1)
    jrow = jplanner.max_sustainable_qps(j, "immediate", SLO, n_requests=80,
                                        seed=0, batch_cap=1)
    trow = tplanner.max_sustainable_qps(t, "immediate", SLO, n_requests=80,
                                        seed=0, batch_cap=1)
    assert trow == plain(jrow)
    assert 0 < trow["max_qps"] <= 1.05 * trow["service_ceiling_qps"]


def test_plan_capacity_equal():
    plans = {}
    for pkg in PKGS:
        plans[pkg] = PKGS[pkg]["planner"].plan_capacity(
            {"one": _service(pkg, 1), "pipe": _service(pkg, 2)},
            [{"name": "immediate", "batch_cap": 1},
             {"name": "timeout", "batch_cap": 2, "timeout_cycles": 1e5}],
            slo_cycles=SLO, n_requests=60, curve_points=2)
    assert plans["port"] == plain(plans["ref"])
    assert (treport.frontier_table(plans["port"])
            == jreport.frontier_table(plans["ref"]))
    assert (treport.curve_table(plans["port"])
            == jreport.curve_table(plans["ref"]))


# --- spot checks -----------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_net():
    """The reference's 16x16 network (tests/test_cfu_serve.py's), its CFU
    params, and the port's copies of the same arrays."""
    jnet = jmnv2.init_and_quantize(jax.random.PRNGKey(2), img_hw=IMG_HW)
    tnet = tmnv2.params_from_numpy(to_numpy(jnet), device="cpu")
    return {"ref": (jnet, jnetwork.vww_cfu_params(jnet)),
            "port": (tnet, tnetwork.vww_cfu_params(tnet))}


def _spot_run(pkg, net, params, backend, streams):
    m = PKGS[pkg]
    kw = ({"streams": 2, "pe_per_core": "auto-hetero"} if streams == 2
          else {})
    prog = m["compiler"].compile_vww_network(
        m["mnv2"].block_specs(), IMG_HW, "fused", pe=m["PE"](4, 4, 21), **kw)
    svc = m["service"].ServiceModel(prog, "v3", freq_hz=FREQ, max_batch=8)
    spot = m["check"].DifferentialSpotCheck.for_vww(
        prog, net, params, img_hw=IMG_HW, every=2, max_checks=2, seed=0,
        backend=backend, golden_every=2)
    res = m["planner"].simulate(svc, "timeout", 800.0, n_requests=24, seed=1,
                                slo_cycles=SLO, batch_cap=3,
                                timeout_cycles=2e5, spot_check=spot)
    return res, spot


@pytest.mark.parametrize("backend,streams", [
    ("golden", 2), ("fast", 1), ("fast", 2)])
def test_spot_check_records_equal(tiny_net, backend, streams):
    jres, jspot = _spot_run("ref", *tiny_net["ref"], backend, streams)
    tres, tspot = _spot_run("port", *tiny_net["port"], backend, streams)
    assert plain(tspot.records) == plain(jspot.records)
    assert tres.summary == plain(jres.summary)
    sc = tres.summary["spot_checks"]
    assert sc["n_checks"] == 2 and sc["all_bit_exact"]
    assert any(s > 1 for s in sc["checked_sizes"])
    assert sc["n_golden_cross"] == (1 if backend == "fast" else 0)


def test_spot_check_catches_poisoned_reference(tiny_net):
    net, params = tiny_net["port"]
    prog = tcompiler.compile_vww_network(tmnv2.block_specs(), IMG_HW,
                                         "fused")
    svc = tservice.ServiceModel(prog, "v3", freq_hz=FREQ, max_batch=8)
    good = tcheck.vww_sampler(net, IMG_HW)

    def poisoned(rng, n):
        frames_q, ref = good(rng, n)
        ref = ref.clone()
        ref.view(-1)[0] += 1        # a single wrong byte must be caught
        return frames_q, ref

    for backend in ("golden", "fast"):
        spot = tcheck.DifferentialSpotCheck(prog, params, poisoned, every=1,
                                            max_checks=1, seed=0,
                                            backend=backend, device="cpu")
        with pytest.raises(tcheck.SpotCheckError, match="NOT bit-exact"):
            tplanner.simulate(svc, "immediate", 100.0, n_requests=4, seed=0,
                              slo_cycles=SLO, batch_cap=1, spot_check=spot)


def test_spot_check_frame_accounting(tiny_net):
    net, params = tiny_net["port"]
    ms = tcompiler.compile_vww_network(tmnv2.block_specs(), IMG_HW, "fused",
                                       streams=2)
    spot = tcheck.DifferentialSpotCheck.for_vww(ms, net, params,
                                                img_hw=IMG_HW, seed=3)
    rec = spot.check(batch_id=0, size=3)
    assert rec.bit_exact and rec.groups_executed == rec.groups_modeled == 1


def test_spot_check_device_is_the_networks(tiny_net):
    # one source for the device: the fast path runs where the sampler's
    # reference runs, so the two outputs are compared on one device
    net, params = tiny_net["port"]
    prog = tcompiler.compile_vww_network(tmnv2.block_specs(), IMG_HW,
                                         "fused")
    spot = tcheck.DifferentialSpotCheck.for_vww(prog, net, params,
                                                img_hw=IMG_HW,
                                                backend="fast")
    assert spot.device == net.device == torch.device("cpu")
    with pytest.raises(TypeError, match="device"):
        tcheck.DifferentialSpotCheck.for_vww(prog, net, params,
                                             img_hw=IMG_HW, backend="fast",
                                             device="cuda")


def test_outputs_equal_is_explicit():
    a = np.arange(-4, 4, dtype=np.int8).reshape(2, 4)
    t = torch.from_numpy(a.copy())
    assert tcheck.outputs_equal(t, a) and tcheck.outputs_equal(a, t)
    assert tcheck.outputs_equal(t, t.clone())
    b = a.copy()
    b[1, 3] += 1
    assert not tcheck.outputs_equal(t, b)
    assert not tcheck.outputs_equal(t, torch.from_numpy(b))
    assert not tcheck.outputs_equal(t, t[:1])


def test_fast_checker_resolves_its_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda checker is legal here")
    with pytest.raises(RuntimeError, match="is_available"):
        tcheck.DifferentialSpotCheck(None, [], None, backend="fast")
    # the golden checker touches no device
    tcheck.DifferentialSpotCheck(None, [], None, backend="golden")


# --- the CLI ---------------------------------------------------------------


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


@pytest.mark.parametrize("argv", [
    ["--img-hw", "16", "--requests", "120", "--rate", "250", "--streams",
     "2", "--pe-per-core", "auto-hetero", "--dropout-at-ms", "40",
     "--doctor"],
    ["--img-hw", "16", "--requests", "60", "--plan", "--batch-cap", "4"],
], ids=["simulate-dropout", "plan"])
def test_cli_summary_equal(argv, tmp_path, capsys):
    jpath, tpath = tmp_path / "ref.json", tmp_path / "port.json"
    jcli.main(argv + ["--spot-checks", "0", "--json", str(jpath)])
    jout = capsys.readouterr().out.splitlines()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_cfu", "--device",
         "cpu", "--spot-checks", "0", "--json", str(tpath)] + argv,
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[:-1] == jout[:-1]   # last: the path
    assert json.loads(tpath.read_text()) == json.loads(jpath.read_text())


@pytest.mark.parametrize("extra", [[], ["--backend", "fast"], ["--plan"]],
                         ids=["default", "fast", "plan"])
def test_cli_raises_without_a_card(extra):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is legal here")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_cfu", "--img-hw",
         "16", "--requests", "8", "--spot-checks", "0"] + extra,
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "served" not in out.stdout
