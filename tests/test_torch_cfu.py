"""The port's CFU stack against the JAX package's: ISA, compiler, golden
executor, timing model and report tables.

The compiler and the timing model are numpy and Python, so their products
must be equal: encoded words byte for byte (``==`` on the bytes), cycles,
bytes and energy with ``==`` on the report dataclasses, table lines as
strings. The golden executor must give the reference's int8 outputs and
counters on the reference's own weights, carried across with
``params_from_numpy``. The JAX network is built once for the module (at
32x32, where the logits do not saturate).
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.cfu import compiler as jcompiler
from repro.cfu import executor as jexecutor
from repro.cfu import isa as jisa
from repro.cfu import network as jnetwork
from repro.cfu import report as jreport
from repro.cfu import timing as jtiming
from repro.core import dsc as jdsc
from repro.core import quant as jquant
from repro.core.dsc import DSCBlockSpec as JSpec
from repro.models import mobilenetv2 as jmnv2
from repro_torch.cfu import compiler as tcompiler
from repro_torch.cfu import executor as texecutor
from repro_torch.cfu import isa as tisa
from repro_torch.cfu import network as tnetwork
from repro_torch.cfu import report as treport
from repro_torch.cfu import timing as ttiming
from repro_torch.core.dsc import DSCBlockSpec
from repro_torch.models import mobilenetv2 as tmnv2

from test_torch_dsc import to_numpy

SCHEDULES = jcompiler.schedule_names(include_auto=True)
VWW_HW = 80
NET_HW = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_cfu_fastpath.py's chain: prime map, odd widths, stride 2
CHAIN_HW = 13
CHAIN = ((3, 9, 5, 1), (5, 15, 5, 2), (5, 10, 4, 1))


def _jspecs(chain):
    return [(f"b{i}", JSpec(cin=a, cmid=b, cout=c, stride=s))
            for i, (a, b, c, s) in enumerate(chain)]


def _tspecs(chain):
    return [(f"b{i}", DSCBlockSpec(cin=a, cmid=b, cout=c, stride=s))
            for i, (a, b, c, s) in enumerate(chain)]


def _words(prog, pkg_isa):
    streams = getattr(prog, "streams", None) or [prog]
    return [pkg_isa.encode_program(p).tobytes() for p in streams]


@functools.lru_cache(maxsize=None)
def _vww(sched, streams, hw=VWW_HW):
    """(reference program, port program) for the VWW network, compiled
    once per module: the compiles dominate this file's time."""
    return (jcompiler.compile_vww_network(jmnv2.block_specs(), hw, sched,
                                          streams=streams),
            tcompiler.compile_vww_network(tmnv2.block_specs(), hw, sched,
                                          streams=streams))


@pytest.fixture(scope="module")
def net():
    """The reference's 32x32 VWW network, its CFU params, images, and the
    port's copies of the same arrays."""
    jnet = jmnv2.init_and_quantize(jax.random.PRNGKey(0), img_hw=NET_HW)
    tnet = tmnv2.params_from_numpy(to_numpy(jnet), device="cpu")
    imgs = np.random.default_rng(5).standard_normal(
        (3, NET_HW, NET_HW, 3)).astype(np.float32)
    x_q = np.asarray(jquant.quantize(imgs, jnet.qp_img))
    return dict(jparams=jnetwork.vww_cfu_params(jnet),
                tparams=tnetwork.vww_cfu_params(tnet), x_q=x_q)


@pytest.fixture(scope="module")
def chain():
    params, h = [], CHAIN_HW
    for i, (_, spec) in enumerate(_jspecs(CHAIN)):
        p32 = jdsc.init_dsc_block_f32(jax.random.PRNGKey(i), spec)
        calib = np.asarray(jax.random.normal(jax.random.PRNGKey(100 + i),
                                             (h, h, spec.cin)))
        params.append(jdsc.quantize_dsc_block(p32, spec, calib))
        h, _ = spec.out_hw(h, h)
    x_f = np.random.default_rng(0).standard_normal(
        (3, CHAIN_HW, CHAIN_HW, 3)).astype(np.float32)
    x_q = np.asarray(jquant.quantize(x_f, params[0].qp_in))
    tparams = [tmnv2.params_from_numpy(to_numpy(p), device="cpu")
               for p in params]
    return dict(jparams=params, tparams=tparams, x_q=x_q)


# --- ISA + compiler: the encoded words -----------------------------------


@pytest.mark.parametrize("streams", [1, 2, 3])
@pytest.mark.parametrize("sched", SCHEDULES)
def test_vww_words_byte_identical(sched, streams):
    jprog, tprog = _vww(sched, streams)
    assert _words(tprog, tisa) == _words(jprog, jisa)
    assert len(tprog) == len(jprog)
    if sched == "auto":
        assert (tprog.meta["block_schedules"]
                == jprog.meta["block_schedules"])


@pytest.mark.parametrize("layer", [n for n, *_ in jreport.PAPER_LAYERS])
def test_paper_layer_blocks_words_byte_identical(layer):
    (_, jspec, hw), = [r for r in jreport.PAPER_LAYERS if r[0] == layer]
    (_, tspec, thw), = [r for r in treport.PAPER_LAYERS if r[0] == layer]
    assert thw == hw
    for jsched, tsched in zip(jcompiler.CFUSchedule, tcompiler.CFUSchedule):
        assert jsched.value == tsched.value
        jprog = jcompiler.compile_block(jspec, hw, hw, jsched, name=layer)
        tprog = tcompiler.compile_block(tspec, hw, hw, tsched, name=layer)
        assert _words(tprog, tisa) == _words(jprog, jisa), tsched


@pytest.mark.parametrize("sched", ["fused", "fused-winograd", "auto"])
def test_assembler_round_trip(sched):
    jprog, tprog = _vww(sched, 2)
    for tp, jp in zip(tprog.streams, jprog.streams):
        text = tisa.program_to_asm(tp)
        assert text == jisa.program_to_asm(jp)
        back = tisa.program_from_asm(text)
        assert (tisa.encode_program(back).tobytes()
                == tisa.encode_program(tp).tobytes())
        words = tisa.encode_program(tp)
        assert [tisa.assemble(tisa.disassemble(int(w))) for w in words] == [
            int(w) for w in words]


# --- the golden executor ---------------------------------------------------


@pytest.mark.parametrize("sched", SCHEDULES)
def test_golden_executor_chain_equal(chain, sched):
    jprog = jcompiler.compile_network(_jspecs(CHAIN), CHAIN_HW, CHAIN_HW,
                                      sched)
    tprog = tcompiler.compile_network(_tspecs(CHAIN), CHAIN_HW, CHAIN_HW,
                                      sched)
    want, jst = jexecutor.run_program(jprog, chain["x_q"], chain["jparams"],
                                      return_stats=True)
    got, tst = texecutor.run_program(tprog, chain["x_q"], chain["tparams"],
                                     return_stats=True)
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("sched", SCHEDULES)
def test_golden_executor_vww_equal(net, sched, batch):
    jprog, tprog = _vww(sched, 1, NET_HW)
    x = net["x_q"][:batch] if batch > 1 else net["x_q"][0]
    want, jst = jexecutor.run_program(jprog, x, net["jparams"],
                                      return_stats=True)
    got, tst = texecutor.run_program(tprog, x, net["tparams"],
                                     return_stats=True)
    assert isinstance(got, np.ndarray) and got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    # the logits are not saturated: a wrong stage would show
    assert np.abs(want).max() < 127


def test_golden_executor_multistream_equal(net):
    jprog, tprog = _vww("fused-rowtile", 3, NET_HW)
    want = jexecutor.run_multistream(jprog, net["x_q"], net["jparams"],
                                     batch=2)
    got = texecutor.run_multistream(tprog, net["x_q"], net["tparams"],
                                    batch=2)
    np.testing.assert_array_equal(got, want)


def test_golden_executor_refuses_tensors_on_a_card(chain):
    """The golden model reads host arrays; a tensor on a card is an error,
    never a quiet copy. A stand-in object reports a CUDA device."""
    class OnCard:
        device = type("Dev", (), {"type": "cuda"})()

        def __array__(self, dtype=None, copy=None):
            raise AssertionError("must not be copied")

    bad = dataclasses.replace(chain["tparams"][0], w_exp=OnCard())
    with pytest.raises(TypeError, match="golden executor reads host"):
        texecutor._BlockWeights.of(bad)


# --- timing model -----------------------------------------------------------

# (streams, pipeline, batch): every pipelining mode on one core, and the
# frame pipeline at a frame group of 4
TIMING = [(1, "v1", 1), (1, "v2", 1), (1, "v3", 1), (1, "v3", 4),
          (2, "v3", 4), (3, "v1", 4)]


@pytest.mark.parametrize("sched", SCHEDULES)
def test_timing_reports_equal(sched):
    for streams, pipeline, batch in TIMING:
        jprog, tprog = _vww(sched, streams)
        if streams == 1:
            want = jtiming.analyze(jprog, pipeline, batch=batch)
            got = ttiming.analyze(tprog, pipeline, batch=batch)
        else:
            want = jtiming.analyze_multistream(jprog, pipeline, batch=batch)
            got = ttiming.analyze_multistream(tprog, pipeline, batch=batch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (
            streams, pipeline, batch)


def test_vww_config_pe_points_equal():
    from repro.configs import vww as jvww
    from repro_torch.configs import vww as tvww
    assert dataclasses.asdict(tvww.VWW) == dataclasses.asdict(jvww.VWW)
    assert ([dataclasses.asdict(p) for p in tvww.PE_SWEEP]
            == [dataclasses.asdict(p) for p in jvww.PE_SWEEP])
    assert dataclasses.asdict(tvww.PAPER_PE) == dataclasses.asdict(
        jvww.PAPER_PE)


def test_random_chain_params_seeded_and_chained():
    specs = tmnv2.block_specs()[:3]
    a = tnetwork.random_chain_params(0, specs, 12)
    b = tnetwork.random_chain_params(0, specs, 12)
    c = tnetwork.random_chain_params(1, specs, 12)
    assert all(np.array_equal(p.w_exp.numpy(), q.w_exp.numpy())
               for p, q in zip(a, b))
    assert not np.array_equal(a[0].w_exp.numpy(), c[0].w_exp.numpy())
    # block i+1 is calibrated on block i's output domain
    assert [p.spec for p in a] == [s for _, s in specs]


# --- entry points ----------------------------------------------------------


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def test_cli_fast_backend_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cfu", "--device", "cpu",
         "--network", "vww", "--backend", "fast", "--batch", "2"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    row = out.stdout.strip().splitlines()[-1].split(",")
    assert row[0] == "fused" and row[-3:-1] == ["True", "True"], out.stdout


def _cli_lines(text):
    """CLI output with the wall-clock column (exec_s) of each row cut."""
    return [ln.rsplit(",", 1)[0] if ln and not ln.startswith("#") else ln
            for ln in text.splitlines()]


@pytest.mark.parametrize("argv", [
    ["--block", "3rd", "--protect", "--fault", "weights"],
    ["--block", "3rd", "--protect", "--fault", "instr", "--doctor"],
    ["--net", "mobilenetv2", "--hw", "12", "--streams", "2", "--doctor",
     "--protect"],
    ["--network", "vww", "--img-hw", "24", "--schedule", "all", "--protect",
     "--doctor", "--batch", "2"],
], ids=["block-weights", "block-instr-doctor", "chain-2core-doctor",
        "vww-all-doctor"])
def test_cli_protect_fault_doctor_lines(argv, capsys):
    """--protect, --fault and --doctor on the CPU print the reference CLI's
    lines (with protection on, every fault is detected whatever the
    weights, which differ between the packages)."""
    from repro.launch import cfu as jcli
    from repro_torch.launch import cfu as tcli
    jcli.main(argv)
    want = _cli_lines(capsys.readouterr().out)
    tcli.main(["--device", "cpu"] + argv)
    got = _cli_lines(capsys.readouterr().out)
    assert got == want
    rows = [ln.split(",") for ln in got
            if ln and not ln.startswith(("#", "schedule,", "category,",
                                         "what_if,"))
            and "," in ln and ln.split(",")[0] in SCHEDULES]
    assert rows and all("True" in r for r in rows)
    if "--fault" in argv:
        assert any("detected=8" in ln for ln in got), got


@pytest.mark.parametrize("flags,match", [
    (["--protect"], "--protect needs --backend golden"),
    (["--fault", "weights"], "--fault needs --backend golden"),
    (["--trace", "t.json"], "--trace needs --backend golden"),
])
def test_cli_fast_backend_refuses_check_words(flags, match):
    from repro_torch.launch import cfu
    with pytest.raises(SystemExit, match=match):
        cfu.main(["--device", "cpu", "--block", "3rd", "--backend", "fast"]
                 + flags)


def test_cfu_modules_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import repro_torch.cfu, repro_torch.cfu.fastpath, "
            "repro_torch.launch.cfu, repro_torch.configs.vww, "
            "repro_torch.cfu.serve, repro_torch.cfu.faults, "
            "repro_torch.cfu.doctor, repro_torch.roofline, "
            "repro_torch.launch.serve_cfu, repro_torch.launch.doctor\n"
            "import repro_torch.cfu.serve.check, "
            "repro_torch.cfu.serve.planner, repro_torch.cfu.serve.report\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
