"""The port's reliability extension against the JAX package's.

``cfu/faults.py`` is host code over the golden executor, carried over
expression for expression. On the reference's fault chain
(tests/test_cfu_faults.py: two blocks at 10x10), with the reference's
weights carried across through ``params_from_numpy``, the port must give
the same protected words (byte for byte), the same fault draws, the same
campaign cells and records, the same detection coverage (100% when
protected) and the same failover outputs and reports. Nothing may mutate
a program in place: the fast path's cache keys on a program's words.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.cfu import compiler as jcompiler
from repro.cfu import executor as jexecutor
from repro.cfu import faults as jfaults
from repro.cfu import isa as jisa
from repro.cfu.network import random_chain_params as jchain_params
from repro.core.dsc import DSCBlockSpec as JSpec
from repro_torch.cfu import compiler as tcompiler
from repro_torch.cfu import executor as texecutor
from repro_torch.cfu import faults as tfaults
from repro_torch.cfu import fastpath
from repro_torch.cfu import isa as tisa
from repro_torch.core.dsc import DSCBlockSpec
from repro_torch.models import mobilenetv2 as tmnv2

from test_torch_dsc import to_numpy

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:          # optional extra
    HAVE_HYPOTHESIS = False

# tests/test_cfu_faults.py's chain
CHAIN = ((3, 8, 8, 1), (8, 16, 10, 2))
HW = 10
SCHEDULES = ("fused", "layer-sram", "layer-dram")


def _jspecs():
    return [(f"b{i}", JSpec(cin=a, cmid=b, cout=c, stride=s))
            for i, (a, b, c, s) in enumerate(CHAIN)]


def _tspecs():
    return [(f"b{i}", DSCBlockSpec(cin=a, cmid=b, cout=c, stride=s))
            for i, (a, b, c, s) in enumerate(CHAIN)]


def _compile(pkg, sched, streams=1):
    comp, specs = ((jcompiler, _jspecs()) if pkg == "ref"
                   else (tcompiler, _tspecs()))
    kw = {"streams": streams} if streams > 1 else {}
    return comp.compile_network(specs, HW, HW, sched, **kw)


def _words(prog, pkg_isa):
    streams = getattr(prog, "streams", None) or [prog]
    return [pkg_isa.encode_program(p).tobytes() for p in streams]


@pytest.fixture(scope="module")
def chain():
    """The reference's chain weights, its input, and the port's copies."""
    jparams = jchain_params(jax.random.PRNGKey(0), _jspecs(), HW, seed=0)
    tparams = [tmnv2.params_from_numpy(to_numpy(p), device="cpu")
               for p in jparams]
    rng = np.random.default_rng(1)
    x_q = rng.integers(-128, 128, (HW, HW, CHAIN[0][0]),
                       dtype=np.int64).astype(np.int8)
    return dict(jparams=jparams, tparams=tparams, x_q=x_q)


# --- the stamping pass -----------------------------------------------------


@pytest.mark.parametrize("acts", [False, True])
@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("sched", SCHEDULES)
def test_protect_program_words_byte_identical(chain, sched, streams, acts):
    jprot = jfaults.protect_program(_compile("ref", sched, streams),
                                    chain["jparams"],
                                    activation_checksums=acts)
    tprog = _compile("port", sched, streams)
    tprot = tfaults.protect_program(tprog, chain["tparams"],
                                    activation_checksums=acts)
    assert _words(tprot, tisa) == _words(jprot, jisa)
    assert len(tprot) > len(tprog)
    assert tprot.meta["parity"] and tprot.meta["protected"]
    assert ({k: v for k, v in tprot.meta.items() if k in
             ("parity", "protected", "streams")}
            == {k: v for k, v in jprot.meta.items() if k in
                ("parity", "protected", "streams")})


@pytest.mark.parametrize("sched", SCHEDULES)
def test_protected_outputs_equal_reference(chain, sched):
    """Detection never perturbs data: the protected stream gives the
    unprotected stream's bytes, and the reference's."""
    tprog = _compile("port", sched)
    tprot = tfaults.protect_program(tprog, chain["tparams"],
                                    activation_checksums=True)
    jprot = jfaults.protect_program(_compile("ref", sched),
                                    chain["jparams"],
                                    activation_checksums=True)
    y0 = texecutor.run_program(tprog, chain["x_q"], chain["tparams"])
    y1, stats = texecutor.run_program(tprot, chain["x_q"], chain["tparams"],
                                      return_stats=True)
    yj, jstats = jexecutor.run_program(jprot, chain["x_q"],
                                       chain["jparams"], return_stats=True)
    np.testing.assert_array_equal(y1, y0)
    np.testing.assert_array_equal(y1, yj)
    assert stats.check_bytes == jstats.check_bytes > 0


def test_protect_needs_params(chain):
    with pytest.raises(ValueError, match="params"):
        tfaults.protect_program(_compile("port", "fused"), None)


def test_nothing_mutates_a_program(chain):
    """protect_program, the campaign and the fault helpers leave the
    compiled program, its words and its fast-path fingerprint as they
    were (the fast path's cache keys on the words)."""
    prog = _compile("port", "fused")
    words = tisa.encode_program(prog)
    fp = fastpath.program_fingerprint(prog)
    instrs, meta = list(prog.instrs), dict(prog.meta)
    prot = tfaults.protect_program(prog, chain["tparams"],
                                   activation_checksums=True)
    tfaults.run_campaign(prog, chain["tparams"], chain["x_q"], n_faults=2,
                         seed=3)
    pwords = tisa.encode_program(prot)
    inj = tfaults.FaultInjector(pwords, prot.meta, chain["tparams"], seed=0)
    w_fault, i_fault = inj.sample("weights"), inj.sample("instr")
    before = [np.array(getattr(p, w_fault.which)) for p in chain["tparams"]
              if getattr(p, w_fault.which, None) is not None]
    tfaults.faulted_params(chain["tparams"], w_fault)
    flipped = tfaults.faulted_words(pwords, i_fault)
    assert not np.array_equal(flipped, pwords)
    after = [np.array(getattr(p, w_fault.which)) for p in chain["tparams"]
             if getattr(p, w_fault.which, None) is not None]
    assert all(np.array_equal(a, b) for a, b in zip(before, after))
    assert np.array_equal(tisa.encode_program(prot), pwords)
    assert prog.instrs == instrs and prog.meta == meta
    assert np.array_equal(tisa.encode_program(prog), words)
    assert fastpath.program_fingerprint(prog) == fp


# --- fault draws and campaigns ---------------------------------------------


@pytest.mark.parametrize("sched", ["fused", "layer-sram"])
def test_injector_draws_equal(chain, sched):
    jprot = jfaults.protect_program(_compile("ref", sched), chain["jparams"])
    tprot = tfaults.protect_program(_compile("port", sched),
                                    chain["tparams"])
    jw, tw = jisa.encode_program(jprot), tisa.encode_program(tprot)
    jinj = jfaults.FaultInjector(jw, jprot.meta, chain["jparams"], seed=11)
    tinj = tfaults.FaultInjector(tw, tprot.meta, chain["tparams"], seed=11)
    assert tinj.wgt_targets == jinj.wgt_targets
    assert tinj.space_sizes == jinj.space_sizes
    for space in ("weights", "instr", "sram", "dram") * 4:
        assert tinj.targetable(space) == jinj.targetable(space)
        if not tinj.targetable(space):
            with pytest.raises(ValueError, match="zero-size"):
                tinj.sample(space)
            with pytest.raises(ValueError, match="zero-size"):
                jinj.sample(space)
            continue
        assert (dataclasses.asdict(tinj.sample(space))
                == dataclasses.asdict(jinj.sample(space)))
    with pytest.raises(ValueError, match="fault space"):
        tinj.sample("cache")


@pytest.mark.parametrize("protect", [False, True])
@pytest.mark.parametrize("sched", SCHEDULES)
def test_run_campaign_cells_equal(chain, sched, protect):
    kw = dict(n_faults=3, n_flips=(1, 2), seed=5, protect=protect)
    jres = jfaults.run_campaign(_compile("ref", sched), chain["jparams"],
                                chain["x_q"], **kw)
    tres = tfaults.run_campaign(_compile("port", sched), chain["tparams"],
                                chain["x_q"], **kw)
    assert tres == jres
    for cell in tres["cells"].values():
        assert sum(cell.values()) == 3
        if not protect:
            assert cell[tfaults.DETECTED] == 0


def test_detection_coverage_total_and_equal(chain):
    jcov = jfaults.detection_coverage(_compile("ref", "fused"),
                                      chain["jparams"], chain["x_q"],
                                      n_faults=8, seed=0)
    tcov = tfaults.detection_coverage(_compile("port", "fused"),
                                      chain["tparams"], chain["x_q"],
                                      n_faults=8, seed=0)
    assert tcov == jcov
    assert tcov["weights_detected"] == tcov["weights_faults"] == 8
    assert tcov["instr_detected"] == tcov["instr_faults"] == 8


if HAVE_HYPOTHESIS:

    @pytest.fixture(scope="module")
    def protected(chain):
        prot = tfaults.protect_program(_compile("port", "fused"),
                                       chain["tparams"],
                                       activation_checksums=True)
        words = tisa.encode_program(prot)
        golden = texecutor.run_words(words, chain["x_q"], chain["tparams"],
                                     prot.meta)
        return words, prot.meta, golden

    @settings(deadline=None, max_examples=8)
    @given(seed=st.integers(0, 2**31 - 1),
           space=st.sampled_from(["weights", "instr"]))
    def test_protected_single_flip_always_detected(chain, protected, seed,
                                                   space):
        words, meta, golden = protected
        inj = tfaults.FaultInjector(words, meta, chain["tparams"], seed=seed)
        fault = inj.sample(space)
        assert tfaults.classify_fault(words, meta, chain["tparams"],
                                      chain["x_q"], golden,
                                      [fault]) == tfaults.DETECTED


# --- failover --------------------------------------------------------------


@pytest.mark.parametrize("drop_after_round", [0, 1, 2, 3, 99])
def test_run_with_dropout_equal(chain, drop_after_round):
    xb = np.random.default_rng(7).integers(
        -128, 128, (7, HW, HW, CHAIN[0][0]), dtype=np.int64).astype(np.int8)
    jms, tms = _compile("ref", "fused", 2), _compile("port", "fused", 2)
    jy, jrep = jfaults.run_with_dropout(
        jms, lambda n: _compile("ref", "fused", n), xb, chain["jparams"],
        batch=2, drop_after_round=drop_after_round)
    ty, trep = tfaults.run_with_dropout(
        tms, lambda n: _compile("port", "fused", n), xb, chain["tparams"],
        batch=2, drop_after_round=drop_after_round)
    base = texecutor.run_multistream(tms, xb, chain["tparams"], batch=2)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(ty, base)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert trep.drained_frames + trep.replayed_frames == 7


def test_dropout_needs_a_pipeline(chain):
    with pytest.raises(ValueError, match="multi-core"):
        tfaults.run_with_dropout(
            _compile("port", "fused"), lambda n: None, chain["x_q"],
            chain["tparams"], drop_after_round=1)
