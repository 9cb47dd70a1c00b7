"""The port's CFU fast path against the JAX package's fast path and golden
executor, on the CPU.

The port's ``run_fast`` lifts the same encoded words into torch stage
bodies; on ``device="cpu"`` its fused and row-tile stages run the DSC
kernel's plain version (``ref.fused_dsc_ref``). On the reference's own
weights (carried across with ``params_from_numpy``) it must give the
reference's ``run_fast`` and ``run_words`` outputs exactly, on the matrix of
tests/test_cfu_fastpath.py: every schedule and ``auto`` x streams {1, 2} x
batch {1, 3}. The fingerprint is a sha256 over the encoded words and must be
the reference's. The cache keeps the reference's contract with the device
in place of the backend switch. On a card, chip_smoke.py and the ``gpu``
test of tests/test_torch_kernels.py run the same path through the kernel.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.cfu import compiler as jcompiler
from repro.cfu import executor as jexecutor
from repro.cfu import fastpath as jfastpath
from repro.cfu import network as jnetwork
from repro.core import dsc as jdsc
from repro.core import quant as jquant
from repro.core.dsc import DSCBlockSpec as JSpec
from repro.models import mobilenetv2 as jmnv2
from repro_torch.cfu import compiler as tcompiler
from repro_torch.cfu import executor as texecutor
from repro_torch.cfu import fastpath
from repro_torch.cfu import network as tnetwork
from repro_torch.cfu.timing import PEConfig
from repro_torch.core.dsc import DSCBlockSpec
from repro_torch.kernels import fused_dsc
from repro_torch.models import mobilenetv2 as tmnv2

from test_torch_dsc import to_numpy

HW = 13                       # prime: every tile/halo edge case is live
CHAIN = ((3, 9, 5, 1), (5, 15, 5, 2), (5, 10, 4, 1))
JSPECS = [(f"b{i}", JSpec(cin=a, cmid=b, cout=c, stride=s))
          for i, (a, b, c, s) in enumerate(CHAIN)]
TSPECS = [(f"b{i}", DSCBlockSpec(cin=a, cmid=b, cout=c, stride=s))
          for i, (a, b, c, s) in enumerate(CHAIN)]
NET_HW = 32
CPU = "cpu"


@pytest.fixture(scope="module")
def chain():
    """tests/test_cfu_fastpath.py's chain, built by the reference, and the
    port's copy of the same arrays."""
    params, h = [], HW
    for i, (_, spec) in enumerate(JSPECS):
        p32 = jdsc.init_dsc_block_f32(jax.random.PRNGKey(i), spec)
        calib = np.asarray(jax.random.normal(jax.random.PRNGKey(100 + i),
                                             (h, h, spec.cin)))
        params.append(jdsc.quantize_dsc_block(p32, spec, calib))
        h, _ = spec.out_hw(h, h)
    x_f = np.random.default_rng(0).standard_normal(
        (3, HW, HW, 3)).astype(np.float32)
    x_q = np.asarray(jquant.quantize(x_f, params[0].qp_in))
    tparams = [tmnv2.params_from_numpy(to_numpy(p), device=CPU)
               for p in params]
    fastpath.clear_cache()
    return dict(jparams=params, tparams=tparams, x_q=x_q)


@pytest.fixture(scope="module")
def net():
    jnet = jmnv2.init_and_quantize(jax.random.PRNGKey(2), img_hw=NET_HW)
    tnet = tmnv2.params_from_numpy(to_numpy(jnet), device=CPU)
    imgs = np.random.default_rng(7).standard_normal(
        (3, NET_HW, NET_HW, 3)).astype(np.float32)
    return dict(jnet=jnet, tnet=tnet, imgs=imgs,
                jparams=jnetwork.vww_cfu_params(jnet),
                tparams=tnetwork.vww_cfu_params(tnet),
                x_q=np.asarray(jquant.quantize(imgs, jnet.qp_img)))


def _compile(sched, streams=1, **kw):
    return (jcompiler.compile_network(JSPECS, HW, HW, sched, streams=streams,
                                      **kw),
            tcompiler.compile_network(TSPECS, HW, HW, sched, streams=streams,
                                      **kw))


# --- the differential matrix ------------------------------------------------

MATRIX = [(s, n, b) for s in jcompiler.schedule_names(include_auto=True)
          for n in (1, 2) for b in (1, 3)]


@pytest.mark.parametrize("sched,streams,batch", MATRIX)
def test_matrix_fast_equals_reference(chain, sched, streams, batch):
    jprog, tprog = _compile(sched, streams)
    x = chain["x_q"][:batch] if batch > 1 else chain["x_q"][0]
    if streams == 1:
        golden = jexecutor.run_program(jprog, x, chain["jparams"])
    else:
        # group size 2 over 3 frames = ragged final round in the runner
        golden = jexecutor.run_multistream(jprog, x, chain["jparams"],
                                           batch=2)
    want = np.asarray(jfastpath.run_fast(jprog, x, chain["jparams"]))
    np.testing.assert_array_equal(want, golden)
    before = fused_dsc.LAUNCHES
    got = fastpath.run_fast(tprog, x, chain["tparams"], device=CPU)
    assert fused_dsc.LAUNCHES == before      # CPU: the plain version
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int8
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want,
                                  err_msg=f"{sched} s={streams} b={batch}")


@pytest.mark.parametrize("sched", ["fused", "fused-rowtile",
                                   "fused-winograd", "layer-dram"])
def test_vww_network_fast_equals_reference(net, sched):
    """The whole VWW inference: the lifted stem, head and GAP + FC stages,
    not just DSC blocks; and the forward of the same network."""
    for streams in (1, 2):
        jprog = jcompiler.compile_vww_network(jmnv2.block_specs(), NET_HW,
                                              sched, streams=streams)
        tprog = tcompiler.compile_vww_network(tmnv2.block_specs(), NET_HW,
                                              sched, streams=streams)
        want = np.asarray(jfastpath.run_fast(jprog, net["x_q"],
                                             net["jparams"]))
        got = fastpath.run_fast(tprog, net["x_q"], net["tparams"],
                                device=CPU)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{sched} streams={streams}")
        got1 = fastpath.run_fast(tprog, net["x_q"][0], net["tparams"],
                                 device=CPU)
        np.testing.assert_array_equal(got1.numpy(), want[0])
    fwd = tmnv2.forward_batch(net["imgs"], net["tnet"],
                              return_quantized=True)
    np.testing.assert_array_equal(got.numpy(), fwd.numpy())
    assert np.abs(want).max() < 127          # not saturated


def test_tensor_input_equals_array_input(chain):
    _, tprog = _compile("fused-rowtile")
    x = chain["x_q"]
    a = fastpath.run_fast(tprog, x, chain["tparams"], device=CPU)
    b = fastpath.run_fast(tprog, torch.from_numpy(x.copy()),
                          chain["tparams"], device=CPU)
    assert torch.equal(a, b)


# --- stage bodies ------------------------------------------------------------


def test_mm_exact_past_one_f32_chunk():
    """K = 2000 > 1023: two float32 chunks summed in int32 equal the int64
    product, where one float32 GEMM would round."""
    rng = np.random.default_rng(0)
    a = np.full((4, 2000), -128, np.int8)
    a[1:] = rng.integers(-128, 128, (3, 2000))
    w = np.full((2000, 3), -128, np.int8)
    want = a.astype(np.int64) @ w.astype(np.int64)
    got = fastpath.mm(torch.from_numpy(a), torch.from_numpy(w), 2000)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert fastpath._F32_EXACT_K == 1023
    assert fastpath._f32_gemm_exact(1023) and not fastpath._f32_gemm_exact(
        1024)


def test_winograd_stage_lifted_and_kernel_tile_rows(chain):
    """The stage descriptors: row-tile stages carry the tile height of
    their CFG_STRIP word, fused pixel-wise stages carry none (the kernel's
    plan picks), winograd and layer stages do not use the kernel."""
    impls = {}
    for sched in ("fused", "fused-rowtile", "fused-winograd", "layer-sram"):
        _, tprog = _compile(sched)
        ex = fastpath.fast_executor(tprog, chain["tparams"], device=CPU)
        impls[sched] = [(s.impl, s.tile_rows) for s in ex.stages]
    assert impls["fused"] == [("kernel", None)] * 3
    assert all(i == "kernel" and t >= 1 for i, t in impls["fused-rowtile"])
    assert impls["layer-sram"] == [("reference", None)] * 3
    # stride-2 blocks fall back to fused under fused-winograd
    assert [i for i, _ in impls["fused-winograd"]] == [
        "winograd", "kernel", "winograd"]


# --- fingerprints + cache ---------------------------------------------------


@pytest.mark.parametrize("streams", [1, 2])
def test_fingerprint_equals_reference(streams):
    for sched in jcompiler.schedule_names(include_auto=True):
        jprog, tprog = _compile(sched, streams)
        assert (fastpath.program_fingerprint(tprog)
                == jfastpath.program_fingerprint(jprog)), sched
    jprog = jcompiler.compile_vww_network(jmnv2.block_specs(), 80, "fused")
    tprog = tcompiler.compile_vww_network(tmnv2.block_specs(), 80, "fused")
    assert (fastpath.program_fingerprint(tprog)
            == jfastpath.program_fingerprint(jprog))


def test_fingerprint_deterministic_and_sensitive():
    fp = {s: fastpath.program_fingerprint(_compile(s)[1])
          for s in tcompiler.schedule_names()}
    assert fp["fused"] == fastpath.program_fingerprint(_compile("fused")[1])
    assert len(set(fp.values())) == len(fp)
    pe = fastpath.program_fingerprint(
        _compile("fused", pe=PEConfig(4, 4, 21))[1])
    geom = fastpath.program_fingerprint(tcompiler.compile_network(
        TSPECS, 12, 12, "fused"))
    assert len({fp["fused"], pe, geom}) == 3


def test_cache_hit_same_program_miss_on_change(chain):
    fastpath.clear_cache()
    params = chain["tparams"]
    prog_a, prog_b = _compile("fused")[1], _compile("fused")[1]
    ex_a = fastpath.fast_executor(prog_a, params, device=CPU)
    ex_b = fastpath.fast_executor(prog_b, params, device=CPU)
    assert ex_a is ex_b                     # same fingerprint, same executor
    info = fastpath.cache_info()
    assert info["hits"] == 1 and info["misses"] == 1
    ex_pe = fastpath.fast_executor(
        _compile("fused", pe=PEConfig(4, 4, 21))[1], params, device=CPU)
    ex_sched = fastpath.fast_executor(_compile("layer-dram")[1], params,
                                      device=CPU)
    assert ex_pe is not ex_a and ex_sched is not ex_a
    assert fastpath.cache_info()["misses"] == 3
    assert ex_a.device == torch.device("cpu")


def test_cache_misses_on_changed_quant_constants(chain):
    """Same program, recalibrated params: the static key moves, so a new
    executor closes over the NEW constants, and both stay bit-exact."""
    _, prog = _compile("fused")
    params = chain["tparams"]
    params2 = tnetwork.random_chain_params(11, TSPECS, HW)
    ex1 = fastpath.fast_executor(prog, params, device=CPU)
    ex2 = fastpath.fast_executor(prog, params2, device=CPU)
    assert ex1 is not ex2                   # no stale constants
    x = chain["x_q"]
    for p in (params, params2):
        np.testing.assert_array_equal(
            fastpath.run_fast(prog, x, p, device=CPU).numpy(),
            texecutor.run_program(prog, x, p))


def test_weights_are_traced_not_baked(chain):
    """Perturbing only weight VALUES (same quant domains) must reuse the
    cached executor and still change the output."""
    _, prog = _compile("fused")
    params, x_q = chain["tparams"], chain["x_q"]
    ex = fastpath.fast_executor(prog, params, device=CPU)
    w2 = params[0].w_exp.clone()
    w2[0, 0] = w2[0, 0] + 1 if w2[0, 0] < 127 else w2[0, 0] - 1
    params_w = [dataclasses.replace(params[0], w_exp=w2)] + params[1:]
    assert fastpath.fast_executor(prog, params_w, device=CPU) is ex
    y_ref = texecutor.run_program(prog, x_q, params_w)
    np.testing.assert_array_equal(
        fastpath.run_fast(prog, x_q, params_w, device=CPU).numpy(), y_ref)
    assert not np.array_equal(y_ref, texecutor.run_program(prog, x_q,
                                                           params))


def test_cache_lru_eviction_and_bit_exact_rebuild(chain):
    fastpath.clear_cache()
    params, x_q = chain["tparams"], chain["x_q"]
    progs = [_compile(s)[1]
             for s in ("fused", "fused-rowtile", "fused-winograd")]
    try:
        fastpath.set_cache_limit(2)
        ex0 = fastpath.fast_executor(progs[0], params, device=CPU)
        ex1 = fastpath.fast_executor(progs[1], params, device=CPU)
        assert fastpath.cache_info()["size"] == 2
        assert fastpath.cache_info()["evictions"] == 0
        # touching prog0 makes prog1 the LRU entry; prog2 then evicts it
        assert fastpath.fast_executor(progs[0], params, device=CPU) is ex0
        fastpath.fast_executor(progs[2], params, device=CPU)
        info = fastpath.cache_info()
        assert info["size"] == 2 and info["evictions"] == 1
        assert fastpath.fast_executor(progs[0], params, device=CPU) is ex0
        misses = fastpath.cache_info()["misses"]
        ex1b = fastpath.fast_executor(progs[1], params, device=CPU)
        assert ex1b is not ex1
        assert fastpath.cache_info()["misses"] == misses + 1
        np.testing.assert_array_equal(
            fastpath.run_fast(progs[1], x_q, params, device=CPU).numpy(),
            texecutor.run_program(progs[1], x_q, params))
        fastpath.set_cache_limit(1)
        assert fastpath.cache_info()["size"] == 1
        with pytest.raises(ValueError):
            fastpath.set_cache_limit(0)
    finally:
        fastpath.clear_cache()          # also restores the default limit
    assert fastpath.cache_info()["limit"] == fastpath._DEFAULT_CACHE_LIMIT


# --- devices and refusals ----------------------------------------------------


def test_default_device_is_cuda_and_raises_without_a_card(chain):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, prog = _compile("fused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fastpath.run_fast(prog, chain["x_q"], chain["tparams"])


def test_kernel_width_refusal_at_lift_time(chain):
    """On CUDA the chain's fused stages (C 3, M 9) are widths the kernel
    does not take: they are refused with the limit named, never run on the
    plain version. Layer stages and the CPU take any width."""
    _, prog = _compile("fused")
    stages = fastpath._lift_program(prog)
    with pytest.raises(fastpath.FastPathError, match="multiples of 8"):
        fastpath.check_stage_device(stages[0], "cuda")
    for st in stages:
        fastpath.check_stage_device(st, "cpu")
    for st in fastpath._lift_program(_compile("layer-dram")[1]):
        fastpath.check_stage_device(st, "cuda")
    wide = dataclasses.replace(stages[0], cin=8, cmid=48, cout=16)
    fastpath.check_stage_device(wide, "cuda")
    too_wide = dataclasses.replace(stages[0], cin=72, cmid=48, cout=16)
    with pytest.raises(fastpath.FastPathError, match="C <= 64"):
        fastpath.check_stage_device(too_wide, "cuda")


def test_run_fast_rejects_bad_input_shape(chain):
    _, prog = _compile("fused")
    with pytest.raises(ValueError):
        fastpath.run_fast(prog, np.zeros((HW, HW), np.int8),
                          chain["tparams"], device=CPU)
    with pytest.raises(ValueError):
        fastpath.run_fast(prog, torch.zeros((2, HW, HW, 4), dtype=torch.int8),
                          chain["tparams"], device=CPU)
