"""The port's fused DSC kernel and its plain PyTorch version.

On the CPU: the plain version ``repro_torch.kernels.ref.fused_dsc_ref``
equals the JAX oracle and the JAX Pallas kernel (interpret mode) exactly on
the shape matrix of tests/test_kernels.py; ``ops.dsc_block`` takes the plain
version for CPU tensors without counting a launch; the build refuses to run
without nvcc. On a card (``-m gpu``): the CUDA kernel equals the plain
version exactly, and gradients through the flash and fused-FFN kernels
(their backward goes through the plain versions) equal the plain versions'
own, alone and in a smoke model. The module imports the JAX reference only
inside the tests that use it, and the card test builds its blocks with the port's own
quantizer, so the card test runs without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.core import dsc as tdsc
from repro_torch.core.dsc import DSCBlockSpec
from repro_torch.kernels import build, fused_dsc, ops, ref

# tests/test_kernels.py fused-DSC matrix: prime h2, odd W at stride 2,
# tile_rows > h2.
CASES = [
    (DSCBlockSpec(cin=8, cmid=48, cout=8, stride=1), 12, 4),
    (DSCBlockSpec(cin=8, cmid=48, cout=16, stride=2), 12, 3),
    (DSCBlockSpec(cin=16, cmid=96, cout=16, stride=1), 10, 2),
    (DSCBlockSpec(cin=8, cmid=24, cout=8, stride=1), 9, 5),
    (DSCBlockSpec(cin=8, cmid=24, cout=8, stride=1), 13, 4),
    (DSCBlockSpec(cin=8, cmid=24, cout=16, stride=2), 13, 4),
    (DSCBlockSpec(cin=8, cmid=24, cout=8, stride=2), 11, 4),
    (DSCBlockSpec(cin=8, cmid=24, cout=8, stride=1), 7, 16),
]


def kernel_args(spec, hw, b_exp_f32=None):
    """(x_q, weights..., statics) as tests/test_kernels.py builds them, in
    numpy. ``b_exp_f32`` replaces the zero float expansion bias."""
    import jax
    import jax.numpy as jnp
    from repro.core import dsc as jdsc
    from repro.core import quant as jquant
    p32 = jdsc.init_dsc_block_f32(jax.random.PRNGKey(0), spec)
    if b_exp_f32 is not None:
        p32 = dict(p32, b_exp=jnp.asarray(b_exp_f32))
    calib = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                         (hw, hw, spec.cin)))
    qp = jdsc.quantize_dsc_block(p32, spec, calib)
    x_q = np.asarray(jquant.quantize(calib, qp.qp_in))
    return x_q, *_flatten(qp)


def port_kernel_args(spec, hw, b_exp_f32=None):
    """The same, built by the port's own quantizer from a numpy seed."""
    rng = np.random.default_rng(hw)
    p32 = tdsc.init_dsc_block_f32(rng, spec)
    if b_exp_f32 is not None:
        p32["b_exp"] = torch.from_numpy(b_exp_f32)
    calib = rng.standard_normal((hw, hw, spec.cin)).astype(np.float32)
    return _flatten(tdsc.quantize_dsc_block(p32, spec, calib))


def _flatten(qp):
    spec = qp.spec
    arrays = [np.asarray(a) for a in (
        qp.w_exp, qp.w_dw.reshape(9, spec.cmid), qp.w_proj, qp.b_exp,
        qp.b_dw, qp.b_proj, qp.m_exp, qp.m_dw, qp.m_proj)]
    statics = dict(stride=spec.stride,
                   zps=(qp.qp_in.zero_point, qp.qp_f1.zero_point,
                        qp.qp_f2.zero_point, qp.qp_out.zero_point),
                   q6=(qp.q6_f1, qp.q6_f2))
    return arrays, statics


def torch_args(x_q, arrays, device="cpu"):
    x = torch.tensor(x_q, device=device)
    if x.dim() == 3:
        x = x[None]
    return x, [torch.tensor(a, device=device) for a in arrays]


@pytest.mark.parametrize("spec,hw,tile_rows", CASES)
def test_ref_matches_jax_oracle_and_pallas(spec, hw, tile_rows):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.fused_dsc import fused_dsc_pallas
    x_q, arrays, st = kernel_args(spec, hw)
    x, ts = torch_args(x_q, arrays)
    got = ref.fused_dsc_ref(x, *ts, **st)[0].numpy()
    want = np.asarray(jref.fused_dsc_ref(jnp.asarray(x_q), *arrays, **st))
    np.testing.assert_array_equal(got, want)
    pallas = fused_dsc_pallas(jnp.asarray(x_q), *arrays, tile_rows=tile_rows,
                              interpret=True, **st)
    np.testing.assert_array_equal(got, np.asarray(pallas))


def test_ref_batch_equals_single_images():
    spec, hw, _ = CASES[5]
    _, arrays, st = kernel_args(spec, hw)
    xs = np.random.default_rng(0).integers(-128, 128, (3, hw, hw, spec.cin))
    x, ts = torch_args(xs.astype(np.int8), arrays)
    batched = ref.fused_dsc_ref(x, *ts, **st)
    for i in range(3):
        assert torch.equal(batched[i], ref.fused_dsc_ref(x[i:i + 1], *ts,
                                                         **st)[0])


def test_ref_nonzero_expansion_bias_matches_oracle():
    # Held against the JAX oracle only. With a non-zero float b_exp, the
    # Pallas kernel pads out-of-range input ROWS with zp_in before the
    # expansion (src/repro/kernels/fused_dsc.py:78-85) and so differs from
    # its own oracle in the first and last output rows, which pads F1 with
    # zp_f1 (src/repro/kernels/ref.py:41). The port follows the oracle.
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    spec = DSCBlockSpec(cin=8, cmid=24, cout=8, stride=1)
    b = np.random.default_rng(7).standard_normal(spec.cmid).astype(np.float32)
    x_q, arrays, st = kernel_args(spec, 9, b_exp_f32=b)
    assert np.abs(arrays[3] - kernel_args(spec, 9)[1][3]).max() > 0
    x, ts = torch_args(x_q, arrays)
    got = ref.fused_dsc_ref(x, *ts, **st)[0].numpy()
    want = np.asarray(jref.fused_dsc_ref(jnp.asarray(x_q), *arrays, **st))
    np.testing.assert_array_equal(got, want)


def test_ops_dsc_block_cpu_uses_plain_version_without_launch():
    spec, hw, _ = CASES[1]
    x_q, arrays, st = kernel_args(spec, hw)
    x, ts = torch_args(x_q, arrays)
    before = fused_dsc.LAUNCHES
    got = ops.dsc_block(x, *ts, **st)
    assert fused_dsc.LAUNCHES == before
    assert torch.equal(got, ref.fused_dsc_ref(x, *ts, **st))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_dsc.fused_dsc_cuda(x, *ts, **st)
    assert fused_dsc.LAUNCHES == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    search = os.pathsep.join([os.environ.get("PATH", ""), build.CUDA_BIN])
    if shutil.which("nvcc", path=search) is None:   # no toolkit: a real miss
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.load("fused_dsc")
    monkeypatch.setattr(shutil, "which", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
    assert not (tmp_path / "kernels").exists()


@pytest.mark.gpu
def test_fused_dsc_cuda_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused DSC kernel has no CPU mode")
    b = np.random.default_rng(7).standard_normal(24).astype(np.float32)
    # (spec, map, tile_rows, b_exp, batch): the ragged matrix with its tile
    # rows and with the plan's (None), at batch 3 and 1
    cases = [(spec, hw, t, None, n) for spec, hw, tr in CASES
             for t in (tr, None) for n in (3, 1)]
    cases.append((DSCBlockSpec(cin=8, cmid=24, cout=8, stride=1), 9, 4, b, 3))
    cases.append((DSCBlockSpec(cin=8, cmid=24, cout=8, stride=1), 9, None, b,
                  1))
    rng = np.random.default_rng(0)
    for spec, hw, tile_rows, b_exp, batch in cases:
        arrays, st = port_kernel_args(spec, hw, b_exp_f32=b_exp)
        xs = rng.integers(-128, 128, (batch, hw, hw, spec.cin)).astype(np.int8)
        x, ts = torch_args(xs, arrays, device="cuda")
        before = fused_dsc.LAUNCHES
        got = fused_dsc.fused_dsc_cuda(x, *ts, tile_rows=tile_rows, **st)
        torch.cuda.synchronize()
        assert fused_dsc.LAUNCHES == before + 1
        want = ref.fused_dsc_ref(x, *ts, **st)
        assert torch.equal(got, want), (spec, hw, tile_rows, batch)
        x_cpu, ts_cpu = torch_args(xs, arrays)
        assert torch.equal(got.cpu(), ref.fused_dsc_ref(x_cpu, *ts_cpu, **st))
        # the public wrapper sends CUDA tensors to the kernel
        assert torch.equal(ops.dsc_block(x, *ts, **st), want)
        assert fused_dsc.LAUNCHES == before + 2


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if got.dtype == torch.bfloat16:
        # the whole output too: two bf16 roundings differ by ~4e-3 at most,
        # so a structured fault under the elementwise 2e-2 shows here
        diff = (got.float() - want.float()).norm()
        assert float(diff / want.float().norm()) < 1e-2


@pytest.mark.gpu
def test_flash_attention_cuda_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash-attention kernel has no "
                    "CPU mode")
    from repro_torch.kernels import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # (b, tq, tk, h, hkv, d, causal, window, softcap)
        (4, 128, 128, 1, 1, 64, True, None, None),
        (4, 256, 256, 1, 1, 64, True, None, 50.0),
        (4, 128, 384, 1, 1, 64, False, None, None),
        (4, 256, 256, 1, 1, 64, True, 64, None),
        (4, 100, 100, 1, 1, 32, True, None, None),
        (4, 64, 160, 1, 1, 32, False, 48, None),
        (2, 509, 509, 16, 8, 256, True, 64, 50.0),
        (1, 8, 3, 2, 1, 32, False, 1, None),      # rows with no valid key
        # the wgmma kernel's edges: d 16 and 128 (d padded to 64-column TMA
        # boxes), Tk < 64, ragged boxes on both edges, P 509 unwindowed
        (1, 64, 64, 2, 1, 16, True, None, None),
        (2, 130, 130, 4, 2, 128, True, None, 50.0),
        (2, 40, 40, 2, 2, 64, True, None, None),
        (1, 48, 20, 2, 1, 64, False, None, None),
        (2, 65, 129, 2, 1, 64, False, 48, None),
        (2, 509, 509, 16, 8, 256, True, None, 50.0),
    ]
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for b, tq, tk, h, hkv, d, causal, window, softcap in cases:
            q, k, v = (torch.randn((b, t, n, d), generator=gen, device="cuda")
                       .to(dtype) for t, n in ((tq, h), (tk, hkv), (tk, hkv)))
            kw = dict(causal=causal, window=window, softcap=softcap)
            before = flash_attention.LAUNCHES
            got = ops.mha(q, k, v, n_kv_heads=hkv, **kw)
            torch.cuda.synchronize()
            assert flash_attention.LAUNCHES == before + 1
            _close(got, ref.mha_ref(q, k, v, **kw), tol)


@pytest.mark.gpu
def test_fused_ffn_cuda_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused-FFN kernel has no CPU mode")
    from repro_torch.kernels import fused_ffn
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(64, 128, 512, "silu", True), (32, 64, 192, "gelu", True),
             (128, 128, 384, "relu_sq", True), (64, 96, 256, "gelu", False),
             (1, 256, 1040, "relu", True), (77, 3584, 1024, "gelu", True),
             # gemma2-9b's decode and a ragged prefill: d_ff groups with f32
             # partials, and one cluster walk over 16 token tiles
             (4, 3584, 14336, "gelu", True), (1000, 3584, 14336, "gelu", True)]
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for t, d, f, act, gated in cases:
            x = torch.randn((t, d), generator=gen, device="cuda").to(dtype)
            # 0.05 as tests/test_kernels.py, fan-in scaled at wide shapes so
            # that outputs stay O(1) and 2e-5 bounds the f32 sum order
            wg, wu, wd = (
                (torch.randn(s, generator=gen, device="cuda")
                 * min(0.05, s[0] ** -0.5)).to(dtype)
                for s in ((d, f), (d, f), (f, d)))
            wg = wg if gated else None
            before = fused_ffn.LAUNCHES
            got = ops.ffn(x, wg, wu, wd, act=act)
            torch.cuda.synchronize()
            assert fused_ffn.LAUNCHES == before + 1
            _close(got, ref.fused_ffn_ref(x, wg, wu, wd, act=act), tol)


@pytest.mark.gpu
def test_wide_ffn_and_new_flash_shapes_cuda_match_plain():
    """The dense configs past gemma2: the bf16 FFN at d_model 4096, 5120
    and 8192 (d_model cut into slices of one cluster each) at decode, at
    prefill and at a ragged T and d_model, one f32 case; flash attention at
    hubert's shape (d 80, no causal mask), internvl2's (d 64, 16:2 GQA, T
    768) and glm4's (d 128, 32:2 GQA)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused-FFN and flash-attention "
                    "kernels have no CPU mode")
    from repro_torch.kernels import flash_attention, fused_ffn
    gen = torch.Generator(device="cuda").manual_seed(1)
    ffn_cases = [(4, 4096, 13696, torch.bfloat16),
                 (2048, 5120, 17408, torch.bfloat16),
                 (4, 8192, 29568, torch.bfloat16),
                 (333, 8192, 29568, torch.bfloat16),
                 (70, 3600, 512, torch.bfloat16),
                 (7, 4096, 1024, torch.float32)]
    for t, d, f, dtype in ffn_cases:
        x = torch.randn((t, d), generator=gen, device="cuda").to(dtype)
        wg, wu, wd = ((torch.randn(s, generator=gen, device="cuda")
                       * s[0] ** -0.5).to(dtype)
                      for s in ((d, f), (d, f), (f, d)))
        before = fused_ffn.LAUNCHES
        got = ops.ffn(x, wg, wu, wd, act="silu")
        torch.cuda.synchronize()
        assert fused_ffn.LAUNCHES == before + 1
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        _close(got, ref.fused_ffn_ref(x, wg, wu, wd, act="silu"), tol)
        del x, wg, wu, wd
    flash_cases = [  # (b, t, h, hkv, d, causal)
        (2, 512, 16, 16, 80, False), (2, 768, 16, 2, 64, True),
        (1, 512, 32, 2, 128, True)]
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for b, t, h, hkv, d, causal in flash_cases:
            q, k, v = (torch.randn((b, t, n, d), generator=gen, device="cuda")
                       .to(dtype) for n in (h, hkv, hkv))
            before = flash_attention.LAUNCHES
            got = ops.mha(q, k, v, n_kv_heads=hkv, causal=causal)
            torch.cuda.synchronize()
            assert flash_attention.LAUNCHES == before + 1
            _close(got, ref.mha_ref(q, k, v, causal=causal), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1500, 16])
def test_glm4_ffn_at_full_width_one_slice_on_the_card(t):
    """glm4-9b's FFN (d_model 4096, d_ff 13696) at its prefill cell's T 1500
    and its decode cell's T 16: one cluster of 8 covers d_model (one slice,
    256 columns a warpgroup), the plan's span says so with the card's
    resident clusters, no synchronise inside the launch, and y equals the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused-FFN kernel has no CPU mode")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import fused_ffn
    from repro_torch.runtime import trace
    gen = torch.Generator(device="cuda").manual_seed(29)
    d, f = 4096, 13696
    x = torch.randn((t, d), generator=gen, device="cuda").bfloat16()
    wg, wu = ((torch.randn((d, f), generator=gen, device="cuda")
               * d ** -0.5).bfloat16() for _ in range(2))
    wd = (torch.randn((f, d), generator=gen, device="cuda")
          * f ** -0.5).bfloat16()
    ops.ffn(x, wg, wu, wd, act="silu")    # build, opt-in, cluster check
    torch.cuda.synchronize()
    before = fused_ffn.LAUNCHES
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = ops.ffn(x, wg, wu, wd, act="silu")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert fused_ffn.LAUNCHES == before + 1
    (rec,) = trace.records("ffn.plan")
    trace.clear()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    resident = fused_ffn.max_active_clusters(t, d, f, n_sm)
    pl = fused_ffn.plan(t, d, f, torch.bfloat16, n_sm, resident)
    assert (rec.args["slices"], rec.args["cluster"], rec.args["cols"],
            rec.args["resident"]) == (1, 8, 512, resident)
    assert (rec.args["groups"], rec.args["grid"]) == (pl.groups, pl.grid)
    _close(got, ref.fused_ffn_ref(x, wg, wu, wd, act="silu"), 2e-2)


@pytest.mark.gpu
def test_cfu_fast_path_cuda_matches_cpu():
    """The CFU fast path on the card (fused and row-tile stages through the
    DSC kernel, 7 launches per call) equals the CPU fast path (the kernel's
    plain version) on the 80x80 VWW network at batch 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fast path's DSC stages launch the "
                    "fused DSC kernel, which has no CPU mode")
    from repro_torch.cfu import fastpath
    from repro_torch.cfu.compiler import compile_vww_network
    from repro_torch.cfu.network import vww_cfu_params
    from repro_torch.core import quant
    from repro_torch.models import mobilenetv2 as mnv2
    net = mnv2.init_and_quantize(0, img_hw=80, device="cpu")
    params = vww_cfu_params(net)
    imgs = np.random.default_rng(3).standard_normal(
        (3, 80, 80, 3)).astype(np.float32)
    x_q = quant.quantize(imgs, net.qp_img).numpy()
    for sched in ("fused", "fused-rowtile"):
        prog = compile_vww_network(mnv2.block_specs(), 80, sched)
        before = fused_dsc.LAUNCHES
        got = fastpath.run_fast(prog, x_q, params, device="cuda")
        torch.cuda.synchronize()
        assert fused_dsc.LAUNCHES == before + 7, sched
        assert got.device.type == "cuda" and got.dtype == torch.int8
        want = fastpath.run_fast(prog, x_q, params, device="cpu")
        assert torch.equal(got.cpu(), want), sched


# --- gradients through the flash and FFN kernels -----------------------------


def _grad_close(got, want, tol):
    """A gradient through a kernel against the plain version's: present,
    zero only where the plain one is, and within ``_close``'s bounds."""
    assert got is not None and bool((got != 0).any()) == bool(
        (want != 0).any())
    _close(got, want, tol)


@pytest.mark.gpu
def test_ffn_and_mha_gradients_on_the_card_match_plain():
    """Under grad on CUDA tensors ``ops.ffn`` and ``ops.mha`` launch the
    kernels, return outputs with a ``grad_fn``, and give the plain
    versions' gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused-FFN and flash-attention "
                    "kernels have no CPU mode")
    from repro_torch.kernels import flash_attention, fused_ffn
    gen = torch.Generator(device="cuda").manual_seed(3)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        x, wg, wu, wd = (
            (torch.randn(s, generator=gen, device="cuda") * s[0] ** -0.5)
            .to(dtype).requires_grad_()
            for s in ((77, 256), (256, 512), (256, 512), (512, 256)))
        before = fused_ffn.LAUNCHES
        y = ops.ffn(x, wg, wu, wd, act="silu")
        assert y.grad_fn is not None and fused_ffn.LAUNCHES == before + 1
        gy = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
        got = torch.autograd.grad(y, (x, wg, wu, wd), gy)
        want = torch.autograd.grad(
            ref.fused_ffn_ref(x, wg, wu, wd, act="silu"), (x, wg, wu, wd), gy)
        for g, w in zip(got, want):
            _grad_close(g, w, tol)
        q = torch.randn((2, 96, 4, 64), generator=gen, device="cuda").to(
            dtype).requires_grad_()
        k, v = (torch.randn((2, 96, 2, 64), generator=gen, device="cuda")
                .to(dtype).requires_grad_() for _ in range(2))
        before = flash_attention.LAUNCHES
        o = ops.mha(q, k, v, n_kv_heads=2, window=48, softcap=50.0)
        assert (o.grad_fn is not None
                and flash_attention.LAUNCHES == before + 1)
        go = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
        got = torch.autograd.grad(o, (q, k, v), go)
        want = torch.autograd.grad(
            ref.mha_ref(q, k, v, window=48, softcap=50.0), (q, k, v), go)
        for g, w in zip(got, want):
            _grad_close(g, w, tol)


@pytest.mark.gpu
def test_model_gradients_through_the_kernels_on_the_card():
    """The gemma2 smoke model's loss gradient through the flash and FFN
    kernels equals the plain disciplines' (f32, 2e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused-FFN and flash-attention "
                    "kernels have no CPU mode")
    import dataclasses
    from repro_torch import tree
    from repro_torch.kernels import flash_attention, fused_ffn
    from repro_torch.configs import registry
    from repro_torch.models import lm
    base = dataclasses.replace(registry.get_smoke("gemma2-9b"),
                               dtype="float32")
    params = lm.init_params(base, 0, "cuda", torch.float32)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, base.vocab, (2, 64)),
             "labels": rng.integers(0, base.vocab, (2, 64))}
    grads = {}
    for impls in (("kernel", "fused"), ("reference", "reference")):
        cfg = dataclasses.replace(base, attn_impl=impls[0],
                                  block_impl=impls[1])
        before = (flash_attention.LAUNCHES, fused_ffn.LAUNCHES)
        loss, _ = lm.loss_fn(params, cfg, batch)
        grads[impls] = torch.autograd.grad(loss, tree.leaves(params))
        if impls[0] == "kernel":
            # forward + the full remat's recompute, one each per layer
            n = 2 * base.n_layers
            assert (flash_attention.LAUNCHES, fused_ffn.LAUNCHES) == (
                before[0] + n, before[1] + n)
    for g, w in zip(*grads.values()):
        _grad_close(g, w, 2e-5)


@pytest.mark.gpu
def test_custom_ops_on_the_card_are_their_launchers():
    """``repro_torch::fused_ffn`` and ``::flash_attention`` on CUDA tensors:
    ``torch.library.opcheck`` passes, and each op's output equals the
    launcher it wraps (one launch per call)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the custom ops' CUDA impls launch "
                    "the hand kernels")
    from repro_torch.kernels import flash_attention, fused_ffn
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = (torch.randn((64, 256), generator=gen, device="cuda")).bfloat16()
    wg, wu = ((torch.randn((256, 512), generator=gen, device="cuda")
               * 256 ** -0.5).bfloat16() for _ in range(2))
    wd = (torch.randn((512, 256), generator=gen, device="cuda")
          * 512 ** -0.5).bfloat16()
    ffn_op = torch.ops.repro_torch.fused_ffn.default
    torch.library.opcheck(ffn_op, (x, wg, wu, wd, "silu"))
    before = fused_ffn.LAUNCHES
    got = ffn_op(x, wg, wu, wd, "silu")
    assert fused_ffn.LAUNCHES == before + 1
    assert torch.equal(got, fused_ffn.fused_ffn_cuda(x, wg, wu, wd,
                                                     act="silu"))
    q = torch.randn((2, 128, 8, 64), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((2, 128, 2, 64), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    fa_op = torch.ops.repro_torch.flash_attention.default
    torch.library.opcheck(fa_op, (q, k, v, True, 48, 50.0, None))
    before = flash_attention.LAUNCHES
    got = fa_op(q, k, v, True, 48, 50.0, None)
    assert flash_attention.LAUNCHES == before + 1
    assert torch.equal(got, flash_attention.flash_attention_cuda(
        q, k, v, causal=True, window=48, softcap=50.0))


@pytest.mark.gpu
def test_fused_ffn_pads_a_d_ff_shard_the_kernel_refuses():
    """d_ff 856 (glm4-9b's over 16 model ranks) is no multiple of 16: the
    launch goes through the op with zero-padded weights, one launch, equal
    to the plain version on the unpadded weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the padded launch runs the FFN kernel")
    from repro_torch.kernels import fused_ffn
    gen = torch.Generator(device="cuda").manual_seed(5)
    t, d, f = 96, 256, 856
    x = torch.randn((t, d), generator=gen, device="cuda").bfloat16()
    wg, wu = ((torch.randn((d, f), generator=gen, device="cuda")
               * d ** -0.5).bfloat16() for _ in range(2))
    wd = (torch.randn((f, d), generator=gen, device="cuda")
          * f ** -0.5).bfloat16()
    before = fused_ffn.LAUNCHES
    got = fused_ffn.fused_ffn(x, wg, wu, wd, act="silu")
    assert fused_ffn.LAUNCHES == before + 1
    torch.cuda.synchronize()
    _close(got, ref.fused_ffn_ref(x, wg, wu, wd, act="silu"), 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["dsc", "ffn", "flash"])
def test_launchers_refuse_a_plan_their_kernel_cannot_run(kernel,
                                                        monkeypatch):
    """Each launcher runs the plan ``plan`` hands it, or refuses it before
    anything launches, naming the check and the plan: a DSC plan whose
    shared memory is 16 bytes past its layout's; an FFN plan of one ring
    stage, and one of 96 columns a warpgroup (no kernel is built for it);
    a flash plan whose shared memory is not the kernel's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the refusals are the CUDA "
                    "launchers' own")
    from dataclasses import replace

    from repro_torch.kernels import flash_attention, fused_ffn

    def handing(real, edit):
        """``real`` (a ``plan``, or ``fused_ffn.launch_plan``) with
        ``edit`` applied to the plan it gives."""
        def bad(*args):
            got = real(*args)
            if isinstance(got, tuple):   # (SMs, resident clusters, plan)
                return (*got[:-1], edit(got[-1]))
            return edit(got)
        return bad

    def more_smem(pl):
        return replace(pl, smem_bytes=pl.smem_bytes + 16)

    gen = torch.Generator(device="cuda").manual_seed(30)
    if kernel == "dsc":
        spec, hw, _ = CASES[0]
        arrays, st = port_kernel_args(spec, hw)
        xs = np.random.default_rng(30).integers(
            -128, 128, (2, hw, hw, spec.cin)).astype(np.int8)
        x, ts = torch_args(xs, arrays, device="cuda")
        monkeypatch.setattr(fused_dsc, "plan",
                            handing(fused_dsc.plan, more_smem))
        cases = [(lambda: fused_dsc.fused_dsc_cuda(x, *ts, **st),
                  "differ from the kernel's layout")]
        counter = fused_dsc
    elif kernel == "ffn":
        x = torch.randn((64, 256), generator=gen, device="cuda").bfloat16()
        wg, wu = (torch.randn((256, 512), generator=gen, device="cuda")
                  .bfloat16() for _ in range(2))
        wd = torch.randn((512, 256), generator=gen, device="cuda").bfloat16()
        real = fused_ffn.launch_plan

        def launch(**change):
            monkeypatch.setattr(fused_ffn, "launch_plan", handing(
                real, lambda pl: replace(pl, **change)))
            return fused_ffn.fused_ffn_cuda(x, wg, wu, wd, act="silu")
        cases = [(lambda: launch(stages=1), r"stages outside \[2, 6\]"),
                 (lambda: launch(cols=192), "cols / 2 is not")]
        counter = fused_ffn
    else:
        q = torch.randn((1, 64, 2, 64), generator=gen, device="cuda")
        k, v = (torch.randn((1, 64, 1, 64), generator=gen, device="cuda")
                for _ in range(2))
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        monkeypatch.setattr(flash_attention, "plan",
                            handing(flash_attention.plan, more_smem))
        cases = [(lambda: flash_attention.flash_attention_cuda(q, k, v),
                  "shared memory is not the kernel's own")]
        counter = flash_attention
    for launch_bad, why in cases:
        before = counter.LAUNCHES
        with pytest.raises(RuntimeError, match=why) as err:
            launch_bad()
        assert "Plan(" in str(err.value)
        assert counter.LAUNCHES == before
    torch.cuda.synchronize()


def _repeat_decode_attention(q, ck, cv, valid):
    """The decode attention's per-head repeat form, a yardstick: each KV
    head repeated to its query heads, both caches upcast to f32."""
    from repro_torch.models import layers as L
    kr, vr = L.repeat_kv(ck, q.shape[2]), L.repeat_kv(cv, q.shape[2])
    qf = (q.float() * q.shape[-1] ** -0.5).to(kr.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qf.float(), kr.float())
    s = torch.where(valid[None, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(vr.dtype).float(),
                        vr.float()).to(q.dtype)


def _rise(fn):
    """fn's result and the rise of the card's allocated bytes over what was
    allocated before it ran."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


@pytest.mark.gpu
def test_grouped_decode_attention_on_the_card():
    """One glm4-9b decode attention layer at B 16 over a bf16 cache of 1,148
    slots (32 query heads over 2 KV heads, d 128): on the card it equals
    its CPU twin within 2e-2, and allocates under 32 MB over its inputs,
    where the per-head repeat with f32 copies of the cache allocates more
    than 0.5 GB and gives the same attention."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the f32-accumulating bf16 product "
                    "has no CPU kernel")
    from repro_torch.configs import registry
    from repro_torch.models import layers as L
    cfg = registry.get("glm4-9b")
    b, size, pos = 16, 1148, 1100
    gen = torch.Generator().manual_seed(21)
    p = L.init_attention(gen, cfg, dtype=torch.bfloat16)
    shape = (b, size, cfg.n_kv_heads, cfg.head_dim_)
    cache = {n: torch.randn(shape, generator=gen).bfloat16() for n in "kv"}
    x = torch.randn((b, 1, cfg.d_model), generator=gen).bfloat16()
    dev = torch.device("cuda")
    pc = {k: v.to(dev) for k, v in p.items()}
    cc = {k: v.to(dev) for k, v in cache.items()}
    # a first call allocates cuBLAS's workspace; the second writes the same
    # cache row again
    L.attention_decode(x.to(dev), pc, cfg, cc, pos, local=False)
    (got, _), rise = _rise(lambda: L.attention_decode(
        x.to(dev), pc, cfg, cc, pos, local=False))
    want, _ = L.attention_decode(x, p, cfg, cache, pos, local=False)
    _close(got.cpu(), want, 2e-2)
    _close(cc["k"].cpu(), cache["k"], 2e-2)
    assert rise < 32 * 2 ** 20, rise
    # the attention alone, against the repeat form on the same inputs
    q, _, _ = L._project_qkv(x.to(dev), pc, cfg,
                             torch.full((b, 1), pos, device=dev))
    valid = torch.arange(size, device=dev) <= pos
    grouped, g_rise = _rise(lambda: L._decode_grouped(q, cc["k"], cc["v"],
                                                      valid, cfg))
    repeat, r_rise = _rise(lambda: _repeat_decode_attention(
        q, cc["k"], cc["v"], valid))
    _close(grouped, repeat, 2e-2)
    print(f"allocated over the inputs: layer {rise} B, grouped attention "
          f"{g_rise} B, repeat form {r_rise} B")
    assert g_rise < 32 * 2 ** 20, g_rise
    assert r_rise > 2 ** 29, r_rise
