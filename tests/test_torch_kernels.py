"""The port's fused DSC kernel and its plain PyTorch version.

On the CPU: the plain version ``repro_torch.kernels.ref.fused_dsc_ref``
equals the JAX oracle and the JAX Pallas kernel (interpret mode) exactly on
the shape matrix of tests/test_kernels.py; ``ops.dsc_block`` takes the plain
version for CPU tensors without counting a launch; the build refuses to run
without nvcc. On a card (``-m gpu``): the CUDA kernel equals the plain
version exactly. The module imports the JAX reference only inside the tests
that use it, and the card test builds its blocks with the port's own
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
    for d in range(16, 257, 16):   # what the launcher asks for is the plan
        assert flash_attention.kernel_smem_bytes(d) == flash_attention.plan(
            1, 64, 64, 1, 1, d).smem_bytes
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
