"""The port's LM kernels' plain versions and the modules around them, held
against the JAX package on the CPU.

Inputs come from seeded numpy and go to both packages. The JAX Pallas
kernels run in interpret mode. Tolerances: 2e-5 in float32 (the
tests/test_kernels.py sweeps' own), 2e-2 in bfloat16 (rounding of the
output and of P / h to bf16 at different points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fused_ffn as jffn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention
from repro.kernels.fused_ffn import fused_ffn_pallas
from repro.models import layers as jL
from repro_torch.core import fused_ffn as tffn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import fused_ffn as tff
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as tL

F32_TOL = 2e-5
BF16_TOL = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(a, jnp.float32).astype(jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# --- flash attention ----------------------------------------------------------

# tests/test_kernels.py flash matrix, plus gemma2's head dim with softcap 50
# and a sliding window, and a ragged, prime Tq.
FLASH_CASES = [
    (128, 128, 64, True, None, None),
    (256, 256, 64, True, None, 50.0),
    (128, 384, 64, False, None, None),
    (256, 256, 64, True, 64, None),
    (100, 100, 32, True, None, None),
    (64, 160, 32, False, 48, None),
    (80, 80, 256, True, 16, 50.0),
    (67, 67, 256, True, None, 50.0),
]


@pytest.mark.parametrize("tq,tk,d,causal,window,softcap", FLASH_CASES)
def test_attention_ref_matches_jax_flash_and_oracle(tq, tk, d, causal,
                                                    window, softcap):
    rng = np.random.default_rng(tq * 7 + d)
    arrays = [rng.standard_normal((2, t, d)).astype(np.float32)
              for t in (tq, tk, tk)]
    (jq, q), (jk, k), (jv, v) = (_pair(a, "float32") for a in arrays)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ref.attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(_np(got), _np(jref.attention_ref(jq, jk, jv,
                                                                **kw)),
                               atol=F32_TOL, rtol=F32_TOL)
    pallas = flash_attention(jq, jk, jv, interpret=True, **kw)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=F32_TOL,
                               rtol=F32_TOL)
    # the CPU dispatch is the plain version and counts no launch
    before = tfa.LAUNCHES
    assert torch.equal(ops.attention(q, k, v, **kw), got)
    assert tfa.LAUNCHES == before


@pytest.mark.parametrize("case", [FLASH_CASES[1], FLASH_CASES[6]])
def test_attention_ref_bf16_matches_jax_flash(case):
    tq, tk, d, causal, window, softcap = case
    rng = np.random.default_rng(5)
    arrays = [rng.standard_normal((2, t, d)).astype(np.float32)
              for t in (tq, tk, tk)]
    (jq, q), (jk, k), (jv, v) = (_pair(a, "bfloat16") for a in arrays)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ref.attention_ref(q, k, v, **kw)
    assert got.dtype == torch.bfloat16
    pallas = flash_attention(jq, jk, jv, interpret=True, **kw)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=BF16_TOL,
                               rtol=BF16_TOL)


@pytest.mark.parametrize("b,t,h,hkv,d,window,softcap", [
    (2, 64, 8, 2, 32, None, None),       # tests/test_kernels.py GQA case
    (1, 40, 4, 2, 256, 16, 50.0),        # gemma2 head dim, window, softcap
])
def test_mha_cpu_matches_jax_gqa(b, t, h, hkv, d, window, softcap):
    rng = np.random.default_rng(3)
    (jq, q) = _pair(rng.standard_normal((b, t, h, d)), "float32")
    (jk, k) = _pair(rng.standard_normal((b, t, hkv, d)), "float32")
    (jv, v) = _pair(rng.standard_normal((b, t, hkv, d)), "float32")
    kw = dict(causal=True, window=window, softcap=softcap)
    got = ops.mha(q, k, v, n_kv_heads=hkv, **kw)
    want = jops.mha(jq, jk, jv, n_kv_heads=hkv, interpret=True, **kw)
    assert got.shape == (b, t, h, d)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL,
                               rtol=F32_TOL)
    with pytest.raises(ValueError, match="n_kv_heads"):
        ops.mha(q, k, v, n_kv_heads=hkv * 2, **kw)


def _np_attention_f64(q, k, v, *, causal, window, softcap):
    """The plain attention in numpy float64, on (BH, T, d) arrays."""
    s = np.einsum("bqd,bkd->bqk", q, k) * q.shape[-1] ** -0.5
    if softcap is not None:
        s = softcap * np.tanh(s / softcap)
    qp, kp = np.arange(q.shape[1])[:, None], np.arange(k.shape[1])[None, :]
    mask = np.ones_like(s[0], dtype=bool)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bqk,bkd->bqd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("case", [FLASH_CASES[1], FLASH_CASES[5]])
def test_attention_ref_computes_float64_inputs_in_float64(case):
    # chip_smoke.py holds the f32 kernel to this float64 plain version; a
    # silent cast to float32 inside would make it the host's float32 again.
    tq, tk, d, causal, window, softcap = case
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, t, d)) for t in (tq, tk, tk))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), _np_attention_f64(q, k, v, **kw),
                               atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("gated", [True, False])
def test_fused_ffn_ref_computes_float64_inputs_in_float64(gated):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((16, 64))
    wg, wu, wd = (0.05 * rng.standard_normal(s)
                  for s in ((64, 192), (64, 192), (192, 64)))
    silu = lambda z: z / (1.0 + np.exp(-z))  # noqa: E731
    h = silu(x @ wg) * (x @ wu) if gated else silu(x @ wu)
    got = ref.fused_ffn_ref(torch.from_numpy(x),
                            torch.from_numpy(wg) if gated else None,
                            torch.from_numpy(wu), torch.from_numpy(wd))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), h @ wd, atol=1e-12, rtol=1e-12)


def test_fully_masked_rows_give_zeros_in_the_port():
    # The Pallas kernel returns mean(V) for a row with no valid key; its
    # oracle returns zeros, and the port follows the oracle.
    rng = np.random.default_rng(9)
    (jq, q) = _pair(rng.standard_normal((1, 8, 32)), "float32")
    (jk, k) = _pair(rng.standard_normal((1, 3, 32)), "float32")
    (jv, v) = _pair(rng.standard_normal((1, 3, 32)), "float32")
    got = ref.attention_ref(q, k, v, causal=False, window=1)
    assert torch.count_nonzero(got[0, 3:]) == 0
    np.testing.assert_allclose(
        _np(got), _np(jref.attention_ref(jq, jk, jv, causal=False, window=1)),
        atol=F32_TOL)


# --- fused FFN ---------------------------------------------------------------


def _ffn_arrays(rng, t, d, f, gated=True):
    x = rng.standard_normal((t, d))
    ws = [rng.standard_normal(s) * 0.05 for s in ((d, f), (d, f), (f, d))]
    if not gated:
        ws[0] = None
    return x, ws


@pytest.mark.parametrize("t,d,f", [(64, 128, 512), (32, 64, 192),
                                   (128, 128, 384)])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu_sq"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ffn_ref_matches_jax_pallas(t, d, f, act, dtype):
    rng = np.random.default_rng(t + d + f)
    x, (wg, wu, wd) = _ffn_arrays(rng, t, d, f)
    (jx, tx), (jg, tg), (ju, tu), (jd, td) = (_pair(a, dtype)
                                              for a in (x, wg, wu, wd))
    got = ref.fused_ffn_ref(tx, tg, tu, td, act=act)
    assert got.dtype == tx.dtype
    want = fused_ffn_pallas(jx, jg, ju, jd, act=act, block_t=32, block_f=128,
                            interpret=True)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _np(got), _np(jref.fused_ffn_ref(jx, jg, ju, jd, act=act)),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_fused_ffn_ref_ungated_matches_jax(act):
    rng = np.random.default_rng(1)
    x, (_, wu, wd) = _ffn_arrays(rng, 64, 96, 256, gated=False)
    (jx, tx), (ju, tu), (jd, td) = (_pair(a, "float32") for a in (x, wu, wd))
    got = ref.fused_ffn_ref(tx, None, tu, td, act=act)
    want = fused_ffn_pallas(jx, None, ju, jd, act=act, block_t=32,
                            block_f=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL)
    before = tff.LAUNCHES
    assert torch.equal(ops.ffn(tx, None, tu, td, act=act), got)
    assert tff.LAUNCHES == before


@pytest.mark.parametrize("impl", ["reference", "fused"])
@pytest.mark.parametrize("gated", [True, False])
def test_ffn_apply_matches_jax(impl, gated):
    rng = np.random.default_rng(4)
    x, (wg, wu, wd) = _ffn_arrays(rng, 24, 64, 192, gated=gated)
    x = x.reshape(2, 12, 64)
    names = ["w_gate", "w_up", "w_down"] if gated else ["w_up", "w_down"]
    arrays = [wg, wu, wd] if gated else [wu, wd]
    jx, tx = _pair(x, "float32")
    jp, tp = {}, {}
    for n, a in zip(names, arrays):
        jp[n], tp[n] = _pair(a, "float32")
    act = "gelu"
    got = tffn.ffn_apply(tx, tp, gated=gated, act_name=act, impl=impl,
                         chunk=64)
    want = jffn.ffn_apply(jx, jp, gated=gated, act_name=act, impl=impl,
                          chunk=64)
    assert got.shape == (2, 12, 64)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL,
                               rtol=F32_TOL)
    # the chunked dataflow and the materialized one agree
    other = tffn.ffn_apply(tx, tp, gated=gated, act_name=act,
                           impl="fused" if impl == "reference" else "reference",
                           chunk=64)
    np.testing.assert_allclose(_np(got), _np(other), atol=F32_TOL,
                               rtol=F32_TOL)


def test_ffn_apply_rejects_unknown_impl():
    x = torch.zeros(2, 16)
    p = {"w_up": torch.zeros(16, 32), "w_down": torch.zeros(32, 16)}
    with pytest.raises(ValueError, match="unknown FFN impl"):
        tffn.ffn_apply(x, p, gated=False, act_name="gelu", impl="pallas")


def test_ffn_plan_covers_d_ff_and_keeps_h_in_shared_memory():
    for t, dtype in [(1, torch.bfloat16), (4, torch.bfloat16),
                     (2048, torch.bfloat16), (1000, torch.bfloat16),
                     (64, torch.float32), (17, torch.float32)]:
        for d_ff in (14336, 512, 192, 16):
            pl = tff.plan(t, 3584, d_ff, dtype, n_sm=132,
                          resident=tff.H100_RESIDENT)
            # bf16: groups of whole chunks; f32: splits of 128-column chunks
            step = pl.chunk if dtype == torch.bfloat16 else tff.F32_COLS
            assert pl.chunks * step >= d_ff > (pl.chunks - 1) * step
            assert pl.groups * pl.per_group >= pl.chunks
            assert (pl.groups - 1) * pl.per_group < pl.chunks
            assert pl.smem_bytes <= tff.SMEM_LIMIT
            if dtype == torch.bfloat16:
                # the h chunk (bf16) sits in shared memory
                assert pl.smem_bytes > pl.chunk * pl.block_t * 2
                assert pl.grid[1] * pl.block_t >= t
                assert (pl.ws_bytes == 0) == (pl.groups == 1)
            else:
                assert pl.block_t * pl.chunk * 4 <= tff.F32_H_BYTES
                assert pl.grid[0] * pl.block_t >= t
    # the gemma2-9b path shapes on an H100: prefill (4 d_ff groups fill the
    # last wave of 15 resident clusters) and decode
    assert tff.plan(2048, 3584, 14336, torch.bfloat16, 132,
                    tff.H100_RESIDENT) == tff.Plan(
        64, 8, 448, 512, 3, 4, 7, 28, 214_128, (8, 32, 4), 117_440_512)
    assert tff.plan(4, 3584, 14336, torch.bfloat16, 132,
                    tff.H100_RESIDENT) == tff.Plan(
        64, 8, 448, 512, 3, 14, 2, 28, 214_128, (8, 1, 14), 802_816)


def test_kernel_wrappers_refuse_cpu_tensors_without_counting():
    x = torch.zeros(4, 16)
    w = torch.zeros(16, 32)
    before = (tff.LAUNCHES, tfa.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tff.fused_ffn_cuda(x, w, w, w.T.contiguous(), act="gelu")
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_cuda(q, q, q)
    assert (tff.LAUNCHES, tfa.LAUNCHES) == before


# --- norms and RoPE ------------------------------------------------------------


@pytest.mark.parametrize("zero_centered", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(zero_centered, dtype):
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng.standard_normal((2, 5, 64)) * 3, dtype)
    scale = (rng.standard_normal(64) * 0.1).astype(np.float32)
    got = tL.rms_norm(tx, torch.from_numpy(scale), eps=1e-6,
                      zero_centered=zero_centered)
    want = jL.rms_norm(jx, jnp.asarray(scale), eps=1e-6,
                       zero_centered=zero_centered)
    assert got.dtype == tx.dtype
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope_matches_jax(fraction):
    rng = np.random.default_rng(6)
    jx, tx = _pair(rng.standard_normal((2, 7, 4, 32)), "float32")
    pos = np.stack([np.arange(7), np.arange(7) + 30]).astype(np.int32)
    got = tL.apply_rope(tx, torch.from_numpy(pos), head_dim=32,
                        fraction=fraction, theta=10_000.0)
    want = jL.apply_rope(jx, jnp.asarray(pos), head_dim=32, fraction=fraction,
                         theta=10_000.0)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL,
                               rtol=F32_TOL)
    rot, inv = tL.rope_freqs(32, fraction, 10_000.0)
    jrot, jinv = jL.rope_freqs(32, fraction, 10_000.0)
    assert rot == jrot
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))


def _rope_keys():
    return {k for k in tL._ON_DEVICE if k[0] == "rope"}


def test_rope_table_is_built_once_per_key_and_device():
    """Two calls at one key build one table; another theta, and another
    device (meta), build one more each; the counter counts exactly the
    keys added. The thetas are this test's own, so no other test in the
    process has built them."""
    x = torch.zeros((1, 3, 2, 16))
    pos = torch.arange(3)[None]
    before, keys = tL.ROPE_TABLES, _rope_keys()
    for theta in (31_001.0, 31_001.0, 31_002.0, 31_001.0):
        tL.apply_rope(x, pos, head_dim=16, fraction=1.0, theta=theta)
    assert tL.ROPE_TABLES == before + 2
    tL.apply_rope(x.to("meta"), pos.to("meta"), head_dim=16, fraction=1.0,
                  theta=31_001.0)
    assert tL.ROPE_TABLES == before + 3
    assert len(_rope_keys() - keys) == 3
    assert tL.rope_table(16, 1.0, 31_001.0, x) is \
        tL.rope_table(16, 1.0, 31_001.0, x)
    assert tL.ROPE_TABLES == before + 3


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_table_equals_rope_freqs_bit_for_bit(fraction):
    x = torch.zeros((1, 1, 1, 32))
    got = tL.rope_table(32, fraction, 10_000.0, x)
    _, want = tL.rope_freqs(32, fraction, 10_000.0)
    assert got.dtype == torch.float32 and got.device == x.device
    assert torch.equal(got, want)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_rope_equals_the_uncached_formula(fraction, dtype):
    """``apply_rope`` with its kept table against the formula with the
    table made afresh on every call, bit for bit, twice (the second call
    reads the kept table)."""
    gen = torch.Generator().manual_seed(31)
    x = torch.randn((2, 9, 4, 32), generator=gen).to(dtype)
    pos = torch.stack([torch.arange(9), torch.arange(9) + 700])
    rot, inv = tL.rope_freqs(32, fraction, 10_000.0)
    ang = pos[..., None].float() * inv.to(x.device)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : rot // 2], x[..., rot // 2: rot]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    want = torch.cat([out.to(dtype), x[..., rot:]], dim=-1)
    for _ in range(2):
        got = tL.apply_rope(x, pos, head_dim=32, fraction=fraction,
                            theta=10_000.0)
        assert got.dtype == dtype
        assert torch.equal(got, want)


def test_rope_table_is_not_kept_from_fake_tensors():
    """Under ``FakeTensorMode`` (the dry run) the table is made anew and
    not kept, so a real call afterwards reads a real table, and a fake
    call after a real one does not read the kept real table."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    x, pos = torch.randn((1, 5, 2, 16)), torch.arange(5)[None]
    kw = dict(head_dim=16, fraction=0.5, theta=31_003.0)
    with FakeTensorMode() as mode:
        fake = tL.apply_rope(mode.from_tensor(x), mode.from_tensor(pos), **kw)
    assert isinstance(fake, FakeTensor) and fake.shape == x.shape
    assert not any(isinstance(t, FakeTensor) for t in tL._ON_DEVICE.values())
    real = tL.apply_rope(x, pos, **kw)
    assert not isinstance(real, FakeTensor)
    with FakeTensorMode() as mode:
        again = tL.apply_rope(mode.from_tensor(x), mode.from_tensor(pos),
                              **kw)
    assert isinstance(again, FakeTensor)
    assert torch.equal(tL.apply_rope(x, pos, **kw), real)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_scale_is_kept_and_equals_a_fresh_scalar(dtype):
    """An ``embed_scale`` model's embedding (gemma2's smoke config) times
    sqrt(d_model) rounded to the compute dtype: the kept scalar is one
    tensor across calls and equals the one made afresh, so the embedding
    is bit-equal to the lookup times a fresh scalar."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import lm
    cfg = dataclasses.replace(registry.get_smoke("gemma2-9b"), dtype=dtype)
    assert cfg.embed_scale
    params = lm.init_params(cfg, seed=31, device="cpu")
    tokens = torch.tensor([[1, 5, 7, 2]])
    dt = getattr(torch, dtype)
    want = params["embed"][tokens].to(dt) * torch.tensor(
        cfg.d_model ** 0.5, dtype=dt)
    for _ in range(2):
        assert torch.equal(lm._embed(params, cfg, tokens), want)
    assert lm._embed_scale(cfg, dt, want) is lm._embed_scale(cfg, dt, want)


# --- gradients through the kernel launches --------------------------------------


def _stub(monkeypatch, module, name, plain):
    """Replace a CUDA launch with its plain forward on the CPU, counting
    as the launcher does, to check the autograd wiring around it."""
    def launch(*args, **kw):
        module.LAUNCHES += 1
        assert not torch.is_grad_enabled()     # inside Function.forward
        return plain(*args, **kw)
    monkeypatch.setattr(module, name, launch)


def _counting(monkeypatch, module, fn_name):
    calls = []
    plain = getattr(module, fn_name)

    def counted(*args, **kw):
        calls.append(torch.is_grad_enabled())
        return plain(*args, **kw)
    monkeypatch.setattr(module, fn_name, counted)
    return plain, calls


@pytest.mark.parametrize("gated", [True, False])
def test_ffn_launch_is_an_autograd_function_through_the_plain_version(
        monkeypatch, gated):
    """The forward launches (a stub here) and saves inputs; the backward
    runs the plain version under grad, launches nothing, and returns its
    gradients."""
    plain, calls = _counting(monkeypatch, ref, "fused_ffn_ref")
    _stub(monkeypatch, tff, "fused_ffn_cuda", plain)
    rng = np.random.default_rng(4)
    x, wg, wu = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .requires_grad_() for s in ((6, 32), (32, 48), (32, 48)))
    wd = torch.from_numpy(rng.standard_normal((48, 32)).astype(np.float32)
                          ).requires_grad_()
    wg = wg if gated else None
    args = [t for t in (x, wg, wu, wd) if t is not None]
    before = tff.LAUNCHES
    y = tff.fused_ffn(x, wg, wu, wd, act="gelu")
    assert type(y.grad_fn).__name__ == "FusedFFNBackward"
    assert tff.LAUNCHES == before + 1 and calls == []
    gy = torch.from_numpy(rng.standard_normal((6, 32)).astype(np.float32))
    got = torch.autograd.grad(y, args, gy)
    assert calls == [True]          # backward: the plain version, under grad
    assert tff.LAUNCHES == before + 1           # and no launch
    want = torch.autograd.grad(plain(x, wg, wu, wd, act="gelu"), args, gy)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # an input that needs no gradient gets none
    (gx,) = torch.autograd.grad(
        tff.fused_ffn(x, wg, wu.detach(), wd.detach(), act="gelu"), [x], gy)
    assert torch.equal(gx, want[0])


def test_flash_launch_is_an_autograd_function_through_the_plain_version(
        monkeypatch):
    """The forward launches (a stub here) and saves inputs; the backward
    is ``ref.mha_grads_blocked`` at the launch's ``block``: it launches
    nothing and returns that function's gradients."""
    plain = ref.mha_ref
    blocked, calls = _counting(monkeypatch, ref, "mha_grads_blocked")
    _stub(monkeypatch, tfa, "flash_attention_cuda", plain)
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 24, 4, 32)).astype(
        np.float32)).requires_grad_()
    k, v = (torch.from_numpy(rng.standard_normal((2, 24, 2, 32)).astype(
        np.float32)).requires_grad_() for _ in range(2))
    kw = dict(causal=True, window=8, softcap=30.0, sm_scale=0.2)
    before = tfa.LAUNCHES
    o = tfa.flash_attention(q, k, v, block=10, **kw)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    assert tfa.LAUNCHES == before + 1 and calls == []
    go = torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
    got = torch.autograd.grad(o, (q, k, v), go)
    assert calls == [False] and tfa.LAUNCHES == before + 1
    want = blocked(q.detach(), k.detach(), v.detach(), go, block=10, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the closed form is the plain version's gradient (held apart below)
    auto = torch.autograd.grad(plain(q, k, v, **kw), (q, k, v), go)
    for g, w in zip(got, auto):
        np.testing.assert_allclose(_np(g), _np(w), atol=F32_TOL,
                                   rtol=F32_TOL)


# (B, Tq, Tk, H, Hkv, d, causal, window, softcap, block): each mask and the
# softcap of 50 alone and together, GQA 16/8, blocks that do not divide Tq,
# and rows with no valid key (Tq > Tk under a window)
BLOCKED_CASES = [
    (2, 96, 96, 4, 4, 32, True, None, None, 32),
    (1, 100, 100, 16, 8, 32, True, 24, None, 32),
    (2, 80, 80, 4, 2, 64, True, None, 50.0, 24),
    (1, 64, 64, 16, 8, 32, True, 16, 50.0, 17),
    (2, 48, 80, 4, 4, 32, False, None, None, 20),
    (2, 50, 50, 4, 2, 32, False, 12, 50.0, 16),
    (1, 40, 12, 2, 1, 16, True, 4, None, 16),
]


def _blocked_inputs(case, seed=11):
    b, tq, tk, h, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    q, go = (rng.standard_normal((b, tq, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, tk, hkv, d)).astype(np.float32)
            for _ in range(2))
    causal, window, softcap, block = case[6:]
    return (q, k, v, go), dict(causal=causal, window=window,
                                softcap=softcap, sm_scale=d ** -0.5), block


@pytest.mark.parametrize("case", BLOCKED_CASES)
def test_blocked_attention_gradient_equals_the_plain_versions(case):
    """``mha_grads_blocked`` against autograd of ``mha_ref`` (the
    backward before, ``plain_grads``), f32 within 2e-5; a query row with no
    valid key gets zero gradients, as the forward gives it zeros."""
    arrays, kw, block = _blocked_inputs(case)
    q, k, v, go = map(torch.from_numpy, arrays)
    want = ref.plain_grads(lambda *a: ref.mha_ref(*a, **kw), (q, k, v),
                           (True,) * 3, go)
    got = ref.mha_grads_blocked(q, k, v, go, block=block, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(_np(g), _np(w), atol=F32_TOL,
                                   rtol=F32_TOL)
    if case[-1] == 16 and case[2] == 12:        # rows 15.. see no key
        assert torch.count_nonzero(got[0][:, 15:]) == 0


@pytest.mark.parametrize("case", [c for c in BLOCKED_CASES
                                  if (c[6] and c[2] >= c[1])
                                  or (not c[6] and c[2] % c[-1] == 0)])
def test_blocked_attention_gradient_matches_jax_grad_of_attention_fused(
        case):
    """The same gradients against the reference's training attention:
    ``jax.grad`` of ``layers.attention_fused`` (its K/V scan, ``block_k``
    the block), f32 within 2e-5. Not the cases the reference computes
    another function for: a row with no valid key (its online softmax
    gives the mean of V), and a non-causal mask over keys it pads to its
    block (the pad's position, int32 max, passes the mask)."""
    arrays, kw, block = _blocked_inputs(case)
    q, k, v, go = arrays
    tq, tk = q.shape[1], k.shape[1]

    def jloss(q, k, v):
        o = jL.attention_fused(q, k, v, jnp.arange(tq), jnp.arange(tk),
                               block_k=block, **kw)
        return jnp.sum(o * go)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = ref.mha_grads_blocked(*map(torch.from_numpy, arrays), block=block,
                                **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=F32_TOL,
                                   rtol=F32_TOL)


def test_flash_backward_builds_no_t_by_t_tensor(monkeypatch):
    """The launch's backward at T 256, block 64: no tensor any op makes has
    (T, T) as its last two dims, and none has more elements than
    B H x block x T. The control: the backward before (autograd of the
    plain version) makes them."""
    from torch.utils._python_dispatch import TorchDispatchMode
    b, t, h, hkv, d, block = 1, 256, 4, 2, 32, 64

    class Shapes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.seen += [tuple(o.shape) for o in
                          torch.utils._pytree.tree_leaves(out)
                          if isinstance(o, torch.Tensor)]
            return out

    def backward_shapes():
        rng = np.random.default_rng(8)
        q = torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
            np.float32)).requires_grad_()
        k, v = (torch.from_numpy(rng.standard_normal((b, t, hkv, d)).astype(
            np.float32)).requires_grad_() for _ in range(2))
        o = tfa.flash_attention(q, k, v, causal=True, softcap=50.0,
                                block=block)
        with Shapes() as rec:
            torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
        return rec.seen

    _stub(monkeypatch, tfa, "flash_attention_cuda", ref.mha_ref)
    seen = backward_shapes()
    assert seen and all(s[-2:] != (t, t) for s in seen)
    assert max(np.prod(s) for s in seen) <= b * h * block * t
    monkeypatch.setattr(ref, "mha_grads_blocked",
                        lambda q, k, v, go, block, **kw: ref.plain_grads(
                            lambda *a: ref.mha_ref(*a, **kw), (q, k, v),
                            (True,) * 3, go))
    assert any(s[-2:] == (t, t) for s in backward_shapes())


@pytest.mark.parametrize("which", ["ffn", "flash"])
def test_launch_without_grad_skips_the_autograd_function(monkeypatch, which):
    """Serving (no grad, or no input that requires it) launches the kernel
    alone: one launch, an output with no ``grad_fn``, equal to the launch
    through the Function."""
    rng = np.random.default_rng(6)
    if which == "ffn":
        module, name, plain = tff, "fused_ffn_cuda", ref.fused_ffn_ref
        shapes = ((6, 32), (32, 48), (32, 48), (48, 32))
        call = lambda *a: tff.fused_ffn(*a, act="gelu")
    else:
        module, name, plain = tfa, "flash_attention_cuda", ref.mha_ref
        shapes = ((2, 24, 4, 32), (2, 24, 2, 32), (2, 24, 2, 32))
        call = lambda *a: tfa.flash_attention(*a, causal=True)
    def launch(*a, **kw):
        module.LAUNCHES += 1
        with torch.no_grad():
            return plain(*a, **kw)
    monkeypatch.setattr(module, name, launch)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]
    before = module.LAUNCHES
    served = call(*args)
    assert served.grad_fn is None and module.LAUNCHES == before + 1
    with torch.no_grad():
        off = call(*(a.requires_grad_() for a in args))
    assert off.grad_fn is None and module.LAUNCHES == before + 2
    trained = call(*args)
    assert trained.grad_fn is not None and module.LAUNCHES == before + 3
    assert torch.equal(served, off) and torch.equal(served, trained.detach())
