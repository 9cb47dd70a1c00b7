"""The port's int8 quantization arithmetic against the JAX reference,
bit for bit, on seeded numpy inputs."""

import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.core import quant as tq


def _requant_both(acc, m, zp, **kw):
    want = np.asarray(jq.requantize(acc, m, zp, **kw))
    got = tq.requantize(torch.from_numpy(acc), m, zp, **kw).numpy()
    return got, want


@pytest.mark.parametrize("relu,q6", [(False, None), (True, None), (True, 90)])
def test_requantize_bit_exact_random(relu, q6):
    rng = np.random.default_rng(0)
    acc = rng.integers(-2**20, 2**20, (64, 48)).astype(np.int32)
    m = (rng.random(48) * 1e-3).astype(np.float32)
    got, want = _requant_both(acc, m, -7, relu=relu, relu6_max_q=q6)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", [0.5, 0.25, 0.125])
def test_requantize_half_ties_round_to_even(m):
    # acc * m lands exactly on .5 for these accumulators: half-to-even, not
    # half-away-from-zero, decides every element.
    step = int(round(1 / m))
    acc = (np.arange(-200, 200, dtype=np.int32) * step + step // 2)
    acc = acc.astype(np.int32)[:, None]
    got, want = _requant_both(acc, np.float32(m), 3)
    np.testing.assert_array_equal(got, want)
    # round(0.5) == 0 and round(1.5) == 2 under half-to-even
    got_half = tq.requantize(torch.tensor([step // 2, 3 * step // 2],
                                          dtype=torch.int32), m, 0)
    assert got_half.tolist() == [0, 2]


def test_quantize_dequantize_equal():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((5, 7, 3)) * 3).astype(np.float32)
    qp = jq.choose_qparams(x)
    tqp = tq.choose_qparams(x)
    assert (qp.scale, qp.zero_point) == (tqp.scale, tqp.zero_point)
    np.testing.assert_array_equal(tq.quantize(x, tqp).numpy(),
                                  np.asarray(jq.quantize(x, qp)))
    q = np.asarray(jq.quantize(x, qp))
    np.testing.assert_array_equal(
        tq.dequantize(torch.tensor(q), tqp).numpy(),
        np.asarray(jq.dequantize(q, qp)))


@pytest.mark.parametrize("axis", [1, 2])
def test_per_channel_quantize_equal(axis):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((3, 4, 6)).astype(np.float32)
    qp = jq.choose_qparams(w, channel_axis=axis)
    tqp = tq.choose_qparams(w, channel_axis=axis)
    np.testing.assert_array_equal(np.asarray(qp.scale), np.asarray(tqp.scale))
    np.testing.assert_array_equal(
        tq.quantize(w, tqp, channel_axis=axis).numpy(),
        np.asarray(jq.quantize(w, qp, channel_axis=axis)))
    q = tq.quantize(w, tqp, channel_axis=axis)
    np.testing.assert_array_equal(
        tq.dequantize(q, tqp, channel_axis=axis).numpy(),
        np.asarray(jq.dequantize(q.numpy(), qp, channel_axis=axis)))


def test_symmetric_qparams_effective_scale_relu6_equal():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(100).astype(np.float32)
    a, b = jq.choose_qparams(x, symmetric=True), tq.choose_qparams(
        x, symmetric=True)
    assert (a.scale, a.zero_point) == (b.scale, b.zero_point)
    s_w = (rng.random(8) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(jq.effective_scale(0.02, s_w, 0.05),
                                  tq.effective_scale(0.02, s_w, 0.05))
    for qp in (jq.QParams(scale=6.0 / 255, zero_point=-128),
               jq.QParams(scale=0.01, zero_point=-20)):
        assert jq.relu6_max_q(qp) == tq.relu6_max_q(
            tq.QParams(qp.scale, qp.zero_point))


def test_fixed_point_oracle_copies_equal():
    rng = np.random.default_rng(4)
    acc = rng.integers(-2**16, 2**16, (32, 8)).astype(np.int32)
    for real in (0.0, 3e-4, 0.7, 1.0):
        assert jq.quantize_multiplier(real) == tq.quantize_multiplier(real)
    qm, shift = tq.quantize_multiplier(0.0123)
    np.testing.assert_array_equal(
        tq.requantize_fixedpoint_np(acc, qm, shift, 5, relu=True),
        jq.requantize_fixedpoint_np(acc, qm, shift, 5, relu=True))
    w = rng.integers(-127, 128, (3, 3, 8)).astype(np.int8)
    np.testing.assert_array_equal(tq.fold_zero_point_correction(w, 11, (0, 1)),
                                  jq.fold_zero_point_correction(w, 11, (0, 1)))


def test_int8_matmul_exact_and_guarded(monkeypatch):
    rng = np.random.default_rng(5)
    a = rng.integers(-128, 128, (7, 1023)).astype(np.int8)
    b = rng.integers(-128, 128, (1023, 5)).astype(np.int8)
    want = a.astype(np.int64) @ b.astype(np.int64)
    got = tq.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="K=1024"):
        tq.int8_matmul(torch.zeros(2, 1024, dtype=torch.int8),
                       torch.zeros(1024, 2, dtype=torch.int8))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        tq.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
