"""The port's optimizer substrate (``repro_torch.optim``) against the JAX
package's on the CPU: the cases of tests/test_optim.py, each fed the same
numpy arrays in both packages, f32 within 2e-5 (the north star's f32
tolerance: both compute the same f32 expressions, XLA and torch may round a
fused multiply-add differently), and the port's own properties (the update
in place, a tree's leaves in JAX's order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro import optim as jopt
from repro_torch import optim as topt
from repro_torch import tree

TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _tree(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"w": (6, 5), "b": (5,), "emb": (7, 3), "a": (2, 3, 4)}


def test_adamw_first_step_matches_reference_and_jax():
    """After one step from zero moments: update = lr * (g_hat + wd*p)."""
    p, g = [1.0, -2.0, 3.0], [0.1, 0.2, -0.3]
    lr, b1, b2, eps, wd = 0.01, 0.9, 0.95, 1e-8, 0.1
    tp = {"w": _t(p)}
    new_p, st2 = topt.adamw_update({"w": _t(g)}, topt.adamw_init(tp), tp,
                                   lr=lr, b1=b1, b2=b2, eps=eps,
                                   weight_decay=wd)
    gh, pn = np.asarray(g), np.asarray(p)
    mhat = (1 - b1) * gh / (1 - b1)
    vhat = (1 - b2) * gh ** 2 / (1 - b2)
    want = pn - lr * (mhat / (np.sqrt(vhat) + eps) + wd * pn)
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-6)
    assert int(st2.count) == 1 and st2.count.dtype == torch.int32
    jp = {"w": jnp.asarray(p)}
    jnew, _ = jopt.adamw_update({"w": jnp.asarray(g)}, jopt.adamw_init(jp),
                                jp, lr=lr, b1=b1, b2=b2, eps=eps,
                                weight_decay=wd)
    np.testing.assert_allclose(new_p["w"].numpy(), np.asarray(jnew["w"]),
                               atol=TOL, rtol=TOL)


def test_adamw_steps_match_jax_on_a_tree():
    """Ten steps with a fresh gradient each, schedule-driven lr, weight
    decay and bias correction: params and moments within 2e-5 of JAX."""
    rng = np.random.default_rng(3)
    p0 = _tree(rng, SHAPES)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: _t(v) for k, v in p0.items()}
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    for step in range(10):
        g = _tree(rng, SHAPES)
        jlr = jopt.cosine_warmup(step, peak_lr=1e-2, warmup_steps=3,
                                 total_steps=10)
        tlr = topt.cosine_warmup(step, peak_lr=1e-2, warmup_steps=3,
                                 total_steps=10)
        assert float(tlr) == pytest.approx(float(jlr), abs=1e-9)
        jp, js = jopt.adamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                   js, jp, lr=jlr)
        tp, ts = topt.adamw_update({k: _t(v) for k, v in g.items()}, ts, tp,
                                   lr=tlr)
    for k in SHAPES:
        for got, want in ((tp[k], jp[k]), (ts.m[k], js.m[k]),
                          (ts.v[k], js.v[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=TOL, rtol=TOL)
    assert int(ts.count) == int(js.count) == 10


def test_adamw_updates_in_place_and_keeps_dtype():
    p = {"w": torch.ones(4), "h": torch.ones(4, dtype=torch.bfloat16)}
    ids = {k: id(v) for k, v in p.items()}
    st_ = topt.adamw_init(p)
    g = {"w": torch.full((4,), 0.5), "h": torch.full((4,), 0.5,
                                                     dtype=torch.bfloat16)}
    new_p, st2 = topt.adamw_update(g, st_, p, lr=0.1)
    assert {k: id(v) for k, v in new_p.items()} == ids
    assert st2.m is st_.m and st2.v is st_.v
    assert new_p["h"].dtype == torch.bfloat16
    assert st2.m["h"].dtype == torch.bfloat16     # zeros_like the param
    assert float(new_p["w"][0]) < 1.0


def test_adamw_converges_on_quadratic():
    p = {"w": torch.full((8,), 5.0, requires_grad=True)}
    st_ = topt.adamw_init(p)
    for _ in range(300):
        loss = torch.sum(p["w"] ** 2)
        (g,) = torch.autograd.grad(loss, [p["w"]])
        p, st_ = topt.adamw_update({"w": g}, st_, p, lr=0.05,
                                   weight_decay=0.0)
    assert float(torch.sum(p["w"].detach() ** 2)) < 1e-2


def test_clip_by_global_norm():
    g = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    clipped, gn = topt.clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(5.0)
    assert float(topt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    same, _ = topt.clip_by_global_norm(g, 100.0)
    np.testing.assert_allclose(same["a"].numpy(), [3.0])


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_and_global_norm_match_jax(max_norm):
    g = _tree(np.random.default_rng(5), SHAPES)
    jc, jn = jopt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    tc, tn = topt.clip_by_global_norm({k: _t(v) for k, v in g.items()},
                                      max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=TOL)
    for k in SHAPES:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_in_place_equals_clip(max_norm):
    g = _tree(np.random.default_rng(6), SHAPES)
    want, wn = topt.clip_by_global_norm({k: _t(v) for k, v in g.items()},
                                        max_norm)
    flat = [_t(v) for _, v in sorted(g.items())]
    ids = [id(x) for x in flat]
    gn = topt.clip_by_global_norm_(flat, max_norm)
    assert float(gn) == float(wn)
    assert all(id(x) != i for x, i in zip(flat, ids))   # replaced
    for x, k in zip(flat, sorted(g)):
        assert torch.equal(x, want[k])


def test_cosine_warmup_shape():
    kw = dict(peak_lr=1.0, warmup_steps=10, total_steps=100)
    assert float(topt.cosine_warmup(0, **kw)) == 0.0
    assert float(topt.cosine_warmup(10, **kw)) == pytest.approx(1.0)
    assert float(topt.cosine_warmup(100, **kw)) == pytest.approx(0.1,
                                                                 rel=1e-3)


@pytest.mark.parametrize("step", [0, 1, 4, 5, 6, 50, 99, 100, 150])
def test_cosine_warmup_matches_jax(step):
    kw = dict(peak_lr=3e-4, warmup_steps=5, total_steps=100)
    want = float(jopt.cosine_warmup(step, **kw))
    got = topt.cosine_warmup(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)


@given(st.lists(st.floats(-10, 10), min_size=4, max_size=32))
@settings(max_examples=50, deadline=None)
def test_compression_error_feedback_property(vals):
    """QDQ error is bounded by scale/2 and carried exactly as residual; the
    port's output equals JAX's on the same values."""
    g = {"w": torch.tensor(vals, dtype=torch.float32)}
    ghat, res2 = topt.compress_decompress(g, topt.compress_state_init(g))
    amax = max(abs(min(vals)), abs(max(vals)), 1e-12)
    scale = amax / 127.0
    err = g["w"].numpy() - ghat["w"].numpy()
    np.testing.assert_allclose(res2["w"].numpy(), err, atol=1e-6)
    assert np.all(np.abs(err) <= scale * 0.5 + 1e-6)
    jg = {"w": jnp.asarray(vals, jnp.float32)}
    jhat, jres = jopt.compress_decompress(jg, jopt.compress_state_init(jg))
    np.testing.assert_allclose(ghat["w"].numpy(), np.asarray(jhat["w"]),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(res2["w"].numpy(), np.asarray(jres["w"]),
                               atol=TOL, rtol=TOL)


def test_compression_error_feedback_converges():
    """Repeated compression of a constant gradient: cumulative transmitted
    mass approaches the true gradient (error feedback at work)."""
    g = {"w": torch.tensor([1e-3, 1.0, -0.57])}
    res = topt.compress_state_init(g)
    total = np.zeros(3, np.float32)
    for _ in range(50):
        ghat, res = topt.compress_decompress(g, res)
        total += ghat["w"].numpy()
    np.testing.assert_allclose(total / 50.0, g["w"].numpy(), rtol=0.02,
                               atol=1.0 / 127.0 / 50.0 + 1e-6)


def test_compression_matches_jax_over_steps():
    rng = np.random.default_rng(9)
    jres = jopt.compress_state_init(
        {k: jnp.zeros(s) for k, s in SHAPES.items()})
    tres = topt.compress_state_init({k: torch.zeros(s)
                                     for k, s in SHAPES.items()})
    for _ in range(5):
        g = _tree(rng, SHAPES)
        jhat, jres = jopt.compress_decompress(
            {k: jnp.asarray(v) for k, v in g.items()}, jres)
        that, tres = topt.compress_decompress(
            {k: _t(v) for k, v in g.items()}, tres)
        for k in SHAPES:
            np.testing.assert_allclose(that[k].numpy(), np.asarray(jhat[k]),
                                       atol=TOL, rtol=TOL)
            np.testing.assert_allclose(tres[k].numpy(), np.asarray(jres[k]),
                                       atol=TOL, rtol=TOL)


def test_tree_leaves_follow_jax_order():
    rng = np.random.default_rng(1)
    nested = {"z": _tree(rng, {"b": (2,), "a": (3,)}), "a": [np.ones(1),
                                                              np.zeros(2)],
              "m": None}
    want = [np.asarray(x) for x in jax.tree.leaves(nested)]
    got = tree.leaves(nested)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    paths = [p for p, _ in tree.flatten_with_path(nested)]
    assert paths == ["a/0", "a/1", "z/a", "z/b"]
    doubled = tree.map_leaves(lambda x: 2 * x, nested)
    np.testing.assert_array_equal(doubled["z"]["a"], 2 * nested["z"]["a"])
    assert doubled["m"] is None
