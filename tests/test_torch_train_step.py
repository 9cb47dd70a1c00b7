"""The port's train step (``repro_torch.runtime.steps``) and remat modes on
the CPU.

* One step of the port against one step of the reference's jitted
  ``build_train_step`` from the same f32 weights and batch, with f32
  microbatch accumulation and with int8 gradient compression: the metrics
  (loss, nll, aux, grad norm, lr), the step and count, the moments and the
  compression residual within 2e-5. The updated parameters are compared
  only where the reference's gradient is above a floor of 1e-3 times the
  leaf's RMS gradient: AdamW's first step moves an element by about
  ``lr * sign(g)``, so an element whose gradient is near zero (where the
  two packages' f32 sums may differ in sign) moves by up to ``2 * lr`` more
  in one package. Under compression, elements within 1% of an int8
  rounding boundary are left out the same way: one package may round them
  to the next level.
* A few steps on the structured synthetic data lower the loss.
* The remat modes give the gradients of ``none`` (a relative norm of 1e-6
  per leaf: the recomputed forward is the same arithmetic, only the order in
  which a shared parameter's gradient contributions add may change), and
  ``zero_buffer`` and ``full`` save no tensor with a d_ff-wide last
  dimension and no (T, T) score matrix for the backward pass, where
  ``none`` saves both (``torch.autograd.graph.saved_tensors_hooks``).
"""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import InputShape as JShape
from repro.data import SyntheticLMData as JData
from repro.launch.mesh import make_mesh
from repro.models import lm as jlm
from repro.runtime import steps as jsteps
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.configs.base import InputShape
from repro_torch.core import fused_ffn as ffnlib
from repro_torch.data import SyntheticLMData
from repro_torch.models import lm
from repro_torch.runtime import steps
from tests.conftest import make_batch

TOL = 2e-5
FLOOR = 1e-3


def _cfgs(name, **over):
    return (dataclasses.replace(jreg.get_smoke(name), dtype="float32",
                                **over),
            dataclasses.replace(registry.get_smoke(name), dtype="float32",
                                **over))


@pytest.mark.parametrize("micro,compression", [(1, False), (2, True)])
def test_train_step_matches_jax(micro, compression):
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b", microbatches=(("t", micro),))
    jshape, tshape = JShape("t", 16, 4, "train"), InputShape("t", 16, 4,
                                                              "train")
    kw = dict(peak_lr=1e-2, warmup_steps=0, total_steps=10,
              grad_compression=compression)
    jtrain, ttrain = jsteps.TrainSpec(**kw), steps.TrainSpec(**kw)
    mesh = make_mesh((1, 1), ("data", "model"))
    jstate = jsteps.init_train_state(jcfg, jax.random.PRNGKey(2), jtrain)
    batch = JData(jcfg, jshape, seed=4).batch_at(0)
    # the reference's gradient, for the masks: the mean over microbatches
    size = 4 // micro
    g_ref = None
    for i in range(micro):
        part = {k: jnp.asarray(v[i * size:(i + 1) * size])
                for k, v in batch.items()}
        g = jax.grad(lambda p: jlm.loss_fn(p, jcfg, part)[0])(jstate.params)
        g = [np.asarray(x) for x in jax.tree.leaves(g)]
        g_ref = g if g_ref is None else [a + b for a, b in zip(g_ref, g)]
    g_ref = [g / micro for g in g_ref]

    tstate = steps.train_state(
        lm.params_from_numpy(jax.tree.map(np.asarray, jstate.params), tcfg,
                             device="cpu"), ttrain)
    jstep = jsteps.build_train_step(jcfg, mesh, jtrain, jshape, donate=False)
    jnew, jmet = jstep(jstate, batch)
    tnew, tmet = steps.build_train_step(tcfg, ttrain, tshape, "cpu")(
        tstate, SyntheticLMData(tcfg, tshape, seed=4).batch_at(0))

    for k in ("loss", "nll", "aux", "lr"):
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), abs=TOL), k
    assert float(tmet["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=TOL)
    assert int(tnew.step) == int(jnew.step) == 1
    assert int(tnew.opt.count) == int(jnew.opt.count) == 1

    kept = total = 0
    for g, jp, tp, jm, tm, jv, tv, jr, tr in zip(
            g_ref, jax.tree.leaves(jnew.params), tree.leaves(tnew.params),
            jax.tree.leaves(jnew.opt.m), tree.leaves(tnew.opt.m),
            jax.tree.leaves(jnew.opt.v), tree.leaves(tnew.opt.v),
            jax.tree.leaves(jnew.grad_residual) if compression else
            [None] * len(g_ref),
            tree.leaves(tnew.grad_residual) if compression else
            [None] * len(g_ref)):
        mask = np.abs(g) > FLOOR * np.sqrt(np.mean(np.square(g)))
        if compression:      # away from the int8 rounding boundaries
            lsb = max(float(np.abs(g).max()), 1e-12) / 127.0
            mask &= np.abs(np.abs(g / lsb) % 1.0 - 0.5) > 0.01
        kept, total = kept + int(mask.sum()), total + mask.size
        pairs = [(tp, jp), (tm, jm), (tv, jv)]
        if compression:
            pairs.append((tr, jr))
        for mine, theirs in pairs:
            np.testing.assert_allclose(mine.detach().numpy()[mask],
                                       np.asarray(theirs)[mask],
                                       atol=TOL, rtol=TOL)
    assert kept > 0.8 * total     # the masks leave most elements in


def test_train_step_loss_decreases():
    """Integration: 8 steps on structured synthetic data reduce the loss."""
    cfg = registry.get_smoke("qwen2-72b")
    shape = InputShape("train_4k", 32, 4, "train")
    train = steps.TrainSpec(peak_lr=1e-3, warmup_steps=5, total_steps=100)
    step = steps.build_train_step(cfg, train, shape, "cpu")
    state = steps.init_train_state(cfg, 0, train, "cpu")
    data = SyntheticLMData(cfg, shape)
    losses = []
    for i in range(8):
        state, m = step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert int(state.step) == 8


def test_train_step_leaves_no_tensor_in_a_reference_cycle():
    """Nothing of a step survives it but the state: no reference cycle
    keeps the gradients (a param-sized tree, 2.4 GB at internvl2-1b's
    width) alive until the next gc pass."""
    cfg = registry.get_smoke("internvl2-1b")
    shape = InputShape("t", 8, 2, "train")
    train = steps.TrainSpec(grad_compression=True)
    step = steps.build_train_step(cfg, train, shape, "cpu")
    state = steps.init_train_state(cfg, 0, train, "cpu")
    data = SyntheticLMData(cfg, shape)
    state, _ = step(state, data.batch_at(0))   # first use: lazy imports
    gc.collect()
    gc.disable()
    try:
        state, _ = step(state, data.batch_at(1))
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert cyclic == []


def test_microbatches_must_divide_the_batch():
    cfg = dataclasses.replace(registry.get_smoke("glm4-9b"),
                              microbatches=(("t", 3),))
    with pytest.raises(ValueError, match="microbatches"):
        steps.build_train_step(cfg, steps.TrainSpec(),
                               InputShape("t", 8, 4, "train"), "cpu")


# --- remat ---------------------------------------------------------------------


def _grads(cfg, params, batch):
    loss, _ = lm.loss_fn(params, cfg, batch)
    return torch.autograd.grad(loss, tree.leaves(params))


@pytest.mark.parametrize("mode", ["zero_buffer", "full"])
@pytest.mark.parametrize("name", ["gemma2-9b", "internvl2-1b",
                                  "qwen2-moe-a2.7b", "recurrentgemma-9b",
                                  "rwkv6-3b", "hubert-xlarge"])
def test_remat_modes_give_equal_gradients(name, mode):
    cfg = dataclasses.replace(registry.get_smoke(name), dtype="float32",
                              remat="none")
    params = lm.init_params(cfg, 3, "cpu")
    for p in tree.leaves(params):
        p.requires_grad_(True)
    batch = make_batch(cfg, 2, 16, seed=1)
    want = _grads(cfg, params, batch)
    got = _grads(dataclasses.replace(cfg, remat=mode), params, batch)
    for (path, _), g, w in zip(tree.flatten_with_path(params), got, want):
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        assert rel < 1e-6, (path, rel)


def _saved_shapes(cfg, params, batch):
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = lm.loss_fn(params, cfg, batch)
    loss.backward()
    return shapes


@pytest.mark.parametrize("attn_impl", ["reference", "fused"])
@pytest.mark.parametrize("name", ["gemma2-9b", "qwen3-14b"])
def test_zero_buffer_and_full_store_no_hidden_and_no_scores(name, attn_impl):
    t = 24
    base = dataclasses.replace(registry.get_smoke(name), dtype="float32",
                               attn_impl=attn_impl, block_impl="reference")
    assert not base.tail_kinds and base.d_ff not in (t, base.d_model)
    params = lm.init_params(base, 0, "cpu")
    for p in tree.leaves(params):
        p.requires_grad_(True)
    batch = make_batch(base, 2, t)

    def stored(mode):
        shapes = _saved_shapes(dataclasses.replace(base, remat=mode), params,
                               batch)
        return ({s for s in shapes if s and s[-1] == base.d_ff},
                {s for s in shapes if s[-2:] == (t, t)})

    hidden, scores = stored("none")
    assert (2, t, base.d_ff) in hidden and scores
    for mode in ("zero_buffer", "full"):
        assert stored(mode) == (set(), set()), mode


def test_unknown_remat_mode_raises():
    with pytest.raises(ValueError, match="dots"):
        ffnlib.apply_remat(lambda x: x, "dots")
    with pytest.raises(ValueError, match="remat"):
        ffnlib.remat_core(lambda x: x, "everything")
    cfg = dataclasses.replace(registry.get_smoke("glm4-9b"), remat="dots")
    params = lm.init_params(cfg, 0, "cpu", torch.float32)
    with pytest.raises(ValueError, match="dots"):
        lm.loss_fn(params, cfg, make_batch(cfg, 1, 4))
