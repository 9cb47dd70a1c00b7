"""The port's training forward, loss and gradients against the JAX package
on the CPU, for the smoke config of each of the ten archs.

The same f32 weights (the reference's, carried over with
``params_from_numpy``) and the same numpy batch go to ``repro.models.lm``
and ``repro_torch.models.lm``:

* ``loss_fn`` within 1e-4 of the reference's (the model tests' logits
  bound), and its ``nll`` and ``aux`` metrics with it: that covers the MoE
  aux loss summed over the layers (qwen2-moe, llama4), the vision prefix
  cut from the logits (internvl2), the per-frame loss of the encoder
  (hubert) and the masked padded vocab;
* every parameter's gradient within a relative norm of 1e-4 of the
  reference's (``jax.grad`` of its ``loss_fn``). Both compute the same f32
  expressions; their sums run in other orders (XLA's and torch's matmul and
  reduction orders, the attention's chunking), which the backward pass
  compounds over the layers: the worst leaf measured 6.8e-6 (gemma2's
  ``wk``), so 1e-4 leaves a 15x margin and still catches a missing or
  mis-scaled term.

The reference trains with ``attn_impl="fused"`` (its Pallas kernels have no
gradient); the port runs its three attention disciplines against it, the
``kernel`` one being the flash kernel's plain version on a CPU tensor.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.models import lm
from tests.conftest import make_batch

ARCHS = registry.ARCH_NAMES
LOSS_TOL = 1e-4
GRAD_REL = 1e-4


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The JAX f32 smoke weights (numpy), a batch, and the reference's
    loss, metrics and gradients (numpy leaves, JAX order)."""
    cfg = dataclasses.replace(jreg.get_smoke(name), dtype="float32")
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    batch = make_batch(cfg, 2, 16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, met), grads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, cfg, jb), has_aux=True)(params)
    return (jax.tree.map(np.asarray, params), batch,
            {k: float(v) for k, v in met.items()},
            [np.asarray(g) for g in jax.tree.leaves(grads)])


def _port(name, attn_impl, block_impl):
    cfg = dataclasses.replace(registry.get_smoke(name), dtype="float32",
                              attn_impl=attn_impl, block_impl=block_impl)
    tree_np, batch, _, _ = _reference(name)
    params = lm.params_from_numpy(tree_np, cfg, device="cpu")
    for p in tree.leaves(params):
        p.requires_grad_(True)
    return cfg, params, batch


@pytest.mark.parametrize("impls", [("fused", "fused"), ("kernel", "fused"),
                                   ("reference", "reference")])
@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_jax(name, impls):
    cfg, params, batch = _port(name, *impls)
    _, _, want, want_grads = _reference(name)
    loss, met = lm.loss_fn(params, cfg, batch)
    assert abs(float(loss.detach()) - want["loss"]) < LOSS_TOL
    assert abs(float(met["nll"]) - want["nll"]) < LOSS_TOL
    assert abs(float(met["aux"]) - want["aux"]) < 1e-6
    if cfg.moe is not None:
        assert float(met["aux"]) > 0.0
    leaves = tree.leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert len(grads) == len(want_grads)
    for (path, _), g, w in zip(tree.flatten_with_path(params), grads,
                               want_grads):
        assert g is not None, f"{path}: no gradient"
        g = g.numpy()
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel < GRAD_REL, (path, rel)


@pytest.mark.parametrize("name", ARCHS)
def test_smoke_forward_and_train_step(name):
    """The smoke config as it trains (bf16 compute on f32 masters): the
    logits' shape, finite loss and gradients, and a gradient for every
    parameter."""
    cfg = registry.get_smoke(name)
    params = lm.init_params(cfg, 0, "cpu", torch.float32)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    batch = make_batch(cfg, 2, 16)
    logits, aux = lm.forward_aux(params, cfg, tokens=batch.get("tokens"),
                                 patches=batch.get("patches"),
                                 frames=batch.get("frames"))
    t_exp = 16 + (cfg.n_patches if cfg.frontend == "vision" else 0)
    assert logits.shape == (2, t_exp, cfg.vocab_padded())
    assert logits.dtype == torch.float32 and aux.shape == ()
    assert bool(torch.isfinite(logits).all())
    loss, _ = lm.loss_fn(params, cfg, batch)
    assert bool(torch.isfinite(loss))
    grads = torch.autograd.grad(loss, tree.leaves(params), allow_unused=True)
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads)


@pytest.mark.parametrize("name", ARCHS)
def test_param_count_matches_analytic(name):
    cfg = registry.get_smoke(name)
    params = lm.init_params(cfg, 0, "cpu", torch.float32)
    assert sum(p.numel() for p in tree.leaves(params)) == cfg.param_count()
    abstract = lm.abstract_params(cfg)
    assert [(k, tuple(v.shape), v.dtype) for k, v in
            tree.flatten_with_path(abstract)] == \
        [(k, tuple(v.shape), v.dtype) for k, v in
         tree.flatten_with_path(params)]
    assert all(v.device.type == "meta" for v in tree.leaves(abstract))


def test_full_config_param_count_on_the_meta_device():
    """internvl2-1b at its published widths: 635,188,096 parameters, shaped
    without storage."""
    cfg = registry.get("internvl2-1b")
    n = sum(p.numel() for p in tree.leaves(lm.abstract_params(cfg)))
    assert n == cfg.param_count() == 635_188_096


def test_forward_is_forward_aux_logits_and_needs_no_grad():
    cfg = dataclasses.replace(registry.get_smoke("qwen2-moe-a2.7b"),
                              dtype="float32")
    params = lm.init_params(cfg, 1, "cpu")
    tokens = make_batch(cfg, 2, 8)["tokens"]
    with torch.no_grad():
        logits = lm.forward(params, cfg, tokens)
        pair = lm.forward_aux(params, cfg, tokens)
    assert torch.equal(logits, pair[0])
    assert float(pair[1]) > 0.0
