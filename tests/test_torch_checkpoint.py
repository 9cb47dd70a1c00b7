"""The port's checkpoints (``repro_torch.checkpoint``): the cases of
tests/test_checkpoint.py, a train state written by either package restored
bit-equal by the other (same ``step_<n>/arrays.npz`` layout and keys), and
the async save taking its copy before the caller's next in-place update.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import registry as jreg
from repro.runtime import steps as jsteps
from repro_torch import tree
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import registry
from repro_torch.models import lm
from repro_torch.runtime import steps


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(
                           rng.standard_normal((4, 4)).astype(np.float32)),
                       "b": torch.from_numpy(
                           rng.standard_normal(4).astype(np.float32))},
            "step": torch.tensor(7, dtype=torch.int32)}


def _template():
    return {"params": {"w": torch.empty(4, 4, device="meta"),
                       "b": torch.empty(4, device="meta")},
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t)
    r = restore_checkpoint(str(tmp_path), _template(), device="cpu")
    assert torch.equal(r["params"]["w"], t["params"]["w"])
    assert int(r["step"]) == 7 and r["step"].dtype == torch.int32
    meta = json.loads((tmp_path / "step_00000007" / "meta.json").read_text())
    assert meta == {"step": 7, "n_arrays": 3}
    assert (tmp_path / "LATEST").read_text() == "7"


def test_latest_step_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), period=1, keep=2)
    for s in (1, 2, 3, 4):
        mgr.maybe_save(s, _tree(s), force=True)
        mgr.wait()
    assert latest_step(str(tmp_path)) == 4
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]      # retention
    r = mgr.restore_latest(_tree(), device="cpu")
    assert torch.equal(r["params"]["w"], _tree(4)["params"]["w"])


def test_atomicity_tmp_dirs_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree(1))
    os.makedirs(tmp_path / "step_00000002.tmp")   # a crash mid-save
    assert latest_step(str(tmp_path)) == 1
    r = restore_checkpoint(str(tmp_path), _template(), device="cpu")
    assert int(r["step"]) == 7
    # a later save of the same step clears its stale temp dir
    save_checkpoint(str(tmp_path), 2, _tree(2))
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000001",
                                            "step_00000002"]


def test_restore_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    bad = _template()
    bad["params"]["w"] = torch.empty(2, 2, device="meta")
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), bad, device="cpu")
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), bad, device="cpu")


def test_async_save_overlaps_and_waits(tmp_path):
    mgr = CheckpointManager(str(tmp_path), period=2, keep=5)
    assert not mgr.maybe_save(1, _tree())      # not on period
    assert mgr.maybe_save(2, _tree())
    mgr.wait()
    assert latest_step(str(tmp_path)) == 2


def test_async_save_copies_before_the_next_in_place_step(tmp_path):
    """The write thread must never see the caller's tensors: a step that
    updates them in place right after ``maybe_save`` returns does not reach
    the checkpoint."""
    t = _tree(3)
    want = {k: v.clone() for k, v in t["params"].items()}
    mgr = CheckpointManager(str(tmp_path), period=1, keep=2)
    assert mgr.maybe_save(1, t)
    for v in t["params"].values():
        v.add_(1.0)                           # the next optimizer step
    mgr.wait()
    r = restore_checkpoint(str(tmp_path), _template(), device="cpu")
    for k in want:
        assert torch.equal(r["params"][k], want[k])


def test_restore_keeps_the_template_requires_grad(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    tpl = _template()
    tpl["params"]["w"].requires_grad_(True)
    r = restore_checkpoint(str(tmp_path), tpl, device="cpu")
    assert r["params"]["w"].requires_grad
    assert not r["params"]["b"].requires_grad


def test_async_write_error_surfaces_on_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    mgr = CheckpointManager(str(blocker), period=1)
    assert mgr.maybe_save(1, _tree())
    with pytest.raises(OSError):
        mgr.wait()


# --- across the packages -------------------------------------------------------


ARCH = "qwen2-moe-a2.7b"
TRAIN_J = jsteps.TrainSpec(grad_compression=True)
TRAIN_T = steps.TrainSpec(grad_compression=True)


def _port_state(seed):
    """A port train state of the smoke config with every leaf random (f32
    params, moments and residuals; int32 count and step)."""
    cfg = registry.get_smoke(ARCH)
    state = steps.train_state(lm.init_params(cfg, 0, "cpu", torch.float32),
                              TRAIN_T)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for leaf in tree.leaves(state):
            if leaf.dtype == torch.float32:
                leaf.copy_(torch.from_numpy(
                    rng.standard_normal(tuple(leaf.shape)).astype(np.float32)))
    state.opt.count = torch.tensor(11, dtype=torch.int32)
    state.step = torch.tensor(11, dtype=torch.int32)
    return state


def test_checkpoint_keys_equal_the_reference(tmp_path):
    jcfg = jreg.get_smoke(ARCH)
    j_save(str(tmp_path / "j"), 0,
           jsteps.init_train_state(jcfg, jax.random.PRNGKey(0), TRAIN_J))
    save_checkpoint(str(tmp_path / "t"), 0, _port_state(0))
    with np.load(tmp_path / "j" / "step_00000000" / "arrays.npz") as a, \
            np.load(tmp_path / "t" / "step_00000000" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        assert {"1/2", "2"} <= set(a.files)
        assert any(k.startswith("3/units/") for k in a.files)


def test_jax_checkpoint_restores_in_the_port_bit_equal(tmp_path):
    jcfg = jreg.get_smoke(ARCH)
    jstate = jsteps.init_train_state(jcfg, jax.random.PRNGKey(3), TRAIN_J)
    jstate = dataclasses.replace(
        jstate, opt=dataclasses.replace(
            jstate.opt, m=jax.tree.map(lambda p: p * 0.5, jstate.params)),
        step=jstate.step + 5)
    j_save(str(tmp_path), 5, jstate)
    tpl = steps.abstract_train_state(registry.get_smoke(ARCH), TRAIN_T)
    got = restore_checkpoint(str(tmp_path), tpl, device="cpu")
    want = [np.asarray(x) for x in jax.tree.leaves(jstate)]
    mine = tree.leaves(got)
    assert len(mine) == len(want)
    for g, w in zip(mine, want):
        assert g.detach().numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.detach().numpy(), w)
    assert int(got.step) == 5
    assert all(p.requires_grad for p in tree.leaves(got.params))


def test_port_checkpoint_restores_in_jax_bit_equal(tmp_path):
    state = _port_state(7)
    save_checkpoint(str(tmp_path), 11, state)
    abstract = jsteps.abstract_train_state(jreg.get_smoke(ARCH), TRAIN_J)
    got = [np.asarray(x) for x in
           jax.tree.leaves(j_restore(str(tmp_path), abstract))]
    want = [leaf.detach().numpy() for leaf in tree.leaves(state)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert int(got[-len(tree.leaves(state.grad_residual)) - 1]) == 11
