"""The port's sharding rules and activation placements against the
reference's (``repro.runtime.sharding``, ``repro.runtime.actctx``).

The reference side is built on an ``AbstractMesh`` through the installed
jax's API (``AbstractMesh(axis_sizes, axis_names)``); the port's rules take
the same axis sizes. Specs compare one to one with ``tuple(PartitionSpec)``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro.configs import registry as rreg
from repro.models import lm as rlm
from repro.runtime import sharding as rshd
from repro.runtime import steps as rsteps
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.launch.mesh import fake_process_group, make_mesh
from repro_torch.models import lm
from repro_torch.runtime import actctx
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps

SIZES = {"single": {"data": 16, "model": 16},
         "multi": {"pod": 2, "data": 16, "model": 16}}


def _abstract_mesh(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _ref_specs(spec_tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, P))
    return {rshd._path_str(p): tuple(s) for p, s in flat}


def _port_specs(spec_tree, like):
    return {p: shd.spec_at(spec_tree, p)
            for p, _ in tree.flatten_with_path(like)}


@pytest.mark.parametrize("mesh", sorted(SIZES))
@pytest.mark.parametrize("name", registry.ARCH_NAMES)
def test_param_specs_equal_the_reference(name, mesh):
    sizes = SIZES[mesh]
    ra = rlm.abstract_params(rreg.get(name), dtype=jnp.bfloat16)
    want = _ref_specs(rshd.param_specs(ra, _abstract_mesh(sizes)))
    pa = lm.abstract_params(registry.get(name), torch.bfloat16)
    got = _port_specs(shd.param_specs(pa, sizes), pa)
    assert got == want


def _cell_id(c):
    return f"{c.arch}/{c.shape.name}"


@pytest.mark.parametrize("mesh", sorted(SIZES))
@pytest.mark.parametrize("cell", registry.runnable_cells(), ids=_cell_id)
def test_batch_and_cache_specs_equal_the_reference(cell, mesh):
    sizes = SIZES[mesh]
    am = _abstract_mesh(sizes)
    rcfg, cfg, shape = rreg.get(cell.arch), registry.get(cell.arch), \
        cell.shape
    if shape.kind == "decode":
        rcache = rlm.abstract_cache(rcfg, shape.global_batch, shape.seq_len)
        pcache, token, _ = steps.decode_inputs(cfg, shape)
        assert _port_specs(shd.cache_specs(cfg, sizes, pcache), pcache) == \
            _ref_specs(rshd.cache_specs(rcfg, am, rcache))
        rtok = jax.ShapeDtypeStruct((shape.global_batch,), jnp.int32)
        assert shd.batch_specs(cfg, sizes, {"t": token})["t"] == \
            tuple(rshd.batch_specs(rcfg, am, {"t": rtok})["t"])
        return
    rbatch = rsteps.abstract_batch(rcfg, shape)
    pbatch = steps.abstract_batch(cfg, shape)
    assert {k: tuple(v.shape) for k, v in pbatch.items()} == \
        {k: tuple(v.shape) for k, v in rbatch.items()}
    assert _port_specs(shd.batch_specs(cfg, sizes, pbatch), pbatch) == \
        _ref_specs(rshd.batch_specs(rcfg, am, rbatch))
    if shape.kind == "prefill" and cfg.causal:
        rcache = rlm.abstract_cache(rcfg, shape.global_batch, shape.seq_len)
        pcache = lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                               device=torch.device("meta"))
        assert _port_specs(shd.cache_specs(cfg, sizes, pcache), pcache) == \
            _ref_specs(rshd.cache_specs(rcfg, am, rcache))


# --- the reference's own cases (tests/test_sharding.py), on the port ------

MESH = SIZES["single"]
MESH_MP = SIZES["multi"]


def _explain(cfg):
    return shd.explain(lm.abstract_params(cfg, torch.bfloat16), MESH)


def test_ffn_weights_are_tp_sharded_fsdp_sharded():
    ex = _explain(registry.get("qwen2-72b"))
    assert ex["units/0/sub2/w_gate"] == str((None, "data", "model"))
    assert ex["units/0/sub2/w_down"] == str((None, "model", "data"))
    assert ex["units/0/sub1/wq"] == str((None, "data", "model", None))


def test_odd_heads_replicate_unless_padded():
    # unpadded 40 heads % 16 != 0 -> attention replicated over model
    ex = _explain(dataclasses.replace(registry.get("qwen3-14b"), head_pad=0))
    assert ex["units/0/sub1/wq"] == str((None, "data", None, None))
    assert ex["units/0/sub2/w_gate"] == str((None, "data", "model"))
    # the zero-padded heads: 48 % 16 == 0 -> shards
    ex2 = _explain(registry.get("qwen3-14b"))
    assert ex2["units/0/sub1/wq"] == str((None, "data", "model", None))


def test_moe_experts_shard_over_model():
    ex = _explain(registry.get("llama4-scout-17b-a16e"))
    assert ex["units/0/sub2/w_up"] == str((None, "model", "data", None))


@pytest.mark.parametrize("n_e,n_c", [(3, 6), (8, 5), (2, 16), (5, 3)])
def test_moe_windows_that_do_not_divide_sum_to_the_whole(n_e, n_c):
    """The sharded MoE's windows: experts and capacity slots in windows of
    a rounded-up size, the last ones short or empty (qwen2-moe's 60
    experts and 87,384 slots over 16 ranks). Their contributions add up to
    the whole dispatch."""
    from repro_torch.models import moe
    cfg = dataclasses.replace(registry.get_smoke("qwen2-moe-a2.7b"),
                              dtype="float32")
    m = cfg.moe
    p = lm.init_params(cfg, 0, "cpu", torch.float32)
    p = {k: v[0] for k, v in p["units"]["0"]["sub2"].items()
         if k != "shared"}
    xf = torch.randn(48, cfg.d_model,
                     generator=torch.Generator().manual_seed(1))
    _, gates, ids = moe._route(xf, p, m)
    cap = moe.capacity(48, m)
    w = {k: p[k] for k in moe._EXPERTS if k in p}
    whole = moe._routed(xf, w, gates, ids, cfg, 0, 0, cap)
    total = torch.zeros_like(whole)
    # one window past the end on each axis: empty (a rank left over)
    for e0 in range(0, -(-m.n_experts // n_e) * n_e + n_e, n_e):
        for c0 in range(0, -(-cap // n_c) * n_c + n_c, n_c):
            wl = {k: v[e0:e0 + n_e] for k, v in w.items()}
            total += moe._routed(xf, wl, gates, ids, cfg, e0, c0,
                                 max(0, min(n_c, cap - c0)))
    assert torch.allclose(total, whole, rtol=1e-5, atol=1e-6)
    assert whole.abs().max() > 0


def test_weights_replicate_across_pods():
    pa = lm.abstract_params(registry.get("glm4-9b"), torch.bfloat16)
    for spec in _port_specs(shd.param_specs(pa, MESH_MP), pa).values():
        assert "pod" not in str(spec)


def test_param_memory_adds_up_for_72b():
    """FSDP x TP on 256 devices keeps a 72B model + Adam small per device."""
    pa = lm.abstract_params(registry.get("qwen2-72b"), torch.float32)
    specs = shd.param_specs(pa, MESH)
    per_device = 0
    for path, leaf in tree.flatten_with_path(pa):
        shards = 1
        for ax in shd.spec_at(specs, path):
            shards *= shd.mesh_axis_size(MESH, ax)
        per_device += leaf.numel() * 4 / shards
    assert 3 * per_device < 6 * 2 ** 30        # params + m + v (f32)


def test_batch_specs_shard_leading_dim():
    cfg = registry.get("glm4-9b")
    batch = {"tokens": torch.empty((256, 4096), dtype=torch.int32,
                                   device="meta")}
    assert shd.batch_specs(cfg, MESH, batch)["tokens"] == ("data",)
    assert shd.batch_specs(cfg, MESH_MP, batch)["tokens"] == \
        (("pod", "data"),)


# --- placements, constrain, the grad dtype guard ----------------------------


@pytest.fixture(scope="module")
def mesh_2x2x2():
    with fake_process_group(8):
        yield make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")


def test_placements_of_a_spec(mesh_2x2x2):
    m = mesh_2x2x2
    assert shd.placements((("pod", "data"), "model"), m) == \
        [Shard(0), Shard(0), Shard(1)]
    assert shd.placements((None, "data"), m) == \
        [Replicate(), Shard(1), Replicate()]
    assert shd.placements((None, "model"), {"data": 4, "model": 1}) == \
        [Replicate(), Replicate()]         # a 1-rank axis holds it whole
    with pytest.raises(ValueError, match="uneven"):
        shd.placements(("data",), m, (3,))


def test_distribute_keeps_each_ranks_shard(mesh_2x2x2):
    w = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    d = shd.distribute({"w": w}, {"w": ("data", "model")}, mesh_2x2x2)["w"]
    assert d.placements == (Replicate(), Shard(0), Shard(1))
    assert torch.equal(d.to_local(), w[:4, :3])        # rank 0's block


def test_constrain_is_a_no_op_off_the_mesh(mesh_2x2x2):
    x = torch.ones(4, 6)
    assert actctx.constrain(x, "B", None) is x          # a plain tensor
    d = distribute_tensor(x, mesh_2x2x2, [Replicate()] * 3,
                          src_data_rank=None)
    assert actctx.constrain(d, "B", None) is d          # no context
    with actctx.activation_mesh(mesh_2x2x2):
        assert actctx.constrain(x, "B", None) is x


def test_constrain_resolves_placeholders(mesh_2x2x2):
    m = mesh_2x2x2
    d = distribute_tensor(torch.ones(4, 6, 8), m, [Replicate()] * 3,
                          src_data_rank=None)
    with actctx.activation_mesh(m):
        assert actctx.constrain(d, "B", None, "M").placements == \
            (Shard(0), Shard(0), Shard(2))
        # "D" is data alone; a dim that does not divide stays whole
        assert actctx.constrain(d, None, "D", None).placements == \
            (Replicate(), Shard(1), Replicate())
        odd = distribute_tensor(torch.ones(3, 5), m, [Replicate()] * 3,
                                src_data_rank=None)
        assert actctx.constrain(odd, "B", "M").placements == \
            (Replicate(),) * 3


def test_grad_dtype_guard_casts_the_cotangent():
    x = torch.ones(3, dtype=torch.bfloat16, requires_grad=True)
    y = actctx.grad_dtype_guard(x)
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad(y.float().sum() * 1.5, x)
    assert g.dtype == torch.bfloat16


def test_port_imports_without_jax(tmp_path):
    """No module of the port imports jax or the reference package."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = "
            "None\nimport repro_torch.launch.dryrun, "
            "repro_torch.roofline.report, repro_torch.roofline.breakdown, "
            "repro_torch.launch.train, repro_torch.checkpoint.manager")
    import os
    env = {**os.environ, "PYTHONPATH": os.path.join(
        os.path.dirname(__file__), "..", "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
