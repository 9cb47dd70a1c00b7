"""The port's cost model and roofline (``repro_torch.roofline``) against
analytic counts and against the reference's HLO walker.

* the reference's own cases (tests/test_roofline.py) on the port: a single
  matmul exact, loops multiplied (``op_cost.trips``), the ring model on a
  fake group's all-gather, all-reduce and reduce-scatter;
* a DTensor product counted once, at its local shape;
* each hand kernel's custom op: its flop formula equal to the analytic
  count, and ``torch.library.opcheck`` on the CPU;
* smoke-size prefill, decode and train FLOPs on a (1, 1) mesh against the
  reference's ``hlo_cost`` of its own lowered step;
* one full-size dry-run cell, and ``report.table`` equal to the
  reference's on the same records.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.debug import CommDebugMode

from repro.configs import registry as rreg
from repro.configs.base import SHAPES_BY_NAME
from repro.configs.base import InputShape as RInputShape
from repro.launch.mesh import make_mesh as ref_make_mesh
from repro.models import lm as rlm
from repro.roofline import breakdown as rbreakdown
from repro.roofline import report as rreport
from repro.roofline.analysis import collective_stats as ref_collective_stats
from repro.roofline.hlo_cost import hlo_cost
from repro.runtime import sharding as rshd
from repro.runtime import steps as rsteps
from repro_torch.configs import registry
from repro_torch.configs.base import InputShape
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import fused_ffn as tff
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_process_group, make_mesh
from repro_torch.models import lm
from repro_torch.roofline import analysis, op_cost, report
from repro_torch.roofline.op_cost import CollectiveRecord, OpCostMode
from repro_torch.runtime import steps


def test_single_matmul_exact():
    m, k, n = 128, 256, 64
    a, b = torch.ones(m, k), torch.ones(k, n)
    with OpCostMode() as mode:
        a @ b
    assert mode.flops == 2 * m * k * n
    assert mode.bytes == 4 * (m * k + k * n + m * n)


def test_loop_multiplies_by_its_trips():
    """A loop run once under ``trips(n)`` counts as n trips, as the
    reference's walker scales a while body by its trip count; nested trips
    multiply."""
    d = 64
    x, w = torch.ones(d, d), torch.ones(d, d) * 1e-3
    with OpCostMode() as run:
        c = x
        for _ in range(10):
            c = torch.tanh(c @ w)
    with OpCostMode() as once:
        with op_cost.trips(10):
            torch.tanh(x @ w)
    assert run.flops == once.flops == 10 * (2 * d ** 3 + d * d)
    assert run.transcendental == once.transcendental == 10 * d * d
    with OpCostMode() as nested:
        with op_cost.trips(4):
            c = x
            with op_cost.trips(3):
                c = c @ w
    assert nested.flops == 12 * 2 * d ** 3


def test_collective_stats_parses_ring_model():
    """The reference's case: an all-reduce of a (128, 128) f32 over groups
    of 8, both packages' ring models."""
    text = """
ENTRY %main (a: f32[128,128]) -> f32[128,128] {
  %a = f32[128,128]{1,0} parameter(0)
  ROOT %ar = f32[128,128]{1,0} all-reduce(%a), replica_groups=[4,8]<=[32], to_apply=%sum
}
"""
    want = 2 * (7 / 8) * 128 * 128 * 4
    assert ref_collective_stats(text, 32).wire_bytes["all-reduce"] == \
        pytest.approx(want)
    st = analysis.collective_stats(
        [CollectiveRecord("all-reduce", 128 * 128 * 4, 128 * 128 * 4, 8,
                          "g")])
    assert st.wire_bytes["all-reduce"] == pytest.approx(want)
    assert st.counts["all-reduce"] == 1


@pytest.fixture
def mesh_16x16():
    with fake_process_group(256):
        yield make_mesh((16, 16), ("data", "model"), "cpu")


def test_ring_model_on_a_fake_groups_collectives(mesh_16x16):
    """DTensor's all-gather, all-reduce and reduce-scatter over the model
    axis of 16, recorded by the mode (as CommDebugMode counts them), each
    at its ring-model wire bytes."""
    m = mesh_16x16
    n = 128 * 128 * 4                    # the global f32 tensor's bytes
    with FakeTensorMode():
        shard = distribute_tensor(torch.empty(128, 128), m,
                                  [Replicate(), Shard(0)], src_data_rank=None)
        part = shard.redistribute(m, [Replicate(), Replicate()]).to_local()
        part = DTensor.from_local(part, m, [Replicate(), Partial()],
                                  run_check=False)
        with OpCostMode() as mode, CommDebugMode() as comm:
            shard.redistribute(m, [Replicate(), Replicate()])
            part.redistribute(m, [Replicate(), Replicate()])
            part.redistribute(m, [Replicate(), Shard(0)])
    st = analysis.collective_stats(mode.collectives)
    assert st.counts == {"all-gather": 1, "all-reduce": 1,
                         "reduce-scatter": 1}
    assert sum(comm.get_comm_counts().values()) == 3
    assert st.wire_bytes["all-gather"] == pytest.approx(15 / 16 * n)
    assert st.wire_bytes["all-reduce"] == pytest.approx(2 * 15 / 16 * n)
    assert st.wire_bytes["reduce-scatter"] == pytest.approx(15 / 16 * n)
    assert {r.group_size for r in mode.collectives} == {16}


def test_live_bytes_hold_a_gathered_tensor_and_its_views(mesh_16x16):
    """The live estimate keeps an all-gathered tensor, which the caller
    holds through the collective's wait, and a view's base, until the last
    alias goes; gathers held at once each count."""
    full = 4096 * 1024 * 2
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(4096, 1024, dtype=torch.bfloat16),
                              mesh_16x16, [Shard(0), Replicate()],
                              src_data_rank=None)
        with OpCostMode() as mode:
            g = x.redistribute(mesh_16x16, [Replicate(), Replicate()])
            assert mode.live == full
            v = g.to_local()[:16]
            del g
            assert mode.live == full               # the view holds it
            del v
            assert mode.live == 0
            held = [x.redistribute(mesh_16x16, [Replicate(), Replicate()])
                    for _ in range(4)]
            assert mode.live == 4 * full
            del held
            assert mode.live == 0


def test_live_estimate_frees_each_checkpoints_recompute():
    """Eight checkpointed units of an f32 norm under a backward: each
    unit's recomputed tensors are live while its own backward runs, so at
    the peak at most two units' f32 copies of x are (the one being
    differentiated, and the first unit's, which no gradient asked for
    unpacks). A count that held a view's base object for as long as the
    view would count every unit's: the recompute's detached copies sit in
    their base's own graph."""
    def unit(x, s):
        x32 = x.float()
        y = x32 * torch.rsqrt(torch.mean(torch.square(x32), dim=-1,
                                         keepdim=True) + 1e-6)
        return (y * s).to(x.dtype)

    x0 = torch.randn(8, 64, 128, dtype=torch.bfloat16, requires_grad=True)
    scales = [torch.randn(128, requires_grad=True) for _ in range(8)]
    copy = "aten._to_copy (8, 64, 128) float32"
    with OpCostMode() as mode:
        x = x0
        for s in scales:
            x = torch.utils.checkpoint.checkpoint(unit, x, s,
                                                  use_reentrant=False)
        torch.autograd.grad(x.float().sum(), scales)
    assert 1 <= mode.peak_live_by[copy][1] <= 2


def test_peak_live_record_names_ops_and_sums_to_the_peak():
    """``peak_live_by``: what was live at the peak, by op, output shape and
    dtype, each entry (bytes, tensors), the bytes summing to
    ``peak_live_bytes``; the largest entry here is the product's f32
    output, the peak's while the reduction runs."""
    a, b = torch.ones(256, 512), torch.ones(512, 1024)
    with OpCostMode() as mode:
        c = a @ b                   # 1 MiB
        d = torch.tanh(c)           # and 1 MiB more: the peak
        del c
        d.sum()
    record = mode.peak_live_by
    assert sum(n for n, _ in record.values()) == mode.peak_live_bytes
    top = max(record, key=lambda k: record[k][0])
    assert top in ("aten.mm (256, 1024) float32",
                   "aten.tanh (256, 1024) float32")
    assert record[top] == (256 * 1024 * 4, 1)
    assert mode.peak_live_bytes == 2 * 256 * 1024 * 4


def _smoke_train_mode(name, t=1024, b=2):
    """One smoke-width train step of ``name`` at T ``t`` on fake tensors
    under ``OpCostMode``, as the dry run lowers a cell (the kernel routes;
    a (1, 1) mesh)."""
    import dataclasses
    cfg = dataclasses.replace(registry.get_smoke(name), attn_impl="kernel",
                              block_impl="fused")
    with fake_process_group(1):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        with FakeTensorMode():
            mode, _, _ = dryrun.lower_cell(
                cfg, InputShape("train_probe", t, b, "train"), mesh,
                torch.device("cpu"))
    return mode


def _old_paths(monkeypatch):
    """The two training paths before: the WKV chunks not checkpointed
    (each chunk's (B, L, L, H, K) tensors kept for the backward) and the
    flash backward as autograd of the plain version ((B H, T, T) f32
    scores, softcap, mask and softmax)."""
    from repro_torch.core import fused_ffn as ffnlib
    from repro_torch.kernels import ref
    checkpointed = ffnlib.checkpointed
    monkeypatch.setattr(ffnlib, "checkpointed", lambda fn: (
        fn if fn.__name__ == "chunk_body" else checkpointed(fn)))
    monkeypatch.setattr(ref, "mha_grads_blocked",
                        lambda q, k, v, go, block, **kw: ref.plain_grads(
                            lambda *a: ref.mha_ref(*a, **kw), (q, k, v),
                            (True,) * 3, go))


@pytest.mark.parametrize("name", ["rwkv6-3b", "gemma2-9b"])
def test_smoke_train_peak_live_falls_below_the_old_paths(name, monkeypatch):
    """A smoke train step's peak live bytes at T 1024, B 2, against the
    same step through the paths before (``_old_paths``), under the same
    estimate: lower; and the old peak's own largest entries are the
    tensors the change removes (rwkv6: every chunk's 5-dim WKV tensors,
    gemma2: (B H, T, T) f32 scores)."""
    new = _smoke_train_mode(name)
    _old_paths(monkeypatch)
    old = _smoke_train_mode(name)
    assert new.peak_live_bytes < old.peak_live_bytes

    def by_rank(record):
        return sorted(record, key=lambda k: -record[k][0])

    old_top, new_rec = by_rank(old.peak_live_by)[:2], new.peak_live_by
    if name == "rwkv6-3b":
        five = lambda k: k.count(",") == 4   # noqa: E731  (a 5-dim shape)
        chunks = 1024 // 32                  # the WKV's chunk of 32
        assert all(five(k) and old.peak_live_by[k][1] >= chunks
                   for k in old_top)
        assert sum(n for k, (_, n) in new_rec.items() if five(k)) < chunks
    else:
        assert all("(8, 1024, 1024) float32" in k for k in old_top)
        assert not any("1024, 1024)" in k for k in new_rec)


def test_dtensor_product_counted_once_at_its_local_shape(mesh_16x16):
    """(4096 x 8192) @ (8192 x 29568) with the weight on [Shard(0),
    Shard(1)] of (16, 16): the local product (4096 x 512) @ (512 x 1848),
    not the global one too."""
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(4096, 8192, dtype=torch.bfloat16),
                              mesh_16x16, [Replicate(), Replicate()],
                              src_data_rank=None)
        w = distribute_tensor(torch.empty(8192, 29568, dtype=torch.bfloat16),
                              mesh_16x16, [Shard(0), Shard(1)],
                              src_data_rank=None)
        with OpCostMode() as mode:
            x @ w
    mm = sum(v for k, v in mode.flops_by.items() if k.startswith("aten.mm"))
    assert mm == 7_751_073_792 == 2 * 4096 * 512 * 1848
    # the rest is the copy of x's column slice (4096 x 512) that DTensor
    # makes to match the weight's rows; the global product (1.98e12) is
    # not counted
    assert mode.flops == mm + 4096 * 512


def _pairs(tq, tk, causal, window):
    """Visible (query, key) pairs of a prefill mask, by brute force."""
    q = np.arange(tq)[:, None]
    k = np.arange(tk)[None, :]
    m = np.ones((tq, tk), bool)
    if causal:
        m &= q >= k
    if window is not None:
        m &= (q - k) < window
    return int(m.sum())


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None), (True, 700)])
def test_flash_formula_is_the_analytic_count(causal, window):
    b, t, h, hkv, d = 2, 300, 8, 2, 64
    with FakeTensorMode():
        q = torch.empty(b, t, h, d, dtype=torch.bfloat16)
        k = torch.empty(b, t, hkv, d, dtype=torch.bfloat16)
        with OpCostMode() as mode:
            out = tfa.flash_attention(q, k, k, causal=causal, window=window)
    assert out.shape == q.shape
    assert mode.flops == 4 * b * h * d * _pairs(t, t, causal, window)
    assert tfa.visible_pairs(t, t, causal, window) == \
        _pairs(t, t, causal, window)


@pytest.mark.parametrize("gated", [True, False])
def test_ffn_formula_is_the_analytic_count(gated):
    t, d, f = 100, 256, 1024
    with FakeTensorMode():
        x = torch.empty(t, d, dtype=torch.bfloat16)
        w = torch.empty(d, f, dtype=torch.bfloat16)
        wd = torch.empty(f, d, dtype=torch.bfloat16)
        with OpCostMode() as mode:
            tff.fused_ffn(x, w if gated else None, w, wd, act="silu")
    assert mode.flops == 2 * t * d * f * (3 if gated else 2)


@pytest.mark.parametrize("op,shapes", [
    ("ffn", ((8, 32), (32, 24), (32, 24), (24, 32))),     # d_ff 24
    ("ffn", ((8, 40), (40, 32), (40, 32), (32, 40))),     # d_model 40
    ("flash", ((1, 8, 4, 24), (1, 8, 2, 24), (1, 8, 2, 24))),  # head dim 24
    ("flash", ((1, 8, 3, 32), (1, 8, 2, 32), (1, 8, 2, 32))),  # 3 over 2
])
def test_fake_impls_refuse_what_the_launchers_refuse(op, shapes):
    """The dry run sees a launch the card would refuse: the op's fake impl
    runs the launcher's host-side checks."""
    with FakeTensorMode():
        ts = [torch.empty(s, dtype=torch.bfloat16) for s in shapes]
        with pytest.raises(ValueError):
            if op == "ffn":
                torch.ops.repro_torch.fused_ffn.default(*ts, "silu")
            else:
                torch.ops.repro_torch.flash_attention.default(
                    *ts, True, None, None, None)


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu"),
                                       (False, "relu_sq")])
def test_d_ff_padding_to_the_kernels_multiple_is_exact(gated, act):
    """A d_ff shard the kernel refuses (856: glm4-9b over 16 model ranks)
    goes to it padded with zero columns, which add nothing; the fake launch
    counts the padded work."""
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(0)
    t, d, f = 5, 32, 856
    x = torch.randn(t, d, generator=g)
    wg, wu = (torch.randn(d, f, generator=g) * d ** -0.5 for _ in range(2))
    wd = torch.randn(f, d, generator=g) * f ** -0.5
    wg = wg if gated else None
    padded = tff._pad_d_ff(wg, wu, wd, -f % 16)
    assert padded[1].shape == (d, 864) and padded[2].shape == (864, d)
    want = ref.fused_ffn_ref(x, wg, wu, wd, act=act)
    got = ref.fused_ffn_ref(x, *padded, act=act)
    # the same sums but for zero terms: f32 rounding of a longer reduction
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
    with FakeTensorMode():
        fx = torch.empty(t, d, dtype=torch.bfloat16)
        fw = torch.empty(d, f, dtype=torch.bfloat16)
        fd = torch.empty(f, d, dtype=torch.bfloat16)
        with OpCostMode() as mode:
            out = tff.fused_ffn(fx, fw if gated else None, fw, fd, act=act)
    assert out.shape == (t, d)
    kernel = sum(v for k, v in mode.flops_by.items() if "fused_ffn" in k)
    assert kernel == 2 * t * d * 864 * (3 if gated else 2)


def test_custom_ops_pass_opcheck_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    x, wg, wu = (torch.randn(s, generator=g) for s in
                 ((6, 32), (32, 48), (32, 48)))
    wd = torch.randn(48, 32, generator=g)
    torch.library.opcheck(torch.ops.repro_torch.fused_ffn.default,
                          (x, wg, wu, wd, "gelu"))
    torch.library.opcheck(torch.ops.repro_torch.fused_ffn.default,
                          (x, None, wu, wd, "relu_sq"))
    q = torch.randn(2, 24, 4, 32, generator=g)
    k, v = (torch.randn(2, 24, 2, 32, generator=g) for _ in range(2))
    torch.library.opcheck(torch.ops.repro_torch.flash_attention.default,
                          (q, k, v, True, 8, 30.0, 0.2))


# --- smoke-size steps against the reference's HLO walker --------------------

B, T = 2, 16
# (dot FLOPs within 5%, total FLOPs in this band of the reference's). The
# total's gap is XLA's own ops that the port does not run: `convert` (the
# reference casts f32 masters, caches and accumulators at every use inside
# fusions it counts per element), `dynamic-slice` / `dynamic-update-slice`
# (its layer scan copies each stacked unit's params and cache slot; here a
# view and an in-place write) and `broadcast`.
BANDS = {"prefill": (0.85, 1.05), "decode": (0.45, 1.05),
         "train": (0.75, 1.05)}


def _ref_text(rc, kind):
    rp = rlm.init_params(rc, jax.random.PRNGKey(0))
    tok = np.zeros((B, T), np.int32)
    if kind == "prefill":
        f = jax.jit(lambda p, t: rlm.prefill(p, rc, tokens=t, max_len=T))
        return f.lower(rp, tok).compile().as_text()
    if kind == "decode":
        cache = rlm.init_cache(rc, B, T)
        f = jax.jit(lambda p, c, t: rlm.decode_step(p, rc, c, t,
                                                    jnp.int32(T - 1)))
        return f.lower(rp, cache, tok[:, 0]).compile().as_text()
    mesh = ref_make_mesh((1, 1), ("data", "model"))
    train = rsteps.TrainSpec()
    step = rsteps.build_train_step(rc, mesh, train,
                                   RInputShape("train_4k", T, B, "train"),
                                   donate=False)
    st = rsteps.init_train_state(rc, jax.random.PRNGKey(0), train)
    return step.lower(st, {"tokens": tok, "labels": tok}).compile().as_text()


def _port_mode(pc, kind):
    with fake_process_group(1):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        params = lm.init_params(pc, 0, "cpu", torch.float32)   # f32 masters
        t = torch.zeros((B, T), dtype=torch.int32)
        if kind == "train":
            train = steps.TrainSpec()
            st = steps.shard_train_state(steps.train_state(params, train),
                                         mesh, pc, train)
            step = steps.build_train_step(
                pc, train, InputShape("train_4k", T, B, "train"), mesh=mesh)
            with OpCostMode() as mode:
                step(st, {"tokens": t, "labels": t})
            return mode
        sp = steps.shard_params(params, mesh)
        if kind == "prefill":
            step = steps.build_prefill_step(pc, mesh, InputShape(
                "p", T, B, "prefill"))
            with OpCostMode() as mode:
                step(sp, {"tokens": t})
            return mode
        cache = lm.sharded_cache(pc, B, T, mesh)
        step = steps.build_decode_step(pc, mesh, InputShape(
            "d", T, B, "decode"))
        with OpCostMode() as mode:
            step(sp, cache, t[:, 0], T - 1)
        return mode


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_smoke_flops_against_the_reference_walker(kind):
    name = "glm4-9b"
    text = _ref_text(rreg.get_smoke(name), kind)
    ref = hlo_cost(text, 1)
    ref_dots = sum(v for k, v in rbreakdown.breakdown(text, 1)[0].items()
                   if k.startswith("dot "))
    mode = _port_mode(registry.get_smoke(name), kind)
    dots = sum(v for k, v in mode.flops_by.items()
               if k.split()[0] in ("aten.mm", "aten.bmm", "aten.addmm",
                                   "aten.baddbmm"))
    assert dots == pytest.approx(ref_dots, rel=0.05)
    lo, hi = BANDS[kind]
    assert lo * ref.flops <= mode.flops <= hi * ref.flops


# --- the dry run --------------------------------------------------------------


@pytest.fixture(scope="module")
def decode_cell(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    rec = dryrun.run_cell("glm4-9b", "decode_32k", "single", out_dir=str(out),
                          verbose=False)
    return rec, out


def _ref_local_bytes(abstract, specs, sizes, itemsizes=None):
    """Bytes per device of a tree placed by the reference's specs, each
    leaf at its own itemsize or at ``itemsizes[path]``."""
    flat, _ = jax.tree_util.tree_flatten_with_path(abstract)
    flat_s = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    total = 0
    for (path, leaf), spec in zip(flat, flat_s):
        shards = 1
        for ax in tuple(spec):
            if ax is not None:
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    shards *= sizes[a]
        size = (itemsizes or {}).get(rshd._path_str(path),
                                     leaf.dtype.itemsize)
        total += leaf.size * size // shards
    return total


def test_full_size_dry_run_cell(decode_cell):
    """glm4-9b decode_32k on (16, 16) at full depth: ok, FLOPs and bytes
    counted, the argument bytes those the reference's specs give (the
    port's leaves: bf16 matrices and f32 norm scales; the bf16 cache, int32
    tokens; each divided over its spec's axes)."""
    rec, _ = decode_cell
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["links"] == {"data": "ib", "model": "ib"}
    sizes = {"data": 16, "model": 16}
    am = AbstractMesh((16, 16), ("data", "model"))
    rc = rreg.get("glm4-9b")
    shape = SHAPES_BY_NAME["decode_32k"]
    params = rlm.abstract_params(rc, dtype=jnp.bfloat16)
    cache = rlm.abstract_cache(rc, shape.global_batch, shape.seq_len)
    tok = {"t": jax.ShapeDtypeStruct((shape.global_batch,), jnp.int32)}
    from repro_torch import tree
    port = lm.abstract_params(registry.get("glm4-9b"), torch.bfloat16)
    itemsizes = {p: t.element_size() for p, t in tree.flatten_with_path(port)}
    want = (_ref_local_bytes(params, rshd.param_specs(params, am), sizes,
                             itemsizes)
            + _ref_local_bytes(cache, rshd.cache_specs(rc, am, cache), sizes)
            + _ref_local_bytes(tok, rshd.batch_specs(rc, am, tok), sizes))
    assert rec["memory"]["argument_bytes"] == want


def test_dry_run_says_whether_a_cell_fits(decode_cell, tmp_path,
                                          monkeypatch):
    """``fits``: the arguments and the live estimate within the card's HBM;
    a cell that runs but does not fit keeps ``status`` ok."""
    rec, _ = decode_cell
    live = rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]
    assert rec["fits"] is True and live <= analysis.HW_H100["hbm_bytes"]
    monkeypatch.setitem(analysis.HW_H100, "hbm_bytes", 1024)
    small = dryrun.run_cell("glm4-9b", "decode_32k", "single",
                            out_dir=str(tmp_path), verbose=False,
                            cfg_override=registry.get_smoke("glm4-9b"))
    assert small["status"] == "ok" and small["fits"] is False
    row = report.budget_table([small]).splitlines()[2]
    assert "| NO / - |" in row


def test_report_table_equals_the_reference(decode_cell):
    rec, out = decode_cell
    na = {"arch": "hubert-xlarge", "shape": "decode_32k", "mesh": "single",
          "status": "n/a", "reason": "encoder-only: no decode step exists"}
    err = {"arch": "rwkv6-3b", "shape": "train_4k", "mesh": "single",
           "status": "error", "error": "RuntimeError('x')"}
    records = [json.loads(json.dumps(rec)), na, err]
    for mesh in ("single", "multi"):
        assert report.table(records, mesh) == rreport.table(records, mesh)
    assert [r["arch"] for r in report.load(str(out))] == ["glm4-9b"]
    # the port's budget table: the ok cell alone, its single mesh filled
    rows = report.budget_table(records).splitlines()[2:]
    gib = rec["memory"]["argument_bytes"] / 2 ** 30
    assert len(rows) == 1 and rows[0].startswith(
        f"| glm4-9b | decode_32k | {gib:.2f} / - |")
