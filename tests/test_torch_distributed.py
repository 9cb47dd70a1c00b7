"""The port's multi-device runtime on 8 CPU ranks (gloo), one spawned job.

The reference's ``tests/test_distributed.py`` runs its sharded train step
and elastic restore on 8 host devices; here 8 processes run the port's
DTensor steps on ``(data, model)`` meshes of (4, 2) and (2, 4):

* glm4-9b, recurrentgemma-9b and qwen2-moe-a2.7b (smoke configs, f32, an
  f32 cache): sharded prefill and 4 greedy decode steps equal the port on
  one device (logits within 1e-4, tokens equal), the sequence-sharded
  decode branch taken where the KV heads (2 and 1) do not divide the model
  axis (4 and 2), the MoE's experts and capacity split. The cache is f32
  because the sharded sums round differently in the last bits, which a
  bf16 cache would turn into ulp flips of ~4e-3;
* glm4-9b training, 4 steps on (4, 2) against the one-device step, losses
  within the reference test's 5e-3; qwen2-moe-a2.7b with 5 experts (not
  dividing the model axis), 3 steps, loss, aux loss and gradient norm
  within the same;
* the state drawn shard by shard (``steps.init_sharded_train_state``)
  equal to the whole state sharded, with no whole stacked leaf made on any
  rank;
* an elastic restore: the state saved on (4, 2) into one directory that
  every rank shares (rank 0 writes), restored onto (2, 4), one more step
  within 5e-3 of the step continued on (4, 2);
* the fault-tolerant driver on (4, 2) with that shared directory: a
  failure injected on every rank, each restarting from the same step;
* ``kernels.ops.ffn`` and ``ops.mha`` on DTensors equal to the calls on
  whole tensors.
"""

import dataclasses
import json
import os
import tempfile

import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.configs.base import InputShape
from repro_torch.data import SyntheticLMData
from repro_torch.launch.mesh import make_mesh, process_group
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.runtime import steps as steps_mod

WORLD = 8
MESHES = ((4, 2), (2, 4))
SERVE_ARCHS = ("glm4-9b", "recurrentgemma-9b", "qwen2-moe-a2.7b")
B, P, GEN = 4, 12, 4
MAX_LEN = 16


def _cfg(name):
    return dataclasses.replace(registry.get_smoke(name), dtype="float32")


def _serve(cfg, params, tokens, run_prefill, run_decode):
    logits, cache = run_prefill(params, tokens)
    out, toks = [_full(logits)], []
    tok = out[-1].argmax(-1)
    for i in range(GEN):
        toks.append(tok)
        logits, cache = run_decode(params, cache, tok, P + i)
        out.append(_full(logits))
        tok = out[-1].argmax(-1)
    return out, toks


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _serving(rank, res):
    calls = []
    plain = L._decode_seq_sharded

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)
    L._decode_seq_sharded = counted
    for name in SERVE_ARCHS:
        cfg = _cfg(name)
        params = lm.init_params(cfg, 0, "cpu", torch.float32)
        gen = torch.Generator().manual_seed(7)
        tokens = torch.randint(0, cfg.vocab, (B, P), generator=gen)
        with torch.no_grad():
            want, want_t = _serve(
                cfg, params, tokens,
                lambda p, t: lm.prefill(p, cfg, tokens=t, max_len=MAX_LEN,
                                        cache_dtype=torch.float32),
                lambda p, c, t, pos: lm.decode_step(p, cfg, c, t, pos))
        for shape in MESHES:
            mesh = make_mesh(shape, ("data", "model"), "cpu")
            cell = InputShape("serve", MAX_LEN, B, "prefill")
            pre = steps_mod.build_prefill_step(cfg, mesh, cell,
                                               cache_dtype=torch.float32)
            dec = steps_mod.build_decode_step(cfg, mesh, cell)
            sp = steps_mod.shard_params(params, mesh)
            del calls[:]
            got, got_t = _serve(cfg, sp, tokens,
                                lambda p, t: pre(p, {"tokens": t}), dec)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            same = all(torch.equal(g, w) for g, w in zip(got_t, want_t))
            if rank == 0:
                res[f"{name} {shape}"] = {"err": err, "tokens_equal": same,
                                          "seq_sharded_calls": len(calls)}
    L._decode_seq_sharded = plain


def _training(rank, res, tmp):
    cfg = _cfg("glm4-9b")
    shape = InputShape("train_4k", 32, 8, "train")
    train = steps_mod.TrainSpec(peak_lr=1e-3, warmup_steps=2, total_steps=50)
    data = SyntheticLMData(cfg, shape, seed=5)

    def fresh():
        return steps_mod.init_train_state(cfg, 0, train, "cpu")

    single = steps_mod.build_train_step(cfg, train, shape, "cpu")
    state, l_single = fresh(), []
    for i in range(4):
        state, m = single(state, data.batch_at(i))
        l_single.append(float(m["loss"]))
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    step = steps_mod.build_train_step(cfg, train, shape, mesh=mesh)
    state = steps_mod.shard_train_state(fresh(), mesh, cfg, train)
    l_shard = []
    for i in range(4):
        state, m = step(state, data.batch_at(i))
        l_shard.append(float(_full(m["loss"])))
    ck = CheckpointManager(os.path.join(tmp, "ckpt"), period=1, keep=2)
    ck.maybe_save(4, state, force=True)
    mesh2 = make_mesh((2, 4), ("data", "model"), "cpu")
    state2 = ck.restore_latest(
        steps_mod.abstract_train_state(cfg, train),
        shardings=steps_mod.train_state_shardings(cfg, mesh2, train),
        mesh=mesh2)
    step2 = steps_mod.build_train_step(cfg, train, shape, mesh=mesh2)
    _, m2 = step2(state2, data.batch_at(4))
    _, m1 = step(state, data.batch_at(4))
    if rank == 0:
        res["train"] = {"single": l_single, "sharded": l_shard,
                        "elastic_loss_err": abs(float(_full(m2["loss"]))
                                                - float(_full(m1["loss"])))}


def _training_moe(rank, res):
    """qwen2-moe-a2.7b with 5 experts, 3 steps on (4, 2) (experts in
    windows of 3 over a model axis of 2 that they do not divide, capacity
    over data, the aux loss's gradient counted once) against one device."""
    cfg = _cfg("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           n_experts=5))
    shape = InputShape("train_4k", 16, 8, "train")
    train = steps_mod.TrainSpec(peak_lr=1e-3, warmup_steps=2, total_steps=50)
    data = SyntheticLMData(cfg, shape, seed=6)
    runs = {}
    for name, mesh in (("single", None),
                       ("sharded", make_mesh((4, 2), ("data", "model"),
                                             "cpu"))):
        state = steps_mod.init_train_state(cfg, 0, train, "cpu")
        if mesh is not None:
            state = steps_mod.shard_train_state(state, mesh, cfg, train)
        step = steps_mod.build_train_step(cfg, train, shape, "cpu", mesh=mesh)
        runs[name] = []
        for i in range(3):
            state, m = step(state, data.batch_at(i))
            runs[name].append([float(_full(m[k])) for k in
                               ("loss", "aux", "grad_norm")])
    if rank == 0:
        res["train_moe"] = runs


def _sharded_init(rank, res):
    """``init_sharded_train_state`` against ``shard_train_state`` of the
    whole state, the storage each shard keeps, and the largest tensor made
    on the way."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch import tree
    # four layers: a stacked leaf then outgrows the embedding table
    cfg = dataclasses.replace(_cfg("glm4-9b"), n_layers=4)
    train = steps_mod.TrainSpec()
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    made = [0]

    class Largest(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree.leaves(out):     # plain tensors with storage
                if isinstance(t, torch.Tensor) and not hasattr(
                        t, "placements") and t.device.type != "meta":
                    made[0] = max(made[0], t.numel())
            return out

    with Largest():
        got = steps_mod.init_sharded_train_state(cfg, 0, train, mesh)
    want = steps_mod.shard_train_state(
        steps_mod.init_train_state(cfg, 0, train, "cpu"), mesh, cfg, train)
    flat_g = tree.flatten_with_path(got)
    flat_w = tree.leaves(want)
    equal = len(flat_g) == len(flat_w) and all(
        list(g.placements) == list(w.placements)
        and torch.equal(g.to_local(), w.to_local())
        if hasattr(w, "placements") else torch.equal(g, w)
        for (_, g), w in zip(flat_g, flat_w))
    # a shard's storage is the shard: nothing of the whole leaf retained
    kept_whole = [p for p, g in flat_g if hasattr(g, "placements")
                  and g.to_local().untyped_storage().nbytes()
                  != g.to_local().numel() * g.element_size()]
    # one layer's leaf, or one top-level leaf, is the most ever made
    bound = max(g.numel() // (cfg.n_units if "/units/" in p else 1)
                for p, g in flat_g if p.startswith("0/"))
    stacked = max(g.numel() for p, g in flat_g if p.startswith("0/units/"))
    if rank == 0:
        res["init"] = {"equal": equal, "kept_whole": kept_whole,
                       "largest_made": made[0], "bound": bound,
                       "largest_stacked_leaf": stacked}


def _driver(rank, res, tmp):
    """``TrainDriver`` on (4, 2) with one checkpoint directory for all
    ranks: a preemption at step 3 on every rank, each restarting from the
    checkpoint of step 2, the same losses on every rank."""
    import torch.distributed as dist
    from repro_torch.runtime.fault import FailureInjector, TrainDriver
    cfg = _cfg("glm4-9b")
    shape = InputShape("train_4k", 32, 8, "train")
    train = steps_mod.TrainSpec(peak_lr=1e-3, warmup_steps=2, total_steps=50)
    data = SyntheticLMData(cfg, shape, seed=5)
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    driver = TrainDriver(
        step_fn=steps_mod.build_train_step(cfg, train, shape, mesh=mesh),
        init_state_fn=lambda: steps_mod.init_sharded_train_state(
            cfg, 0, train, mesh),
        batch_at=data.batch_at,
        ckpt=CheckpointManager(os.path.join(tmp, "driver"), period=2),
        template_fn=lambda: steps_mod.abstract_train_state(cfg, train),
        state_shardings=steps_mod.train_state_shardings(cfg, mesh, train),
        mesh=mesh, failure_injector=FailureInjector([3]))
    rep = driver.run(4, log=lambda s: None)
    mine = [rep.restarts] + [m["step"] for m in rep.metrics_history] + \
        [m["loss"] for m in rep.metrics_history]
    every = [None] * WORLD
    dist.all_gather_object(every, mine)
    if rank == 0:
        res["driver"] = {"ranks_agree": all(e == mine for e in every),
                         "restarts": rep.restarts,
                         "steps": [m["step"] for m in rep.metrics_history],
                         "files": sorted(os.listdir(
                             os.path.join(tmp, "driver")))}


def _kernel_ops(rank, res):
    """``ops.ffn`` and ``ops.mha`` on DTensors: each rank's rows and d_ff
    columns (the FFN, a partial sum over model) and its batch and heads
    (attention), against the call on whole tensors."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import ops
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    g = torch.Generator().manual_seed(3)
    x = torch.randn(8, 64, generator=g)
    wg, wu = (torch.randn(64, 128, generator=g) * 64 ** -0.5
              for _ in range(2))
    wd = torch.randn(128, 64, generator=g) * 128 ** -0.5

    def put(t, *pl):
        return distribute_tensor(t, mesh, list(pl), src_data_rank=None)
    y = ops.ffn(put(x, Shard(0), Replicate()),
                put(wg, Replicate(), Shard(1)), put(wu, Replicate(), Shard(1)),
                put(wd, Replicate(), Shard(0)), act="silu")
    want = ops.ffn(x, wg, wu, wd, act="silu")
    q = torch.randn(4, 12, 4, 32, generator=g)
    k, v = (torch.randn(4, 12, 2, 32, generator=g) for _ in range(2))
    o = ops.mha(*(put(t, Shard(0), Shard(2)) for t in (q, k, v)),
                n_kv_heads=2, causal=True, window=5)
    o_want = ops.mha(q, k, v, n_kv_heads=2, causal=True, window=5)
    errs = {"ffn": float((y.full_tensor() - want).abs().max()),
            "mha": float((o.full_tensor() - o_want).abs().max())}
    if rank == 0:
        res["ops"] = errs


def _worker(rank, tmp):
    torch.set_num_threads(1)        # 8 ranks share the host's cores
    torch.manual_seed(0)
    res = {}
    with process_group("gloo", WORLD, rank, os.path.join(tmp, "pg")):
        _kernel_ops(rank, res)
        _serving(rank, res)
        _training(rank, res, tmp)
        _training_moe(rank, res)
        _sharded_init(rank, res)
        _driver(rank, res, tmp)
    if rank == 0:
        with open(os.path.join(tmp, "result.json"), "w") as f:
            json.dump(res, f)


@pytest.fixture(scope="module")
def result():
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_worker, args=(tmp,), nprocs=WORLD, join=True,
                           start_method="spawn")
        with open(os.path.join(tmp, "result.json")) as f:
            return json.load(f)


@pytest.mark.parametrize("name", SERVE_ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_sharded_serving_equals_one_device(result, name, shape):
    r = result[f"{name} {tuple(shape)}"]
    assert r["err"] < 1e-4, r
    assert r["tokens_equal"], r


@pytest.mark.parametrize("name,shape", [("glm4-9b", (2, 4)),
                                        ("recurrentgemma-9b", (4, 2)),
                                        ("recurrentgemma-9b", (2, 4))])
def test_sequence_sharded_decode_branch_runs(result, name, shape):
    """KV heads 2 on a model axis of 4, 1 on 2 and 4: every attention layer
    of every decode step takes the branch."""
    cfg = _cfg(name)
    attn = sum(k.startswith("attn") for k in cfg.layer_kinds())
    assert result[f"{name} {tuple(shape)}"]["seq_sharded_calls"] == \
        attn * GEN


def test_heads_sharded_decode_skips_the_branch(result):
    assert result["glm4-9b (4, 2)"]["seq_sharded_calls"] == 0


def test_sharded_training_equals_one_device(result):
    r = result["train"]
    assert max(abs(a - b) for a, b in zip(r["single"], r["sharded"])) < 5e-3, r
    assert r["sharded"][-1] < r["sharded"][0]


def test_sharded_moe_training_equals_one_device(result):
    """Loss, aux loss and gradient norm of each step."""
    r = result["train_moe"]
    for one, many in zip(r["single"], r["sharded"]):
        assert max(abs(a - b) for a, b in zip(one, many)) < 5e-3, r


def test_elastic_restore_onto_another_mesh(result):
    assert result["train"]["elastic_loss_err"] < 5e-3


def test_sharded_init_equals_the_whole_state_sharded(result):
    r = result["init"]
    assert r["equal"], r
    assert r["kept_whole"] == [], r
    assert r["largest_made"] <= r["bound"] < r["largest_stacked_leaf"], r


def test_driver_restarts_every_rank_from_one_shared_checkpoint(result):
    r = result["driver"]
    assert r["ranks_agree"], r
    assert r["restarts"] == 1 and r["steps"] == [0, 1, 2, 2, 3], r
    assert r["files"] == ["LATEST", "step_00000002", "step_00000004"], r


def test_kernel_ops_take_dtensors(result):
    assert result["ops"]["ffn"] < 1e-5 and result["ops"]["mha"] < 1e-5, \
        result["ops"]
