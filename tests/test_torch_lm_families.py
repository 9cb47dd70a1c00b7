"""The MoE, RG-LRU and RWKV6 families in the port against the JAX package on
the CPU: qwen2-moe-a2.7b and llama4-scout-17b-a16e (MoE with a shared
expert), recurrentgemma-9b (RG-LRU + local MQA attention) and rwkv6-3b
(time-mix + relu_sq channel-mix).

Each smoke config is built once by JAX, flattened to numpy and carried
across through ``params_from_numpy``. JAX runs with ``attn_impl="pallas"``
(interpret mode) and ``block_impl="fused"``; the port with
``attn_impl="kernel"``, whose CPU path is the kernel's plain version.
Tolerances in float32: ``moe_layer`` 1e-5 (aux 1e-6), the RG-LRU pieces
1e-5, the WKV forms 1e-4 (y) and 1e-5 (state), the group norm 1e-6, the
model's logits 1e-4, decode steps against the full forward 2e-3 (as
tests/test_models.py holds the reference itself).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import rglru as jrg
from repro.models import rwkv6 as jrwkv
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trg
from repro_torch.models import rwkv6 as trwkv

MODEL_TOL = 1e-4
DECODE_TOL = 2e-3
ARCHS = ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e", "recurrentgemma-9b",
         "rwkv6-3b"]
MOE_ARCHS = ARCHS[:2]
B, T, STEPS = 2, 20, 4


def _cfgs(name, capacity_factor=None):
    """(JAX, port) smoke configs in f32; ``capacity_factor`` replaces the
    MoE spec's."""
    def one(cfg, attn_impl):
        cfg = dataclasses.replace(cfg, dtype="float32", attn_impl=attn_impl,
                                  block_impl="fused")
        if capacity_factor is None:
            return cfg
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return (one(jreg.get_smoke(name), "pallas"),
            one(treg.get_smoke(name), "kernel"))


def _no_drop(name):
    """capacity_factor = n_experts, so no token is dropped whatever the
    batch (tests/conftest.py's ``f32_smoke``); None for a dense arch."""
    moe = treg.get_smoke(name).moe
    return None if moe is None else float(moe.n_experts)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(tree):
    """A numpy (or JAX) tree as float32 torch tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """name -> (numpy tree, JAX params, port params): one JAX init per
    config for the whole module."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg, tcfg = _cfgs(name)
            tree = _numpy_tree(jlm.init_params(jcfg, jax.random.PRNGKey(0)))
            cache[name] = (tree, jax.tree.map(jnp.asarray, tree),
                           tlm.params_from_numpy(tree, tcfg, device="cpu"))
        return cache[name]

    return get


def _first_layer(tree, layer="0"):
    return jax.tree.map(lambda a: a[0], tree["units"][layer])


# --- MoE --------------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor", [None, 0.05],
                         ids=["default", "cf0.05"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_layer_matches_jax(name, capacity_factor):
    jcfg, tcfg = _cfgs(name, capacity_factor)
    p = _numpy_tree(jmoe.init_moe(jax.random.PRNGKey(3), jcfg))
    x = np.random.default_rng(4).standard_normal(
        (B, T, jcfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_layer(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                              jcfg)
    ty, taux = tmoe.moe_layer(torch.from_numpy(x), _t(p), tcfg)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=0)
    load = tmoe.expert_load(torch.from_numpy(x), _t(p), tcfg)
    assert load["capacity"] == jmoe.capacity(B * T, jcfg.moe)
    assert sum(load["load"]) == B * T * jcfg.moe.top_k
    if capacity_factor is not None:
        assert load["dropped"] > 0     # drops happen, and match JAX above


@pytest.mark.parametrize("name,n,cap", [
    ("qwen2-moe-a2.7b", 2048, 176), ("llama4-scout-17b-a16e", 2048, 160),
    ("qwen2-moe-a2.7b", 4, 8), ("llama4-scout-17b-a16e", 4, 8)])
def test_capacity_at_the_served_shapes(name, n, cap):
    """B 4 x P 512 at prefill, B 4 at decode: int() truncation, then up to
    a multiple of 8 with a floor of 8."""
    m = treg.get(name).moe
    assert tmoe.capacity(n, m) == cap == jmoe.capacity(n, jreg.get(name).moe)


# --- RG-LRU -------------------------------------------------------------------


@pytest.fixture(scope="module")
def rglru_params():
    jcfg, _ = _cfgs("recurrentgemma-9b")
    p = _numpy_tree(jrg.init_rglru_block(jax.random.PRNGKey(5), jcfg))
    rng = np.random.default_rng(6)
    for k in ("conv_b", "b_a", "b_x"):     # zeros at init: make them matter
        p[k] = (0.1 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return p


def test_rg_lru_scan_matches_jax(rglru_params):
    p = rglru_params
    x = np.random.default_rng(7).standard_normal(
        (B, 37, p["lambda"].shape[0])).astype(np.float32)
    want = jrg.rg_lru_scan(jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    got = trg.rg_lru_scan(torch.from_numpy(x), _t(p))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    # the scan's last state is the per-token recurrence's
    h = torch.zeros(B, x.shape[-1])
    for i in range(x.shape[1]):
        _, h = trg.rg_lru_step(torch.from_numpy(x[:, i]), h, _t(p))
    np.testing.assert_allclose(_np(h), _np(want[:, -1]), atol=1e-5,
                               rtol=1e-5)


def test_conv1d_causal_and_step_match_jax(rglru_params):
    p = rglru_params
    w, b = p["conv_w"], p["conv_b"]
    x = np.random.default_rng(8).standard_normal(
        (B, 11, w.shape[1])).astype(np.float32)
    want = jrg.conv1d_causal(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = trg.conv1d_causal(torch.from_numpy(x), _t(w), _t(b))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    state = np.random.default_rng(9).standard_normal(
        (B, w.shape[0] - 1, w.shape[1])).astype(np.float32)
    jy, js = jrg.conv1d_step(jnp.asarray(x[:, 0]), jnp.asarray(state),
                             jnp.asarray(w), jnp.asarray(b))
    ty, ts = trg.conv1d_step(torch.from_numpy(x[:, 0]),
                             torch.from_numpy(state), _t(w), _t(b))
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(_np(ts), _np(js))


# --- RWKV6 ----------------------------------------------------------------------


def _wkv_inputs(seed=0, b=2, t=70, h=3, k=8):
    """tests/test_models.py's WKV shape: T 70, not a multiple of the chunk."""
    rng = np.random.default_rng(seed)
    r, kk, v = (rng.standard_normal((b, t, h, k)).astype(np.float32)
                for _ in range(3))
    w = (1 / (1 + np.exp(-rng.standard_normal((b, t, h, k)))) * 0.5
         + 0.45).astype(np.float32)
    u = (rng.standard_normal((h, k)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((b, h, k, k)) * 0.1).astype(np.float32)
    return r, kk, v, w, u, s0


@pytest.mark.parametrize("form", ["_wkv_scan", "_wkv_chunk_parallel"])
def test_wkv_forms_match_jax_and_each_other(form):
    args = _wkv_inputs()
    jy, js = getattr(jrwkv, form)(*map(jnp.asarray, args))
    ty, ts = getattr(trwkv, form)(*map(torch.from_numpy, args))
    assert ty.dtype == ts.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(ts), _np(js), atol=1e-5, rtol=1e-5)
    other = "_wkv_chunk_parallel" if form == "_wkv_scan" else "_wkv_scan"
    oy, os_ = getattr(trwkv, other)(*map(torch.from_numpy, args))
    np.testing.assert_allclose(_np(ty), _np(oy), atol=1e-4)
    np.testing.assert_allclose(_np(ts), _np(os_), atol=1e-5)


@pytest.mark.parametrize("t", [70, 100])
def test_wkv_chunk_gradients_match_jax_grad(t):
    """The gradients of ``_wkv_chunk_parallel``, each chunk checkpointed,
    against the reference's ``jax.grad`` of its own (the chunk body under
    ``jax.checkpoint``), for every input: relative norm <= 1e-5. T 70 and
    100 end in a padded chunk."""
    args = _wkv_inputs(t=t)
    rng = np.random.default_rng(t)
    gy = rng.standard_normal(args[0].shape).astype(np.float32)
    gs = rng.standard_normal(args[5].shape).astype(np.float32)

    def jloss(*a):
        y, s = jrwkv._wkv_chunk_parallel(*a)
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, s = trwkv._wkv_chunk_parallel(*leaves)
    loss = (y * torch.from_numpy(gy)).sum() + (s * torch.from_numpy(gs)).sum()
    got = torch.autograd.grad(loss, leaves)
    for name, g, w in zip("r k v w u state0".split(), got, want):
        rel = np.linalg.norm(_np(g) - _np(w)) / np.linalg.norm(_np(w))
        assert rel <= 1e-5, (name, rel)


@pytest.mark.parametrize("t", [70, 100])
def test_wkv_chunks_save_no_5d_tensor_under_grad(t, monkeypatch):
    """Over the forward and the backward (its recompute included), autograd
    saves no 5-dim tensor outside a chunk's checkpoint: each chunk's
    (B, L, L, H, K) intermediates exist one chunk at a time. The control:
    with the chunks not checkpointed (the loop before), the same hooks see
    them."""
    def saved_dims(checkpointed):
        leaves = [torch.from_numpy(a).requires_grad_()
                  for a in _wkv_inputs(t=t)]
        dims = []

        def pack(x):
            dims.append(x.dim())
            return x

        with monkeypatch.context() as m:
            if not checkpointed:
                m.setattr(trwkv.ffnlib, "checkpointed", lambda fn: fn)
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
                y, s = trwkv._wkv_chunk_parallel(*leaves)
                torch.autograd.grad(y.sum() + s.sum(), leaves)
        return dims

    dims = saved_dims(True)
    assert dims and 5 not in dims
    assert 5 in saved_dims(False)


def test_group_norm_matches_jax():
    rng = np.random.default_rng(10)
    h, hd = 4, 32
    y = (rng.standard_normal((B, 5, h, hd)) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(h * hd)).astype(np.float32)
    want = jrwkv._group_norm(jnp.asarray(y), jnp.asarray(scale), h, hd)
    got = trwkv._group_norm(torch.from_numpy(y), torch.from_numpy(scale), h,
                            hd)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)


# --- the whole smoke models ----------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_jax(models, name):
    _, jp, tp = models(name)
    jcfg, tcfg = _cfgs(name)
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab, (B, T)).astype(np.int32)
    want, _ = jlm.forward(jp, jcfg, tokens=jnp.asarray(tokens))
    got = tlm.forward(tp, tcfg, tokens)
    assert got.shape == want.shape == (B, T, tcfg.vocab_padded())
    np.testing.assert_allclose(_np(got), _np(want), atol=MODEL_TOL,
                               rtol=MODEL_TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_greedy_decode_match_jax(models, name):
    """Prefill, then 4 greedy decode steps: the tokens equal JAX's greedy
    loop, and every step's logits are within 2e-3 of JAX's full forward
    over the same tokens (MoE without drops, as the reference's own test
    holds it: a full forward and one decode step dispatch different
    batches)."""
    _, jp, tp = models(name)
    jcfg, tcfg = _cfgs(name, _no_drop(name))
    tokens = np.random.default_rng(2).integers(
        0, tcfg.vocab, (B, T)).astype(np.int32)
    max_len = T + STEPS
    jl, jc = jlm.prefill(jp, jcfg, tokens=jnp.asarray(tokens),
                         max_len=max_len, cache_dtype=jnp.float32)
    tl, tc = tlm.prefill(tp, tcfg, tokens, max_len=max_len,
                         cache_dtype=torch.float32)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    steps = [tl]
    jt = jnp.argmax(jl[:, :jcfg.vocab], -1).astype(jnp.int32)
    tt = tl[:, :tcfg.vocab].argmax(-1)
    seq = [tt]
    for i in range(STEPS):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc = jlm.decode_step(jp, jcfg, jc, jt, jnp.int32(T + i))
        tl, tc = tlm.decode_step(tp, tcfg, tc, tt, T + i)
        steps.append(tl)
        jt = jnp.argmax(jl[:, :jcfg.vocab], -1).astype(jnp.int32)
        tt = tl[:, :tcfg.vocab].argmax(-1)
        seq.append(tt)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    full_tokens = np.concatenate(
        [tokens, torch.stack(seq[:STEPS], 1).numpy().astype(np.int32)], 1)
    full, _ = jlm.forward(jp, jcfg, tokens=jnp.asarray(full_tokens))
    for i, lg in enumerate(steps):
        np.testing.assert_allclose(_np(lg), _np(full[:, T - 1 + i]),
                                   atol=DECODE_TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_cache_leaf_dtypes_match_reference(models, name, cache_dtype):
    """Every cache leaf keeps the reference's dtype and shape: RG-LRU's h
    and RWKV's S in f32 whatever the cache dtype; after a prefill too."""
    jd, td = ((jnp.float32, torch.float32) if cache_dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    jcfg, tcfg = _cfgs(name)
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        jlm.abstract_cache(jcfg, B, T + 2, jd))
    mine = lambda c: jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), c)
    assert mine(tlm.init_cache(tcfg, B, T + 2, td, "cpu")) == want
    _, _, tp = models(name)
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab, (B, T))
    _, cache = tlm.prefill(tp, tcfg, tokens, max_len=T + 2, cache_dtype=td)
    assert mine(cache) == want
    for leaf in ("h", "S"):
        for layer in cache.get("units", {}).values():
            if leaf in layer:
                assert layer[leaf].dtype == torch.float32


# --- bf16: the leaves the reference uses at their f32 masters -------------------


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", k, v


@pytest.mark.parametrize("how", ["params_from_numpy", "init_params"])
@pytest.mark.parametrize("name", ARCHS)
def test_f32_leaves_stay_f32_under_bf16(models, name, how):
    tree, _, _ = models(name)
    cfg = treg.get_smoke(name)      # bf16
    p = (tlm.params_from_numpy(tree, cfg, device="cpu")
         if how == "params_from_numpy" else tlm.init_params(cfg, 0, "cpu"))
    names = set()
    for path, leaf, t in _leaves(p):
        want = torch.float32 if ("norm" in leaf or leaf in tL.F32_LEAVES) \
            else torch.bfloat16
        assert t.dtype == want, (path, t.dtype)
        names.add(leaf)
    expect = {"qwen2-moe-a2.7b": {"router"},
              "llama4-scout-17b-a16e": {"router"},
              "recurrentgemma-9b": {"conv_w", "conv_b", "w_a", "b_a", "w_x",
                                    "b_x", "lambda"},
              "rwkv6-3b": {"decay_A", "decay_B", "decay_base", "bonus_u",
                           "ln_x"}}[name]
    assert expect <= names & tL.F32_LEAVES


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_router_ids_under_bf16_match_jax(models, name):
    """On the same bf16 input, the router (f32, as the reference's master)
    picks JAX's top-k experts wherever the k-th and (k+1)-th probabilities
    are more than 1e-5 apart."""
    tree, _, _ = models(name)
    m = treg.get_smoke(name).moe
    router = _first_layer(tree)["sub2"]["router"]
    p = tlm.params_from_numpy(tree, treg.get_smoke(name), device="cpu")
    t_router = p["units"]["0"]["sub2"]["router"][0]
    assert t_router.dtype == torch.float32
    x = jnp.asarray(np.random.default_rng(11).standard_normal(
        (256, router.shape[0])), jnp.bfloat16)
    # the reference's routing lines (moe.py:74-76) on the bf16 input
    probs = jax.nn.softmax(x.astype(jnp.float32) @ jnp.asarray(router), -1)
    jg, jids = jax.lax.top_k(probs, m.top_k)
    top = jax.lax.top_k(probs, m.top_k + 1)[0]
    clear = np.asarray(top[:, -2] - top[:, -1] > 1e-5)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    _, _, tids = tmoe._route(xt, {"router": t_router}, m)
    assert clear.sum() > 200
    np.testing.assert_array_equal(tids.numpy()[clear], np.asarray(jids)[clear])


# --- serving ---------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_serve_smoke_runs_each_family(name, capsys):
    gen = tserve.main(["--arch", name, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "12", "--gen", "3"])
    cfg = treg.get_smoke(name)
    assert gen.shape == (2, 3) and gen.min() >= 0 and gen.max() < cfg.vocab
    assert f"arch={cfg.name}" in capsys.readouterr().out


def test_serve_recurrent_tail_greedy_loop_matches_a_direct_loop(capsys):
    """``--layers 2`` on recurrentgemma's smoke config leaves no whole
    (rec, rec, attn_local) unit: two recurrent tail layers, whose state is
    not k/v. The served tokens equal a direct greedy loop."""
    argv = ["--arch", "recurrentgemma-9b", "--smoke", "--device", "cpu",
            "--layers", "2", "--batch", "2", "--prompt-len", "9", "--gen",
            "4", "--seed", "3"]
    gen = tserve.main(argv)
    assert "depth cut to 2 of 6 layers" in capsys.readouterr().out
    cfg = dataclasses.replace(treg.get_smoke("recurrentgemma-9b"),
                              n_layers=2, attn_impl="kernel",
                              block_impl="fused")
    assert cfg.n_units == 0 and cfg.tail_kinds == ("recurrent",) * 2
    params = tlm.init_params(cfg, 3, "cpu")
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 9)))
    logits, cache = tlm.prefill(params, cfg, prompts, max_len=13)
    tok = logits[:, :cfg.vocab].argmax(-1)
    want = [tok]
    for i in range(3):
        logits, cache = tlm.decode_step(params, cfg, cache, tok, 9 + i)
        tok = logits[:, :cfg.vocab].argmax(-1)
        want.append(tok)
    np.testing.assert_array_equal(gen, torch.stack(want, 1).numpy())
    assert cache["tail"]["0"]["h"].dtype == torch.float32
