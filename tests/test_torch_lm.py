"""The port's LM (gemma2, dense attention) against the JAX package on the
CPU: configs (every arch's; the other archs' models are held in
tests/test_torch_lm_archs.py and tests/test_torch_lm_families.py), each
layer kind's parameter shapes, attention prefill/decode with the
ring-buffer KV cache, and the smoke model's prefill plus greedy decode
carried across through ``params_from_numpy``.

The JAX model runs with ``attn_impl="pallas"`` (interpret mode) and
``block_impl="fused"``; the port with ``attn_impl="kernel"``, whose CPU path
is the kernel's plain version. Tolerances: 2e-5 per layer and 1e-4 for the
model's logits, in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import MoESpec as JMoESpec
from repro.models import layers as jL
from repro.models import lm as jlm
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MoESpec
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm

LAYER_TOL = 2e-5
MODEL_TOL = 1e-4
IMPL = {"reference": "reference", "fused": "fused", "kernel": "pallas"}


def _cfgs(attn_impl="kernel", block_impl="fused", **over):
    jcfg = dataclasses.replace(jreg.get_smoke("gemma2-9b"), dtype="float32",
                               attn_impl=IMPL[attn_impl],
                               block_impl=block_impl, **over)
    tcfg = dataclasses.replace(treg.get_smoke("gemma2-9b"), dtype="float32",
                               attn_impl=attn_impl, block_impl=block_impl,
                               **over)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def smoke_params():
    """The JAX smoke parameters and the same values in the port."""
    jcfg, tcfg = _cfgs()
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    return jp, tlm.params_from_numpy(tree, tcfg, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# --- configs -----------------------------------------------------------------


PORTED = ("gemma2-9b", "qwen3-14b", "glm4-9b", "qwen2-72b", "internvl2-1b",
          "hubert-xlarge", "qwen2-moe-a2.7b", "llama4-scout-17b-a16e",
          "recurrentgemma-9b", "rwkv6-3b")


@pytest.mark.parametrize("name", PORTED)
def test_gemma2_config_matches_reference(name):
    want = dataclasses.asdict(jreg.get(name))
    got = dataclasses.asdict(treg.get(name))
    assert got == want
    smoke_want = dataclasses.asdict(jreg.get_smoke(name))
    assert dataclasses.asdict(treg.get_smoke(name)) == smoke_want
    cfg = treg.get(name)
    assert cfg.param_count() == jreg.get(name).param_count()
    assert cfg.vocab_padded() == jreg.get(name).vocab_padded()
    if name == "gemma2-9b":
        assert cfg.vocab_padded() == 256000 and cfg.n_units == 21
    assert treg.ARCH_NAMES == PORTED


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "rwkv6-3b",
                                  "llama4-scout-17b-a16e",
                                  "recurrentgemma-9b"])
def test_unported_archs_raise_naming_roadmap(name):
    """The MoE, RG-LRU and RWKV6 archs resolve to the reference's configs
    (full and smoke, ``param_count`` included); only an unknown name
    raises."""
    assert dataclasses.asdict(treg.get(name)) == dataclasses.asdict(
        jreg.get(name))
    assert dataclasses.asdict(treg.get_smoke(name)) == dataclasses.asdict(
        jreg.get_smoke(name))
    assert treg.get(name).param_count() == jreg.get(name).param_count()
    assert treg.get(name).active_param_count() == \
        jreg.get(name).active_param_count()
    with pytest.raises(KeyError):
        treg.get("no-such-arch")


@pytest.mark.parametrize("over", [
    dict(moe=MoESpec(n_experts=4, top_k=2, d_ff_expert=64)),
    dict(pattern=("recurrent", "attn_local")),
    dict(pattern=("rwkv",)),
])
def test_unported_layer_kinds_raise(over):
    """Each layer kind and MoE, on gemma2's smoke config: ``init_params``
    gives the shapes of ``jlm.abstract_params`` for the same config."""
    jover = dict(over)
    if "moe" in over:
        jover["moe"] = JMoESpec(**dataclasses.asdict(over["moe"]))
    jcfg = dataclasses.replace(jreg.get_smoke("gemma2-9b"), **jover)
    cfg = dataclasses.replace(treg.get_smoke("gemma2-9b"), **over)
    want = jax.tree.map(lambda s: tuple(s.shape), jlm.abstract_params(jcfg))
    got = jax.tree.map(lambda t: tuple(t.shape),
                       tlm.init_params(cfg, 0, device="cpu"))
    assert got == want


def test_init_params_shapes_match_reference_and_seed():
    jcfg, tcfg = _cfgs()
    want = jax.tree.map(lambda s: tuple(s.shape), jlm.abstract_params(jcfg))
    p = tlm.init_params(tcfg, 3, device="cpu")
    got = jax.tree.map(lambda t: tuple(t.shape), p)
    assert got == want
    again = tlm.init_params(tcfg, 3, device="cpu")
    assert torch.equal(p["units"]["1"]["sub2"]["w_down"],
                       again["units"]["1"]["sub2"]["w_down"])
    other = tlm.init_params(tcfg, 4, device="cpu")
    assert not torch.equal(p["embed"], other["embed"])
    bf = tlm.init_params(treg.get_smoke("gemma2-9b"), 3, device="cpu")
    assert bf["embed"].dtype == torch.bfloat16
    assert bf["units"]["0"]["norm1"].dtype == torch.float32


def test_params_from_numpy_keeps_norms_f32():
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, jlm.init_params(jcfg,
                                                    jax.random.PRNGKey(1)))
    p = tlm.params_from_numpy(tree, treg.get_smoke("gemma2-9b"),
                              device="cpu")
    assert p["units"]["0"]["sub1"]["wq"].dtype == torch.bfloat16
    assert p["units"]["0"]["post_norm2"].dtype == torch.float32
    assert p["final_norm"].dtype == torch.float32
    np.testing.assert_array_equal(p["final_norm"].numpy(),
                                  tree["final_norm"])


# --- attention layer with the KV cache ---------------------------------------


def _layer_params(jp, tp, layer):
    ju = jax.tree.map(lambda a: a[0], jp["units"][str(layer)]["sub1"])
    tu = {k: v[0] for k, v in tp["units"][str(layer)]["sub1"].items()}
    return ju, tu


@pytest.mark.parametrize("attn_impl", ["reference", "fused", "kernel"])
@pytest.mark.parametrize("local,t", [(True, 24), (True, 10), (False, 24)])
def test_attention_prefill_and_decode_match_jax(smoke_params, attn_impl,
                                                local, t):
    # window 16: a local layer with prompt 24 and max_len 28 keeps a ring
    # buffer of 16 slots, rolled into phase at prefill; prompt 10 fills it
    # flat first.
    jp, tp = smoke_params
    jcfg, tcfg = _cfgs(attn_impl)
    ju, tu = _layer_params(jp, tp, 0 if local else 1)
    x = np.random.default_rng(t).standard_normal(
        (2, t, jcfg.d_model)).astype(np.float32)
    max_len = t + 4
    jc = jL.init_kv_cache(jcfg, 2, max_len, local=local, dtype=jnp.float32)
    tc = tL.init_kv_cache(tcfg, 2, max_len, local=local, dtype=torch.float32)
    assert tc["k"].shape == jc["k"].shape
    jy, jc = jL.attention_prefill(jnp.asarray(x), ju, jcfg, jc, local=local)
    ty, tc = tL.attention_prefill(torch.from_numpy(x), tu, tcfg, tc,
                                  local=local)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=LAYER_TOL,
                               rtol=LAYER_TOL)
    np.testing.assert_allclose(_np(tc["k"]), _np(jc["k"]), atol=LAYER_TOL,
                               rtol=LAYER_TOL)
    full = tL.attention_layer(torch.from_numpy(x), tu, tcfg, local=local)
    np.testing.assert_allclose(_np(full), _np(ty), atol=LAYER_TOL)
    rng = np.random.default_rng(t + 1)
    for step in range(4):
        xs = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = jL.attention_decode(jnp.asarray(xs), ju, jcfg, jc,
                                     jnp.int32(t + step), local=local)
        ty, tc = tL.attention_decode(torch.from_numpy(xs), tu, tcfg, tc,
                                     t + step, local=local)
        np.testing.assert_allclose(_np(ty), _np(jy), atol=LAYER_TOL,
                                   rtol=LAYER_TOL)
        np.testing.assert_allclose(_np(tc["v"]), _np(jc["v"]), atol=LAYER_TOL)


# --- the whole smoke model ----------------------------------------------------


def _greedy(jp, tp, jcfg, tcfg, tokens, steps, cache_dtype):
    jd, td = ((jnp.float32, torch.float32) if cache_dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    t = tokens.shape[1]
    max_len = t + steps
    jl, jc = jlm.prefill(jp, jcfg, tokens=jnp.asarray(tokens),
                         max_len=max_len, cache_dtype=jd)
    tl, tc = tlm.prefill(tp, tcfg, tokens, max_len=max_len, cache_dtype=td)
    logits = [(_np(jl), _np(tl))]
    jt = jnp.argmax(jl[:, :jcfg.vocab], -1).astype(jnp.int32)
    tt = tl[:, :tcfg.vocab].argmax(-1)
    toks = [(np.asarray(jt), tt.numpy())]
    for i in range(steps):
        jl, jc = jlm.decode_step(jp, jcfg, jc, jt, jnp.int32(t + i))
        tl, tc = tlm.decode_step(tp, tcfg, tc, tt, t + i)
        logits.append((_np(jl), _np(tl)))
        jt = jnp.argmax(jl[:, :jcfg.vocab], -1).astype(jnp.int32)
        tt = tl[:, :tcfg.vocab].argmax(-1)
        toks.append((np.asarray(jt), tt.numpy()))
    return logits, toks


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_smoke_prefill_and_greedy_decode_match_jax(smoke_params, cache_dtype):
    jp, tp = smoke_params
    jcfg, tcfg = _cfgs()
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab, (2, 24)).astype(np.int32)
    logits, toks = _greedy(jp, tp, jcfg, tcfg, tokens, 4, cache_dtype)
    for want, got in toks:
        np.testing.assert_array_equal(got, want)
    if cache_dtype == "float32":
        for want, got in logits:
            np.testing.assert_allclose(got, want, atol=MODEL_TOL,
                                       rtol=MODEL_TOL)
    else:
        # The default bf16 cache rounds q to bf16 in decode, where a 1e-6
        # difference can flip one rounding: prefill logits stay at 1e-4,
        # decode logits at 1e-3.
        np.testing.assert_allclose(logits[0][1], logits[0][0],
                                   atol=MODEL_TOL, rtol=MODEL_TOL)
        for want, got in logits[1:]:
            np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("attn_impl,block_impl", [("reference", "reference"),
                                                  ("fused", "fused")])
def test_smoke_forward_matches_jax(smoke_params, attn_impl, block_impl):
    jp, tp = smoke_params
    jcfg, tcfg = _cfgs(attn_impl, block_impl)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab, (2, 20)).astype(np.int32)
    want, _ = jlm.forward(jp, jcfg, tokens=jnp.asarray(tokens))
    got = tlm.forward(tp, tcfg, tokens)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=MODEL_TOL,
                               rtol=MODEL_TOL)


def test_prefill_last_logits_equal_forward(smoke_params):
    _, tp = smoke_params
    _, tcfg = _cfgs()
    tokens = np.random.default_rng(2).integers(0, tcfg.vocab, (2, 20))
    last, _ = tlm.prefill(tp, tcfg, tokens)
    full = tlm.forward(tp, tcfg, tokens)
    np.testing.assert_allclose(_np(last), _np(full[:, -1]), atol=LAYER_TOL)
