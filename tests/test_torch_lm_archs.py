"""The rest of the dense LM family in the port against the JAX package on
the CPU: qwen3-14b (qk_norm, head_pad), glm4-9b (qkv_bias, partial rotary),
qwen2-72b (qkv_bias), internvl2-1b (the vision patch prefix, head_pad) and
hubert-xlarge (the audio frame stub, an encoder without a causal mask).

Each smoke config is built once by JAX, flattened to numpy (its qkv biases
and q/k norm scales, zeros and ones at init, replaced by seeded noise so
that they matter) and carried across through ``params_from_numpy``. JAX
runs with ``attn_impl="pallas"`` (interpret mode) and ``block_impl=
"fused"``; the port with ``attn_impl="kernel"``, whose CPU path is the
kernel's plain version. Tolerances in float32: 1e-4 for the model's
logits, 2e-5 per attention layer (the repo's f32 kernel tolerance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import serve as jserve
from repro.models import layers as jL
from repro.models import lm as jlm
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm

LAYER_TOL = 2e-5
MODEL_TOL = 1e-4
IMPL = {"reference": "reference", "fused": "fused", "kernel": "pallas"}
ARCHS = ["qwen3-14b", "glm4-9b", "qwen2-72b", "internvl2-1b",
         "hubert-xlarge"]
DECODERS = [a for a in ARCHS if a not in treg.ENCODER_ONLY]
B, T, STEPS = 2, 20, 4


def _cfgs(name, attn_impl="kernel", block_impl="fused", **over):
    jcfg = dataclasses.replace(jreg.get_smoke(name), dtype="float32",
                               attn_impl=IMPL[attn_impl],
                               block_impl=block_impl, **over)
    tcfg = dataclasses.replace(treg.get_smoke(name), dtype="float32",
                               attn_impl=attn_impl, block_impl=block_impl,
                               **over)
    return jcfg, tcfg


def _perturb(tree, rng):
    """Seeded noise on the leaves JAX inits to constants: the qkv biases
    (zero) and the q/k norm scales (one)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in ("bq", "bk", "bv"):
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k in ("q_norm", "k_norm"):
            out[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def models():
    """name -> (JAX params, port params), built on first use: one JAX init
    per config for the whole module."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg, tcfg = _cfgs(name)
            tree = jax.tree.map(np.asarray,
                                jlm.init_params(jcfg, jax.random.PRNGKey(0)))
            tree = _perturb(tree, np.random.default_rng(5))
            jp = jax.tree.map(jnp.asarray, tree)
            cache[name] = jp, tlm.params_from_numpy(tree, tcfg, device="cpu")
        return cache[name]

    return get


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _inputs(cfg, seed):
    """tokens, patches, frames for one smoke config (None where the
    config's frontend takes none)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    patches = frames = None
    if cfg.frontend == "vision":
        patches = (rng.standard_normal((B, cfg.n_patches, cfg.d_model))
                   * 0.02).astype(np.float32)
    if cfg.frontend == "audio":
        tokens = None
        frames = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    return tokens, patches, frames


def _j(a):
    return None if a is None else jnp.asarray(a)


# --- configs and registry ------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_config_matches_reference(name):
    assert dataclasses.asdict(treg.get(name)) == dataclasses.asdict(
        jreg.get(name))
    assert dataclasses.asdict(treg.get_smoke(name)) == dataclasses.asdict(
        jreg.get_smoke(name))
    assert treg.get(name).param_count() == jreg.get(name).param_count()


def test_cells_match_reference_for_ported_archs():
    want = {c.key: (c.runnable, c.skip_reason) for c in jreg.cells()
            if c.arch in treg.ARCH_NAMES}
    got = {c.key: (c.runnable, c.skip_reason) for c in treg.cells()}
    assert got == want
    assert sorted(c.key for c in treg.runnable_cells()) == sorted(
        c.key for c in jreg.runnable_cells() if c.arch in treg.ARCH_NAMES)
    assert treg.ENCODER_ONLY == jreg.ENCODER_ONLY
    assert treg.SUBQUADRATIC == jreg.SUBQUADRATIC


# --- the whole smoke model --------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_shapes_match_reference(name):
    jcfg, tcfg = _cfgs(name)
    want = jax.tree.map(lambda s: tuple(s.shape), jlm.abstract_params(jcfg))
    got = jax.tree.map(lambda t: tuple(t.shape),
                       tlm.init_params(tcfg, 0, device="cpu"))
    assert got == want
    assert ("embed" in got) == (tcfg.frontend != "audio")


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_jax(models, name):
    jp, tp = models(name)
    jcfg, tcfg = _cfgs(name)
    tokens, patches, frames = _inputs(tcfg, 1)
    want, _ = jlm.forward(jp, jcfg, tokens=_j(tokens), patches=_j(patches),
                          frames=_j(frames))
    got = tlm.forward(tp, tcfg, tokens, patches=patches, frames=frames)
    prefix = 0 if patches is None else tcfg.n_patches
    assert got.shape == want.shape == (B, prefix + T, tcfg.vocab_padded())
    np.testing.assert_allclose(_np(got), _np(want), atol=MODEL_TOL,
                               rtol=MODEL_TOL)


@pytest.mark.parametrize("name", DECODERS)
def test_prefill_and_greedy_decode_match_jax(models, name):
    jp, tp = models(name)
    jcfg, tcfg = _cfgs(name)
    tokens, patches, _ = _inputs(tcfg, 2)
    off = 0 if patches is None else tcfg.n_patches
    max_len = off + T + STEPS
    jl, jc = jlm.prefill(jp, jcfg, tokens=_j(tokens), patches=_j(patches),
                         max_len=max_len, cache_dtype=jnp.float32)
    tl, tc = tlm.prefill(tp, tcfg, tokens, patches=patches, max_len=max_len,
                         cache_dtype=torch.float32)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    jt = jnp.argmax(jl[:, :jcfg.vocab], -1).astype(jnp.int32)
    tt = tl[:, :tcfg.vocab].argmax(-1)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for i in range(STEPS):
        jl, jc = jlm.decode_step(jp, jcfg, jc, jt, jnp.int32(off + T + i))
        tl, tc = tlm.decode_step(tp, tcfg, tc, tt, off + T + i)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=MODEL_TOL,
                                   rtol=MODEL_TOL)
        jt = jnp.argmax(jl[:, :jcfg.vocab], -1).astype(jnp.int32)
        tt = tl[:, :tcfg.vocab].argmax(-1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_vision_prefill_last_logits_equal_forward(models):
    _, tp = models("internvl2-1b")
    _, tcfg = _cfgs("internvl2-1b")
    tokens, patches, _ = _inputs(tcfg, 3)
    last, cache = tlm.prefill(tp, tcfg, tokens, patches=patches)
    full = tlm.forward(tp, tcfg, tokens, patches=patches)
    np.testing.assert_allclose(_np(last), _np(full[:, -1]), atol=LAYER_TOL)
    # the cache holds the prefix and the prompt
    assert cache["units"]["0"]["k"].shape[2] == tcfg.n_patches + T


def test_hubert_frames_are_the_input_and_it_has_no_decode(models):
    _, tp = models("hubert-xlarge")
    _, tcfg = _cfgs("hubert-xlarge")
    assert "embed" not in tp
    _, _, frames = _inputs(tcfg, 4)
    full = tlm.forward(tp, tcfg, frames=frames)
    # bidirectional: the first frame's logits see the last frame
    moved = frames.copy()
    moved[:, -1] += 1.0
    other = tlm.forward(tp, tcfg, frames=moved)
    assert not torch.allclose(full[:, 0], other[:, 0])
    last, cache = tlm.prefill(tp, tcfg, frames=frames)
    np.testing.assert_allclose(_np(last), _np(full[:, -1]), atol=LAYER_TOL)
    with pytest.raises(ValueError, match="encoder-only"):
        tlm.decode_step(tp, tcfg, cache, torch.zeros(B, dtype=torch.long), T)


def test_serve_exits_for_the_encoder_as_the_reference_does():
    argv = ["--arch", "hubert-xlarge", "--smoke"]
    with pytest.raises(SystemExit, match="encoder-only") as want:
        jserve.main(argv)
    with pytest.raises(SystemExit, match="encoder-only") as got:
        tserve.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", DECODERS)
def test_serve_smoke_runs_each_decoder(name, capsys):
    gen = tserve.main(["--arch", name, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    cfg = treg.get_smoke(name)
    assert gen.shape == (2, 3) and gen.min() >= 0 and gen.max() < cfg.vocab
    out = capsys.readouterr().out
    assert f"arch={cfg.name}" in out
    if cfg.frontend == "vision":
        assert f"after {cfg.n_patches} patches" in out


def test_serve_vision_greedy_loop_matches_a_direct_loop():
    """launch.serve's internvl2 tokens equal a direct loop with the same
    seeded weights and patches, the decode positions after the prefix."""
    argv = ["--arch", "internvl2-1b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "5", "--gen", "4", "--seed", "3"]
    gen = tserve.main(argv)
    cfg = dataclasses.replace(treg.get_smoke("internvl2-1b"),
                              attn_impl="kernel", block_impl="fused")
    params = tlm.init_params(cfg, 3, "cpu")
    rng = np.random.default_rng(3)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 5)))
    patches = torch.from_numpy(rng.standard_normal(
        (2, cfg.n_patches, cfg.d_model)).astype(np.float32)) * 0.02
    off = cfg.n_patches
    logits, cache = tlm.prefill(params, cfg, prompts, patches=patches,
                                max_len=off + 5 + 4)
    tok = logits[:, :cfg.vocab].argmax(-1)
    want = [tok]
    for i in range(3):
        logits, cache = tlm.decode_step(params, cfg, cache, tok, off + 5 + i)
        tok = logits[:, :cfg.vocab].argmax(-1)
        want.append(tok)
    np.testing.assert_array_equal(gen, torch.stack(want, 1).numpy())


def test_serve_layers_cuts_the_depth_only(capsys):
    gen = tserve.main(["--arch", "qwen2-72b", "--smoke", "--device", "cpu",
                       "--layers", "1", "--batch", "2", "--prompt-len", "4",
                       "--gen", "2"])
    assert gen.shape == (2, 2)
    out = capsys.readouterr().out
    assert "depth cut to 1 of 2 layers" in out
    cfg = dataclasses.replace(treg.get_smoke("qwen2-72b"), n_layers=1)
    assert f"params={cfg.param_count():,}" in out


# --- attention features at the layer -------------------------------------------

# (feature, arch, config overrides): qk_norm (qwen3), qkv_bias (qwen2),
# partial rotary with qkv_bias (glm4), head_pad on qwen3's and internvl2's
# smoke GQA (4 -> 6 query heads over 2 KV), the non-causal encoder (hubert)
# at the smoke head dim and at hubert's 80.
FEATURES = [
    ("qk_norm", "qwen3-14b", {}),
    ("qkv_bias", "qwen2-72b", {}),
    ("rope_fraction", "glm4-9b", {}),
    ("head_pad", "qwen3-14b", {"head_pad": 2}),
    ("head_pad", "internvl2-1b", {"head_pad": 2}),
    ("non_causal", "hubert-xlarge", {}),
    ("non_causal_d80", "hubert-xlarge", {"head_dim": 80}),
]
HAS = {"qk_norm": lambda c: c.qk_norm and not c.qkv_bias,
       "qkv_bias": lambda c: c.qkv_bias and c.rope_fraction == 1.0,
       "rope_fraction": lambda c: c.qkv_bias and c.rope_fraction == 0.5,
       "head_pad": lambda c: c.n_heads_padded == c.n_heads + 2,
       "non_causal": lambda c: not c.causal,
       "non_causal_d80": lambda c: not c.causal and c.head_dim_ == 80}


def _layer_params(jcfg, seed):
    """One attention layer's weights: JAX's init (for the layout, pad heads
    zero) with seeded biases and q/k norm scales."""
    p = jax.tree.map(np.asarray, jL.init_attention(jax.random.PRNGKey(seed),
                                                   jcfg))
    p = _perturb(p, np.random.default_rng(seed))
    if jcfg.head_pad:   # keep the pad heads' query bias zero, as init does
        g, gp = jcfg.n_heads // jcfg.n_kv_heads, jcfg.n_heads_padded // \
            jcfg.n_kv_heads
        bq = p["bq"].reshape(jcfg.n_kv_heads, gp, -1) if "bq" in p else None
        if bq is not None:
            bq[:, g:] = 0.0
    return p


@pytest.mark.parametrize("attn_impl", ["reference", "fused", "kernel"])
@pytest.mark.parametrize("feature,name,over", FEATURES,
                         ids=[f"{f}-{n}" for f, n, _ in FEATURES])
def test_attention_feature_matches_jax(feature, name, over, attn_impl):
    jcfg, tcfg = _cfgs(name, attn_impl, **over)
    assert HAS[feature](tcfg)
    p = _layer_params(jcfg, 7)
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    x = np.random.default_rng(8).standard_normal(
        (B, 24, tcfg.d_model)).astype(np.float32)
    want = jL.attention_layer(jnp.asarray(x), jp, jcfg, local=False)
    got = tL.attention_layer(torch.from_numpy(x), tp, tcfg, local=False)
    np.testing.assert_allclose(_np(got), _np(want), atol=LAYER_TOL,
                               rtol=LAYER_TOL)
    if not tcfg.causal:
        return
    # prefill into an f32 cache, then decode steps against it
    jc = jL.init_kv_cache(jcfg, B, 28, local=False, dtype=jnp.float32)
    tc = tL.init_kv_cache(tcfg, B, 28, local=False, dtype=torch.float32)
    jy, jc = jL.attention_prefill(jnp.asarray(x), jp, jcfg, jc, local=False)
    ty, tc = tL.attention_prefill(torch.from_numpy(x), tp, tcfg, tc,
                                  local=False)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=LAYER_TOL,
                               rtol=LAYER_TOL)
    rng = np.random.default_rng(9)
    for step in range(2):
        xs = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
        jy, jc = jL.attention_decode(jnp.asarray(xs), jp, jcfg, jc,
                                     jnp.int32(24 + step), local=False)
        ty, tc = tL.attention_decode(torch.from_numpy(xs), tp, tcfg, tc,
                                     24 + step, local=False)
        np.testing.assert_allclose(_np(ty), _np(jy), atol=LAYER_TOL,
                                   rtol=LAYER_TOL)


@pytest.mark.parametrize("name", ["qwen3-14b", "internvl2-1b"])
def test_head_pad_is_exact_against_the_unpadded_layer(name):
    """Zero pad heads, inserted per KV group, leave the layer's output that
    of the unpadded heads (the port's own init pads as JAX's does)."""
    jcfg, tcfg = _cfgs(name, head_pad=2)
    p = _layer_params(jcfg, 11)
    hkv, hp, hd = tcfg.n_kv_heads, tcfg.n_heads_padded, tcfg.head_dim_
    g, gp = tcfg.n_heads // hkv, hp // hkv
    real = np.zeros((hkv, gp), bool)
    real[:, :g] = True
    real = real.reshape(hp)
    unpadded = dict(p, wq=p["wq"][:, real], wo=p["wo"][real])
    if "bq" in p:
        unpadded["bq"] = p["bq"][real]
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (B, 16, tcfg.d_model)).astype(np.float32))
    tcfg0 = dataclasses.replace(tcfg, head_pad=0)
    for impl in ("reference", "fused", "kernel"):
        padded = tL.attention_layer(
            x, {k: torch.from_numpy(v.copy()) for k, v in p.items()},
            dataclasses.replace(tcfg, attn_impl=impl), local=False)
        plain = tL.attention_layer(
            x, {k: torch.from_numpy(np.array(v))
                for k, v in unpadded.items()},
            dataclasses.replace(tcfg0, attn_impl=impl), local=False)
        np.testing.assert_allclose(_np(padded), _np(plain), atol=LAYER_TOL,
                                   rtol=LAYER_TOL)
    own = tL.init_attention(torch.Generator().manual_seed(0), tcfg)
    for k in ("wq", "wo"):
        assert torch.equal(own[k] == 0, torch.from_numpy(p[k] == 0)), k


# --- decode attention in the grouped-GQA form ----------------------------------

# (case, arch, overrides, local, cache dtype): the head ratios and masks the
# decode attention's grouped form has to map, each case in the cache dtypes
# the layer tests above and tests/test_torch_lm.py do not already run it in
DECODE_CASES = [
    ("gqa_32_2", "glm4-9b", {"n_heads": 32, "head_dim": 32}, False, "f32"),
    ("gqa_32_2", "glm4-9b", {"n_heads": 32, "head_dim": 32}, False, "bf16"),
    ("mqa_ring", "recurrentgemma-9b", {}, True, "f32"),
    ("mqa_ring", "recurrentgemma-9b", {}, True, "bf16"),
    ("mha", "qwen2-moe-a2.7b", {}, False, "f32"),
    ("mha", "qwen2-moe-a2.7b", {}, False, "bf16"),
    ("softcap_ring", "gemma2-9b", {}, True, "bf16"),
    ("head_pad", "qwen3-14b", {"head_pad": 2}, False, "bf16"),
]
# tests/test_kernels.py's tolerances: f32, and a bf16 cache
DECODE_TOL = {"f32": LAYER_TOL, "bf16": 2e-2}


@pytest.mark.parametrize("case,name,over,local,dt", DECODE_CASES,
                         ids=[f"{c[0]}-{c[4]}" for c in DECODE_CASES])
def test_decode_attention_matches_jax(case, name, over, local, dt):
    """The one-device ``attention_decode`` against the reference's on the
    same weights and a seeded cache: GQA 32/2, MQA and gemma2's softcap
    over a ring buffer (window 16, positions past it), MHA, pad heads."""
    jcfg, tcfg = _cfgs(name, **over)
    assert tcfg.n_heads_padded // tcfg.n_kv_heads == {
        "gqa_32_2": 16, "mqa_ring": 4, "mha": 1, "softcap_ring": 2,
        "head_pad": 3}[case]
    assert bool(local and tcfg.window) == case.endswith("_ring")
    assert (tcfg.attn_softcap is not None) == (case == "softcap_ring")
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    p = _layer_params(jcfg, 13)
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    max_len, pos0 = 28, 24
    size = min(max_len, tcfg.window) if local and tcfg.window else max_len
    rng = np.random.default_rng(14)
    shape = (B, size, tcfg.n_kv_heads, tcfg.head_dim_)
    kv = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    jc = {n: jnp.asarray(a, jdt) for n, a in zip("kv", kv)}
    tc = {n: torch.from_numpy(a).to(tdt) for n, a in zip("kv", kv)}
    tol = DECODE_TOL[dt]
    for step in range(2):
        xs = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
        jy, jc = jL.attention_decode(jnp.asarray(xs), jp, jcfg, jc,
                                     jnp.int32(pos0 + step), local=local)
        ty, tc = tL.attention_decode(torch.from_numpy(xs), tp, tcfg, tc,
                                     pos0 + step, local=local)
        np.testing.assert_allclose(_np(ty), _np(jy), atol=tol, rtol=tol)
        for n in "kv":
            np.testing.assert_allclose(_np(tc[n]), _np(jc[n]), atol=tol,
                                       rtol=tol)


@pytest.mark.parametrize("name", ["glm4-9b", "gemma2-9b", "qwen2-moe-a2.7b",
                                  "recurrentgemma-9b",
                                  "llama4-scout-17b-a16e"])
def test_decode_step_repeats_no_kv_head(name, monkeypatch):
    """A whole decode step calls ``repeat_kv`` nowhere: the prefill's plain
    attention does (the count sees it), the decode attention's grouped form
    reads each KV head in place."""
    calls = []
    plain = tL.repeat_kv

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)
    monkeypatch.setattr(tL, "repeat_kv", counted)
    cfg = dataclasses.replace(treg.get_smoke(name), attn_impl="reference")
    params = tlm.init_params(cfg, 0, "cpu", torch.float32)
    tokens = torch.randint(0, cfg.vocab, (B, 8),
                           generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        logits, cache = tlm.prefill(params, cfg, tokens, max_len=12,
                                    cache_dtype=torch.bfloat16)
        assert calls
        del calls[:]
        for i in range(2):
            tok = logits[:, :cfg.vocab].argmax(-1)
            logits, cache = tlm.decode_step(params, cfg, cache, tok, 8 + i)
    assert torch.isfinite(logits).all()
    assert not calls
