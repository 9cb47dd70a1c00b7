"""Trinity-Mini (``afmoe``) on the port against its plain float32 reference
(``repro_torch/reference/afmoe.py``), which imports nothing of the port.

On the CPU, at the smoke size in float32: prefill logits and decode steps
past the window through the ring cache equal the reference's full forward;
the sigmoid router picks by score plus bias and weights by the unbiased
scores; the dropless layer computes every assignment however uneven the
routes; the spans and their counters; the parameter count. The tolerance
is the f32 one of tests/test_kernels.py (2e-5), the two computing the same
products in another order. On a card (``-m gpu``), at the published widths:
the experts' entry without a host synchronisation, and a prefill of 8,192
ids and 32 decode steps held to the benchmark cell's logit limit. The
module imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_afmoe.py
"""

import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.configs.base import PortArchConfig
from repro_torch.models import lm
from repro_torch.models import moe
from repro_torch.runtime import sharding, trace

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "src" / "repro_torch" / "reference" / "afmoe.py"
LIMITS = ROOT / "bench" / "limits" / "trinity-mini.prefill_8k.json"
TOL = 2e-5


def load_reference():
    spec = importlib.util.spec_from_file_location("afmoe_reference",
                                                  REFERENCE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = load_reference()


def smoke(**over):
    return dataclasses.replace(registry.get_smoke("trinity-mini"),
                               dtype="float32", **over)


def smoke_model(seed=0, **over):
    cfg = smoke(**over)
    return cfg, lm.init_params(cfg, seed, device="cpu", dtype=torch.float32)


def tokens(cfg, n, length, seed=0):
    return torch.randint(0, cfg.vocab, (n, length),
                         generator=torch.Generator().manual_seed(seed))


def close(got, want, tol=TOL):
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("attn_impl,block_impl", [
    ("kernel", "fused"), ("fused", "fused"), ("reference", "reference")])
def test_prefill_logits_match_the_reference(attn_impl, block_impl):
    cfg, params = smoke_model(attn_impl=attn_impl, block_impl=block_impl)
    tok = tokens(cfg, 2, 20)
    got, _ = lm.prefill(params, cfg, tok, max_len=20,
                        cache_dtype=torch.float32)
    want = ref.logits(params, dataclasses.asdict(cfg), tok, [19])[:, 0]
    close(got, want)
    close(lm.forward(params, cfg, tok),
          ref.logits(params, dataclasses.asdict(cfg), tok, list(range(20))))


def test_decode_past_the_window_matches_the_reference_forward():
    """A prefill of 6 ids (shorter than the window of 8), then 18 decode
    steps through the ring cache, each step's logits against the
    reference's full forward at that position."""
    cfg, params = smoke_model(seed=1, attn_impl="kernel")
    tok = tokens(cfg, 2, 24, seed=1)
    want = ref.logits(params, dataclasses.asdict(cfg), tok, list(range(24)))
    got, cache = lm.prefill(params, cfg, tok[:, :6], max_len=24,
                            cache_dtype=torch.float32)
    close(got, want[:, 5])
    assert cache["lead"]["0"]["k"].shape[1] == cfg.window
    for pos in range(6, 24):
        got, cache = lm.decode_step(params, cfg, cache, tok[:, pos], pos)
        close(got, want[:, pos])


def test_the_bias_picks_the_experts_and_the_scores_weight_them():
    m = registry.get_smoke("trinity-mini").moe
    d = 4
    x = torch.eye(d)[:2]                      # token i reads router row i
    router = torch.zeros(d, m.n_experts)
    router[0] = torch.tensor([3.0, 2.0, 1.0, 0.5, 0.0, -1.0, -2.0, -3.0])
    router[1] = torch.tensor([-3.0, -2.0, -1.0, 0.0, 0.5, 1.0, 2.0, 3.0])
    bias = torch.zeros(m.n_experts)
    bias[7] = 1.0          # lifts expert 7 into token 0's top 3
    bias[5] = -1.0         # drops expert 5 from token 1's top 3
    scores, gates, ids = moe._route(x, {"router": router,
                                        "route_bias": bias}, m)
    s = torch.sigmoid(x @ router)
    assert sorted(ids[0].tolist()) == [0, 1, 7]
    assert sorted(ids[1].tolist()) == [4, 6, 7]
    want = s.gather(-1, ids)
    close(gates, want / want.sum(-1, keepdim=True) * m.route_scale)
    close(gates.sum(-1), torch.full((2,), m.route_scale))
    close(scores, s)
    rid, rgates = ref.routes(x, {"router": router, "route_bias": bias},
                             dataclasses.asdict(m))
    assert torch.equal(rid, ids)
    close(rgates, gates)


def moe_counters():
    return [r.args for r in trace.records("moe.dispatch")]


def test_every_token_to_the_same_experts_is_computed_dropless():
    """A bias that sends all 64 tokens to the same 3 experts: capacity
    routing would drop most of them, the dropless layer none."""
    cfg, params = smoke_model(seed=2)
    p = params["units"]["0"]["sub2"]
    p = {k: (v[0] if torch.is_tensor(v) else {j: w[0] for j, w in v.items()})
         for k, v in p.items()}
    p["route_bias"] = torch.zeros(cfg.moe.n_experts)
    p["route_bias"][[1, 4, 6]] = 100.0
    x = torch.randn(2, 32, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        y, aux = moe.moe_layer(x, p, cfg, layer=7)
    (layer,) = trace.records("moe.layer")
    assert layer.args == {"layer": 7, "tokens": 64, "assignments": 192}
    assert moe_counters() == [{"tokens": 64, "assignments": 192,
                               "experts_hit": 3, "max_load": 64,
                               "dropped": 0}]
    want = ref.moe(x.reshape(64, -1), p, dataclasses.asdict(cfg.moe))
    close(y.reshape(64, -1), want)
    assert float(aux) == 0.0
    trace.clear()


def test_offsets_that_miss_their_experts_count_as_dropped(monkeypatch):
    """Offsets shifted by one expert, so that each group's rows go to the
    product of the expert before theirs: the dropped counter reads every
    assignment so misplaced, and the output leaves the reference's."""
    cfg, params = smoke_model(seed=4)
    p = {k: (v[0] if torch.is_tensor(v) else {j: w[0] for j, w in v.items()})
         for k, v in params["units"]["0"]["sub2"].items()}
    x = torch.randn(2, 32, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    want = ref.moe(x.reshape(64, -1), p, dataclasses.asdict(cfg.moe))
    _, _, ids = moe._route(x.reshape(64, -1), p, cfg.moe)
    offsets = moe._offsets
    monkeypatch.setattr(moe, "_offsets",
                        lambda c: torch.cat([offsets(c)[1:], offsets(c)[-1:]]))
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        y, _ = moe.moe_layer(x, p, cfg, layer=2)
    (c,) = moe_counters()
    assert c["dropped"] == int((ids != 0).sum()) > 0
    assert not torch.allclose(y.reshape(64, -1), want, atol=1e-3, rtol=1e-3)
    trace.clear()


def test_param_count_is_the_published_models():
    cfg = registry.get("trinity-mini")
    assert cfg.param_count() == 26_123_970_560
    leaves = tree.leaves(lm.abstract_params(cfg, torch.bfloat16))
    biases = cfg.moe.n_experts * (cfg.n_layers - cfg.n_dense_layers)
    assert sum(t.numel() for t in leaves) - biases == cfg.param_count()
    assert cfg.lead_kinds == ("attn_local",) * 2 and cfg.n_units == 7
    assert cfg.tail_kinds == ("attn_local", "attn")
    kinds = cfg.lead_kinds + cfg.unit_pattern * cfg.n_units + cfg.tail_kinds
    assert kinds == cfg.layer_kinds()


def test_registry_and_mesh_keep_to_the_reference_architectures():
    assert "trinity-mini" in registry.PORT_ONLY
    assert "trinity-mini" not in registry.ARCH_NAMES
    assert all(c.arch != "trinity-mini" for c in registry.cells())
    assert isinstance(registry.get("trinity-mini"), PortArchConfig)
    assert not isinstance(registry.get("qwen2-moe-a2.7b"), PortArchConfig)
    with pytest.raises(NotImplementedError, match="C1"):
        sharding.batch_specs(registry.get("trinity-mini"),
                             {"data": 2, "model": 2}, {})


def test_the_reference_imports_no_jax_and_nothing_of_the_port():
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('r', {str(REFERENCE)!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'repro', 'repro_torch'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd="/")
    assert out.stdout.strip() == ""


def test_spans_and_counters_under_a_profile_change_no_number():
    cfg, params = smoke_model(seed=3, attn_impl="kernel")
    tok = tokens(cfg, 2, 10, seed=3)

    def run():
        logits, cache = lm.prefill(params, cfg, tok, max_len=12)
        step, _ = lm.decode_step(params, cfg, cache, logits.argmax(-1), 10)
        return logits, step

    off = run()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        on = run()
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    kinds = cfg.layer_kinds()
    moe_layers = list(range(cfg.n_dense_layers, cfg.n_layers))
    layers = trace.records("moe.layer")
    assert [r.args["layer"] for r in layers] == moe_layers * 2
    assert [r.args["tokens"] for r in layers] == \
        [20] * len(moe_layers) + [2] * len(moe_layers)
    by_index = {r.index: r for r in trace.records()}
    for name in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine"):
        recs = trace.records(name)
        assert len(recs) == len(layers)
        assert all(by_index[r.parent].name == "moe.layer" for r in recs)
    for c in moe_counters():
        assert c["dropped"] == 0
        assert 1 <= c["experts_hit"] <= cfg.moe.n_experts
        assert c["assignments"] / cfg.moe.n_experts <= c["max_load"] \
            <= c["tokens"]
    att = trace.records("lm.attention")
    assert [(r.args["layer"], r.args["local"]) for r in att] == \
        [(i, int(k == "attn_local")) for i, k in enumerate(kinds)] * 2
    trace.clear()


# --- on a card, at the published widths --------------------------------------


def limit() -> float:
    return json.loads(LIMITS.read_text())["logit_rel_err"]["limit"]


@pytest.mark.gpu
def test_experts_on_the_card_wait_on_no_host_and_match_a_loop():
    """The dropless entry at the prefill cell's shape (8,192 tokens, top 8
    of 128 experts of width 1024, d 2048, bf16) under the sync debug mode
    that raises on a host synchronisation, against a product per expert
    in f32 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grouped products run only there")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, k, e, d, f = 8192, 8, 128, 2048, 1024
    x = torch.randn(n, d, generator=gen, device="cuda").bfloat16()
    w = [(torch.randn(s, generator=gen, device="cuda") * s[1] ** -0.5
          ).bfloat16() for s in ((e, d, f), (e, d, f), (e, f, d))]
    # uneven routes: a skewed score, so that some experts get none
    score = torch.randn(n, e, generator=gen, device="cuda") \
        - torch.linspace(0, 6, e, device="cuda")
    ids = torch.topk(score, k, dim=-1).indices
    gates = torch.rand(n, k, generator=gen, device="cuda")
    moe.experts(x, ids, gates, *w)                    # warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe.experts(x, ids, gates, *w)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = torch.zeros(n, d, device="cuda")
    xf = x.float()
    for j in range(e):
        tok, slot = (ids == j).nonzero(as_tuple=True)
        if tok.numel():
            h = torch.nn.functional.silu(xf[tok] @ w[0][j].float()) \
                * (xf[tok] @ w[1][j].float())
            want.index_add_(0, tok, (h @ w[2][j].float())
                            * gates[tok, slot, None])
    err = (got.float() - want).norm() / want.norm()
    assert float(err) < 1e-2


@pytest.mark.gpu
def test_the_moe_layer_on_the_card_issues_no_synchronise():
    """The whole dropless layer at the prefill cell's shape (routing, the
    grouped experts, the shared expert's fused-FFN kernel, the counters of
    a profiled run) under a profile of the host and the card: no CUDA
    call that waits on the device lies inside its ``moe.layer`` span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grouped products run only there")
    cfg = dataclasses.replace(registry.get("trinity-mini"), n_layers=6,
                              block_impl="fused")
    params = lm.init_params(cfg, 1, device="cuda")
    p = {k: (v[0] if torch.is_tensor(v) else {j: w[0] for j, w in v.items()})
         for k, v in params["units"]["0"]["sub2"].items()}
    x = torch.randn(1, 8192, cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    moe.moe_layer(x, p, cfg, layer=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        moe.moe_layer(x, p, cfg, layer=2)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    spans = [e for e in events if e.name() == trace.PREFIX + "moe.layer"]
    waits = [e for e in events if e.name() in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize", "cudaMemcpy")]
    assert len(spans) == 1 and waits       # the closing synchronise is seen
    inside = [e.name() for e in waits
              if spans[0].start_ns() <= e.start_ns() <= spans[0].end_ns()]
    assert inside == []
    assert trace.records("moe.dispatch")[-1].args["dropped"] == 0
    trace.clear()


@pytest.mark.gpu
def test_trinity_prefill_and_decode_on_the_card_match_the_reference():
    """The published widths at the depth of the two dense layers and one
    period (6 layers), the benchmark's draw of the weights (its experts
    partly alike, ``bench/families/afmoe_lm.py``): a prefill of 8,192 ids
    through the flash kernel
    (window 2048 and NoPE at head dim 128), the fused FFN and the grouped
    experts, then 32 greedy decode steps through the ring cache; each
    position's logits against the f32 reference's full forward, under the
    benchmark cell's logit limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash, FFN and grouped products "
                    "run only there")
    sys.path.insert(0, str(ROOT))
    from bench.families import afmoe_lm
    cfg = dataclasses.replace(registry.get("trinity-mini"), n_layers=6,
                              attn_impl="kernel", block_impl="fused")
    params = afmoe_lm.draw(lm.abstract_params(cfg, torch.bfloat16),
                           dataclasses.asdict(cfg), 5, "cuda")
    t, steps = 8192, 32
    tok = torch.randint(0, cfg.vocab, (1, t), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(5))
    logits, cache = lm.prefill(params, cfg, tok, max_len=t + steps)
    got, seq = [logits], [tok]
    for i in range(steps):
        nxt = got[-1].argmax(-1)
        seq.append(nxt[:, None])
        logits, cache = lm.decode_step(params, cfg, cache, nxt, t + i)
        got.append(logits)
    del cache
    want = ref.logits(params, dataclasses.asdict(cfg), torch.cat(seq, 1),
                      list(range(t - 1, t + steps)))[0]
    got = torch.cat(got).float()
    err = (got - want).norm(dim=-1) / want.norm(dim=-1)
    print(f"trinity-mini, 6 layers: logit rel err max {float(err.max()):.5f}"
          f" (prefill {float(err[0]):.5f}), limit {limit()}")
    assert float(err.max()) <= limit()
