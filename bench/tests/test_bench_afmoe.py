"""The Trinity-Mini cell: its files found by name, the afmoe count of work
against hand counts, the frozen afmoe reference against the port's CPU
path at smoke size, and whole runs of the cell on the CPU."""

import dataclasses
import json

import pytest
import torch

from bench import cost_afmoe, harness
from bench.reference import afmoe_lm

TRINITY = "trinity-mini.prefill_8k"
# the port's smoke config of trinity-mini, as the benchmark's arch keys
SMOKE_ARCH = dict(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
                  head_dim=16, d_ff=96, vocab=256, window=8)
SMOKE_MOE = dict(n_experts=8, top_k=3, d_ff_expert=32, shared_d_ff=32)


@pytest.fixture(scope="module")
def afmoe_root(smoke_root):
    """The smoke copy with trinity-mini cut to the port's smoke widths, in
    float32, and its prefill to a short prompt."""
    path = smoke_root / "bench" / "configs" / "trinity-mini.json"
    cfg = json.loads(path.read_text())
    cfg["arch"].update(SMOKE_ARCH, dtype="float32")
    cfg["arch"]["moe"].update(SMOKE_MOE)
    path.write_text(json.dumps(cfg))
    mix = smoke_root / "bench" / "workloads" / "prefill_8k.json"
    mix.write_text(json.dumps({**json.loads(mix.read_text()),
                               "prompt_len": 24, "pool": 4,
                               "check_requests": 2}))
    return smoke_root


def test_the_files_of_the_cell_are_found_by_name():
    p = harness.plan(TRINITY)
    assert p.family.System and p.reference.logits and p.kind.window
    assert p.family.arch_config(p.cfg["arch"]).param_count() == \
        26_123_970_560
    names = {m["name"] for m in p.per_layer}
    assert names == {"idle_share.trinity_prefill", "mfu.trinity_prefill",
                     "ffn_roofline.trinity_prefill",
                     "moe_roofline.trinity_prefill",
                     "moe_host_ms.trinity_prefill"}
    for name in names:
        assert p.metric(name).read
    assert p.metric("mfu.trinity_prefill").__file__.endswith(
        "mfu.trinity_prefill.py")
    assert [m["name"] for m in p.end_to_end] == ["ttft_p90_ms", "setup_s"]


def test_the_count_of_work_matches_a_hand_count():
    arch = dict(n_layers=4, d_model=8, n_heads=2, n_kv_heads=1, head_dim=4,
                d_ff=12, vocab=10, window=2, n_dense_layers=1,
                pattern=["attn_local", "attn"],
                moe=dict(n_experts=6, top_k=2, d_ff_expert=3, shared_d_ff=3))
    # per token: attention 8*(2*2 + 2*1)*4 + 2*4*8 = 256 a layer; the dense
    # layer 3*8*12 = 288; an MoE layer's router 48, 2 experts and the
    # shared one 3*(3*8*3) = 216
    per_token = 2 * (4 * 256 + 288 + 3 * (48 + 216))
    # 3 tokens: local layers (0, 2) see 1, 2, 2 keys, full ones 1, 2, 3
    ctx = 2 * 5 + 2 * 6
    want = per_token * 3 + 4 * 2 * 4 * ctx + 2 * 8 * 10
    assert cost_afmoe.flops(arch, "prefill", 1, 3) == want
    assert cost_afmoe.flops(arch, "prefill", 2, 3) == 2 * want
    # a decode step at position 3: local layers 2 keys, full ones 4
    assert cost_afmoe.flops(arch, "decode", 1, 3) == \
        per_token + 4 * 2 * 4 * (2 * 2 + 2 * 4) + 2 * 8 * 10
    shapes = ((((5, 8), 2), ((5, 2), 8), ((5, 2), 4), ((6, 8, 3), 2),
               ((6, 8, 3), 2), ((6, 3, 8), 2)), {"act": "silu"})
    assert cost_afmoe.experts_call(shapes) == (2 * 3 * 5 * 2 * 8 * 3,
                                               2 * 2 * 5 * 8 + 2 * 3 * 2 * 8
                                               * 3)


def test_the_frozen_reference_equals_the_ports_cpu_path(afmoe_root):
    from repro_torch.models import lm
    p = harness.plan(TRINITY, afmoe_root)
    system = p.family.System(p.cfg, 2**31 + 9, "cpu")
    assert system.weights["units"]["0"]["sub2"]["route_bias"].abs().max() > 0
    tok = torch.randint(0, 256, (2, 20), generator=torch.Generator()
                        .manual_seed(9))
    cfg = dataclasses.replace(system.arch, attn_impl="reference",
                              block_impl="reference")
    want = afmoe_lm.logits(*system.reference_args, tok, list(range(20)))
    got = lm.forward(system.weights, cfg, tok)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    low = afmoe_lm.logits(*system.reference_args, tok, [19],
                          cast=afmoe_lm.fp8_matrix)
    assert afmoe_lm.compare(want[:, 19:], low.argmax(-1), low)[
        "logit_rel_err"] > 1e-3


@pytest.mark.parametrize("traced", [False, True])
def test_the_cell_runs_correct_on_the_cpu(afmoe_root, traced):
    p = harness.plan(TRINITY, afmoe_root)
    out = harness.run(p, 2**31 + 21, 0.3, traced, "cpu", 0.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    if not traced:
        assert set(out["metrics"]) == {m["name"] for m in p.end_to_end}

