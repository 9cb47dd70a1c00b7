"""The frozen references against the port's plain CPU path at smoke sizes:
the int8 network exactly, glm4's smoke shape in float32 within float32's
rounding, and the reference's own blocks against plain formulas."""

import numpy as np
import pytest
import torch

from bench import harness
from bench.reference import dense_lm, mbv2_int8 as mbv2_ref
from conftest import ROOT


@pytest.mark.parametrize("seed", [0, 2**31 + 3])
def test_mbv2_reference_equals_the_port(seed):
    from repro_torch.models import mobilenetv2
    p = harness.plan("mbv2-vww-int8.frame_b1")
    system = p.family.System(p.cfg, seed, "cpu")
    imgs = np.random.default_rng(seed).standard_normal(
        (24, 80, 80, 3)).astype(np.float32)
    want = mbv2_ref.forward(system.tree, imgs)
    got = system.classify(torch.from_numpy(imgs)).numpy()
    assert np.array_equal(got, want)
    # the layer-by-layer v0 discipline too, and the logits are not constant
    v0 = mobilenetv2.forward_batch(torch.from_numpy(imgs), system.params,
                                   return_quantized=True).numpy()
    assert np.array_equal(v0, want)
    assert len({tuple(r) for r in want}) > 4


def test_mbv2_lower_precision_changes_the_weights():
    p = harness.plan("mbv2-vww-int8.frame_b1")
    tree = p.family.quantized_tree(p.cfg, 1)
    low = mbv2_ref.lower_precision(tree)
    for b, lb in zip(tree["blocks"], low["blocks"]):
        assert np.all(np.asarray(lb["w_proj"]) % 16 == 0)
        assert not np.array_equal(b["w_proj"], lb["w_proj"])


def _f32_smoke(smoke_root):
    p = harness.plan("glm4-9b.decode_b16", smoke_root)
    p.cfg["arch"]["dtype"] = "float32"
    return p, p.family.System(p.cfg, 11, "cpu")


def test_dense_lm_reference_equals_the_port_forward(smoke_root):
    """Float32 logits of the port's full forward pass (its plain paths)
    within float32 rounding of the reference's: 1e-4 of the logits' norm."""
    from repro_torch.models import lm
    p, system = _f32_smoke(smoke_root)
    tokens = torch.randint(0, p.cfg["arch"]["vocab"], (3, 40),
                           generator=torch.Generator().manual_seed(1))
    got = lm.forward(system.weights, system.arch, tokens)
    want = dense_lm.logits(*system.reference_args, tokens, list(range(40)))
    err = (got - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(err.max()) < 1e-4


def test_dense_lm_reference_follows_prefill_and_decode(smoke_root):
    """Prefill, then greedy decode through the bf16 KV cache: the served
    tokens' logits within 2% (the cache's bf16 rounding) and every served
    token the reference's best or within 1e-2 of it."""
    p, system = _f32_smoke(smoke_root)
    data = p.kind.inputs(p.mix, p.cfg, 11, "cpu")
    rec = p.kind.window(system, data, p.mix, 0.5)
    seqs, positions, served, logits = p.kind.sample(data, p.mix, rec, 11)
    ref = dense_lm.logits(*system.reference_args, seqs, positions)
    got = dense_lm.compare(ref, served, logits)
    assert got["logit_rel_err"] < 0.02
    assert got["token_logit_gap"] < 1e-2


def test_rope_and_rms_norm_by_hand():
    x = torch.tensor([[[[1.0, 2.0, 3.0, 4.0]]]])         # (1, 1, 1, 4)
    out = dense_lm.rope(x, torch.tensor([1]), 1.0, 10000.0)
    # pairs (dim 0, dim 2) at frequency 1 and (dim 1, dim 3) at 1e-2
    c0, s0 = np.cos(1.0), np.sin(1.0)
    c1, s1 = np.cos(0.01), np.sin(0.01)
    want = [1 * c0 - 3 * s0, 2 * c1 - 4 * s1, 3 * c0 + 1 * s0, 4 * c1 + 2 * s1]
    assert np.allclose(out.flatten().numpy(), want, atol=1e-6)
    half = dense_lm.rope(x, torch.tensor([1]), 0.5, 10000.0)
    assert np.allclose(half.flatten().numpy(),
                       [1 * c0 - 2 * s0, 2 * c0 + 1 * s0, 3, 4], atol=1e-6)
    y = dense_lm.rms_norm(torch.tensor([3.0, 4.0]), torch.tensor([1.0, 2.0]),
                          0.0)
    r = np.sqrt(12.5)
    assert np.allclose(y.numpy(), [3 / r, 8 / r])


def test_references_import_nothing_of_the_port():
    for name in ("dense_lm", "mbv2_int8"):
        src = (ROOT / "bench" / "reference" / f"{name}.py").read_text()
        assert "repro" not in src.replace("reproduc", "")
        assert "jax" not in src
