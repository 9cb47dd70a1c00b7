"""A run with the timed path broken underneath comes out not correct: the
whole run but the look for a card, at smoke sizes on the CPU, once for
each fault the cell can have (one card: no exchange between cards)."""

import copy

import pytest
import torch

from bench import harness


def _answer_altered(mp):
    from repro_torch.models import mobilenetv2
    orig = mobilenetv2.forward_batch

    def fault(*a, **kw):
        y = orig(*a, **kw).clone()
        y[0, 0] = y[0, 0] ^ 1
        return y
    mp.setattr(mobilenetv2, "forward_batch", fault)


def _half_batch_frames(mp):
    from repro_torch.models import mobilenetv2
    orig = mobilenetv2.forward_batch

    def fault(imgs, *a, **kw):
        half = orig(imgs[:len(imgs) // 2], *a, **kw)
        return torch.cat([half, half])
    mp.setattr(mobilenetv2, "forward_batch", fault)


def _top_token_lowered(logits):
    logits = logits.clone()
    rows = torch.arange(len(logits))
    logits[rows, logits.argmax(-1)] -= 100.0
    return logits


def _prefill_token_altered(mp):
    from repro_torch.models import lm
    orig = lm.prefill

    def fault(*a, **kw):
        logits, cache = orig(*a, **kw)
        return _top_token_lowered(logits), cache
    mp.setattr(lm, "prefill", fault)


def _decode_token_altered(mp):
    from repro_torch.models import lm
    orig = lm.decode_step

    def fault(params, cfg, cache, token, pos):
        logits, cache = orig(params, cfg, cache, token, pos)
        return _top_token_lowered(logits), cache
    mp.setattr(lm, "decode_step", fault)


def _decode_state_unchanged(mp):
    from repro_torch.models import lm
    orig = lm.decode_step

    def fault(params, cfg, cache, token, pos):
        return orig(params, cfg, copy.deepcopy(cache), token, pos)[0], cache
    mp.setattr(lm, "decode_step", fault)


def _decode_half_batch(mp):
    from repro_torch.models import lm
    orig = lm.decode_step

    def fault(params, cfg, cache, token, pos):
        logits, cache = orig(params, cfg, cache, token, pos)
        half = len(logits) // 2
        return torch.cat([logits[:half], logits[:half]]), cache
    mp.setattr(lm, "decode_step", fault)


FAULTS = [
    ("mbv2-vww-int8.frame_b1", _answer_altered),
    ("mbv2-vww-int8.offline_b256", _answer_altered),
    ("mbv2-vww-int8.offline_b256", _half_batch_frames),
    ("glm4-9b.prefill_1500", _prefill_token_altered),
    ("glm4-9b.decode_b16", _decode_token_altered),
    ("glm4-9b.decode_b16", _decode_state_unchanged),
    ("glm4-9b.decode_b16", _decode_half_batch),
]


def _run(smoke_root, cell):
    p = harness.plan(cell, smoke_root)
    if "arch" in p.cfg:
        p.cfg["arch"]["dtype"] = "float32"
    return harness.run(p, 2**31 + 29, 0.5, False, "cpu", 0.0)


@pytest.mark.parametrize("cell", sorted({c for c, _ in FAULTS}))
def test_sound_run_is_correct(smoke_root, cell):
    out = _run(smoke_root, cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}"
                              for c, f in FAULTS])
def test_fault_is_not_correct(smoke_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = _run(smoke_root, cell)
    assert out["correct"] is False, out["checks"]
