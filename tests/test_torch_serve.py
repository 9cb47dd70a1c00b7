"""The port's serving entry point, its no-silent-CPU contract, and its
independence from JAX and from the reference package."""

import dataclasses
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import registry as treg
from repro_torch.launch import serve
from repro_torch.models import lm as tlm
from repro_torch.models import mobilenetv2 as tmnv2

SRC = Path(__file__).resolve().parents[1] / "src"


def test_serve_mobilenet_cpu_returns_forward_argmax(capsys):
    preds = serve.main(["--mobilenet", "--batch", "2", "--device", "cpu"])
    net = tmnv2.init_and_quantize(0, img_hw=80, device="cpu")
    imgs = np.random.default_rng(0).standard_normal(
        (2, 80, 80, 3)).astype(np.float32)
    want = tmnv2.forward_batch(imgs, net, use_kernel=True).argmax(-1)
    np.testing.assert_array_equal(preds, want.numpy())
    out = capsys.readouterr().out
    assert "batch 1 in" in out and "batch 2 in" in out and "img/s" in out


def test_serve_without_device_flag_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        serve.main(["--mobilenet", "--batch", "2"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        serve.main(["--arch", "gemma2-9b", "--smoke", "--batch", "2"])
    with pytest.raises(SystemExit):   # neither --arch nor --mobilenet
        serve.main(["--batch", "2", "--device", "cpu"])


@pytest.mark.parametrize("argv", [
    ["--batch", "2", "--device", "cpu"],
    ["--arch", "no-such-arch", "--smoke", "--device", "cpu"],   # unknown
    ["--arch", "gemma2-9b", "--smoke", "--gen", "0", "--device", "cpu"],
    ["--arch", "gemma2-9b", "--attn-impl", "pallas", "--device", "cpu"],
])
def test_serve_usage_errors(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(argv)
    assert exc.value.code == 2
    assert "usage" in capsys.readouterr().err


def test_serve_lm_cpu_returns_greedy_loop_tokens(capsys):
    argv = ["--arch", "gemma2-9b", "--smoke", "--batch", "2",
            "--prompt-len", "20", "--gen", "5", "--device", "cpu"]
    gen = serve.main(argv)
    assert gen.shape == (2, 5)
    cfg = dataclasses.replace(treg.get_smoke("gemma2-9b"), attn_impl="kernel",
                              block_impl="fused")
    params = tlm.init_params(cfg, 0, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 20))
    logits, cache = tlm.prefill(params, cfg, prompts, max_len=25)
    tok = logits[:, :cfg.vocab].argmax(-1)
    want = [tok]
    for i in range(4):
        logits, cache = tlm.decode_step(params, cfg, cache, tok, 20 + i)
        tok = logits[:, :cfg.vocab].argmax(-1)
        want.append(tok)
    np.testing.assert_array_equal(gen, torch.stack(want, 1).numpy())
    out = capsys.readouterr().out
    assert "arch=gemma2-9b-smoke" in out and "tok/s" in out
    assert "attn=kernel ffn=fused" in out   # the defaults run both kernels


_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
assert not bad, bad
print("imported", len(sys.argv) - 1)
"""


def test_port_imports_with_jax_and_repro_blocked():
    names = ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
    for name in ("repro_torch.kernels.fused_dsc",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.kernels.fused_ffn", "repro_torch.models.lm",
                 "repro_torch.launch.serve"):
        assert name in names
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, *names],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert f"imported {len(names)}" in res.stdout
