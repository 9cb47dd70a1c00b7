"""The dense decoder LM family (glm4-9b): served through the port's
``models/lm.py`` (``prefill``, then ``decode_step``) with the flash-attention
and fused-FFN kernels.

The configuration's ``arch`` holds the port's ``ArchConfig`` fields as they
are run. The benchmark draws the weights on the device from the seed, one
``torch.randn`` per stacked leaf, into the tree that ``lm.abstract_params``
describes: matrices in bf16, norm scales and the leaves the port keeps in
f32 in f32. The reference reads the same tree.
"""

from __future__ import annotations

import torch

ENTRY = "lm.prefill, then lm.decode_step"
COVERS = ("logits and served tokens through the embedding, every layer "
          "(flash attention, fused FFN), the final norm and the head")
NORM_SPREAD = 0.1      # norm scales are 1 + NORM_SPREAD * N(0, 1)
BIAS_SCALE = 0.1       # q, k, v biases are BIAS_SCALE * N(0, 1)


def fan_in(name: str, arch: dict) -> int:
    """The input width of a weight leaf, which scales its draw."""
    d, f = arch["d_model"], arch["d_ff"]
    widths = {"embed": d, "lm_head": d, "wq": d, "wk": d, "wv": d,
              "wo": arch["n_heads"] * arch["head_dim"], "w_gate": d,
              "w_up": d, "w_down": f}
    if name not in widths:
        raise KeyError(f"no draw for a weight leaf named {name!r}")
    return widths[name]


def draw(template: dict, arch: dict, seed: int, device) -> dict:
    """Weights shaped and typed as ``template`` (meta tensors), drawn on
    ``device`` from ``seed``, leaves in sorted order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def leaf(name, t):
        w = torch.randn(t.shape, generator=gen, dtype=t.dtype, device=device)
        if "norm" in name:
            return w.mul_(NORM_SPREAD).add_(1.0)
        if name in ("bq", "bk", "bv"):
            return w.mul_(BIAS_SCALE)
        return w.mul_(fan_in(name, arch) ** -0.5)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(node[k], k) for k in sorted(node)}
        return leaf(name, node)
    return walk(template)


class System:
    """The port's LM on ``device``, with the benchmark's weights."""

    def __init__(self, cfg: dict, seed: int, device):
        from repro_torch.configs.base import ArchConfig
        from repro_torch.models import lm
        self._lm = lm
        self.cfg = cfg
        self.arch = ArchConfig(**cfg["arch"])
        dtype = getattr(torch, cfg["arch"]["dtype"])
        template = lm.abstract_params(self.arch, dtype=dtype)
        self.weights = draw(template, cfg["arch"], seed, device)

    @property
    def reference_args(self):
        return self.weights, self.cfg["arch"]

    def prefill(self, tokens, max_len: int):
        """(last-position logits (B, V), cache) of prompts (B, T)."""
        return self._lm.prefill(self.weights, self.arch, tokens,
                                max_len=max_len)

    def decode(self, cache, token, pos: int):
        """Logits (B, V) of one step; ``token`` (B,) sits at ``pos``."""
        return self._lm.decode_step(self.weights, self.arch, cache, token,
                                    pos)[0]
