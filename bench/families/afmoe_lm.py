"""The afmoe decoder LM family (Trinity-Mini): sigmoid-routed dropless
experts beside a shared one, gated attention over sliding and NoPE global
layers, served through the port's ``models/lm.py`` (``prefill``, then
``decode_step``) with the flash-attention kernel, the fused-FFN kernel
(the dense layers and the shared expert) and the grouped expert products.

The configuration's ``arch`` holds the port's ``PortArchConfig`` fields as
they are run, ``moe`` those of its ``SigmoidMoESpec``. The benchmark draws
the weights on the device from the seed, one ``torch.randn`` per leaf of
the tree that ``lm.abstract_params`` describes, in sorted order: matrices
in bf16, norm scales, the router and the selection bias in f32. The
reference reads the same tree.

The routed experts of a layer are drawn alike in part: each matrix is
sqrt(EXPERT_SHARE) x one matrix the layer's experts share plus
sqrt(1 - EXPERT_SHARE) x its own, every entry still N(0, 1) x fan-in^-0.5.
With experts drawn apart (share 0), a pick that differs between two
precisions swaps in an unrelated expert, and over 30 MoE layers and 8,192
tokens the picks of any two precisions part: the program's picks differ
from the f32 reference's for 5% of tokens at the first MoE layer and 80%
at the last (``probes/afmoe_routing.py``), and the f32 reference itself,
its scaled embedding alone rounded once to bf16, lands 0.32-0.39 from its
own logits, as far as the program and the fp8 control
(``probes/afmoe_witness.py``). With the share, wrong dispatch still reads
0.32-0.67 against the limit of 0.14 (the same probe).
"""

from __future__ import annotations

import torch

ENTRY = "lm.prefill, then lm.decode_step"
COVERS = ("logits and served tokens through the embedding, every layer "
          "(flash attention with its gate, fused FFN, the routed and shared "
          "experts), the final norm and the head")
NORM_SPREAD = 0.1      # norm scales are 1 + NORM_SPREAD * N(0, 1)
BIAS_SCALE = 0.05      # the selection bias is BIAS_SCALE * N(0, 1)
EXPERT_SHARE = 0.9     # of each routed expert matrix's variance, shared


def fan_in(name: str, shape, arch: dict) -> int:
    """The input width of a weight leaf, which scales its draw: d_model for
    the embedding, the head, the q/k/v/gate projections and the router;
    H * head_dim for the output projection; an FFN or expert matrix's
    next-to-last axis, (stacked units, experts,) in, out."""
    if name in ("embed", "lm_head", "wq", "wk", "wv", "wg", "router"):
        return arch["d_model"]
    if name == "wo":
        return arch["n_heads"] * arch["head_dim"]
    if name in ("w_gate", "w_up", "w_down"):
        return shape[-2]
    raise KeyError(f"no draw for a weight leaf named {name!r}")


def draw(template: dict, arch: dict, seed: int, device,
         expert_share: float = EXPERT_SHARE) -> dict:
    """Weights shaped and typed as ``template`` (meta tensors), drawn on
    ``device`` from ``seed``, leaves in sorted order; a routed expert
    matrix (..., E, in, out), beside a router, its own part first, then
    the part its layer's experts share."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    def leaf(name, t, routed):
        w = randn(t.shape, t.dtype)
        if "norm" in name:
            return w.mul_(NORM_SPREAD).add_(1.0)
        if name == "route_bias":
            return w.mul_(BIAS_SCALE)
        if routed:
            common = randn(t.shape[:-3] + (1,) + t.shape[-2:], t.dtype)
            w.mul_((1 - expert_share) ** 0.5).add_(common,
                                                   alpha=expert_share ** 0.5)
        return w.mul_(fan_in(name, t.shape, arch) ** -0.5)

    def walk(node, name="", routed=False):
        if isinstance(node, dict):
            return {k: walk(node[k], k, "router" in node) for k in
                    sorted(node)}
        return leaf(name, node, routed and name.startswith("w_"))
    return walk(template)


def arch_config(arch: dict):
    """The port's config of the ``arch`` dict."""
    from repro_torch.configs.base import PortArchConfig, SigmoidMoESpec
    return PortArchConfig(**dict(arch, pattern=tuple(arch["pattern"]),
                                 moe=SigmoidMoESpec(**arch["moe"])))


class System:
    """The port's LM on ``device``, with the benchmark's weights."""

    def __init__(self, cfg: dict, seed: int, device,
                 expert_share: float = EXPERT_SHARE):
        from repro_torch.models import lm
        self._lm = lm
        self.cfg = cfg
        self.arch = arch_config(cfg["arch"])
        template = lm.abstract_params(self.arch,
                                      dtype=getattr(torch, self.arch.dtype))
        self.weights = draw(template, cfg["arch"], seed, device,
                            expert_share)

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
