"""Architecture/config system (the port's own copy of the reference's
``repro.configs.base``, with the same fields and derived counts).

``ArchConfig`` is the single static description the LM consumes: the model
builds parameters from it and the launcher reads its analytic counts.
Configs are frozen dataclasses. Every ported architecture gets one module in
this package exporting ``CONFIG`` (full size, exact paper/HF numbers) and
``SMOKE`` (reduced same-family config for CPU tests).

In the port ``attn_impl`` takes ``reference | fused | kernel``: ``kernel`` is
the hand-written CUDA flash-attention kernel, the counterpart of the
reference's ``pallas``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    shared_d_ff: int = 0            # 0 = no shared expert path
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # The routing of the reference's MoE models: softmax scores, top-k
    # gates renormalized, capacity dispatch. A class attribute, not a
    # field, so that ``asdict`` stays the reference's; ``SigmoidMoESpec``
    # makes it one.
    score_func = "softmax"


@dataclasses.dataclass(frozen=True)
class SigmoidMoESpec(MoESpec):
    """Sigmoid-routed dropless experts (afmoe, DeepSeek-V3 style): scores
    sigmoid(h W_r) in f32; the top-k of the scores plus a per-expert
    selection bias pick the experts, the unbiased scores of those k,
    normalized to sum 1 and times ``route_scale``, weight them; every
    assignment is computed (no capacity)."""

    score_func: str = "sigmoid"
    route_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One cell of the (arch x shape) grid."""

    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The four assigned LM shapes (identical for every assigned arch).
LM_SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4096, 256, "train"),
    InputShape("prefill_32k", 32768, 32, "prefill"),
    InputShape("decode_32k", 32768, 128, "decode"),
    InputShape("long_500k", 524288, 1, "decode"),
)
SHAPES_BY_NAME: Dict[str, InputShape] = {s.name: s for s in LM_SHAPES}


# ---------------------------------------------------------------------------
# ArchConfig
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    act: str = "silu"
    gated: bool = True              # SwiGLU/GeGLU vs plain MLP
    causal: bool = True             # False: encoder (hubert)
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0      # glm4: 0.5 (partial rotary)
    qk_norm: bool = False           # qwen3
    qkv_bias: bool = False          # qwen2/glm4/qwen2-moe
    attn_softcap: Optional[float] = None    # gemma2: 50.0
    final_softcap: Optional[float] = None   # gemma2: 30.0
    sandwich_norm: bool = False     # gemma2 post-norms
    window: Optional[int] = None    # local-attention window
    embed_scale: bool = False       # gemma*: scale embeddings by sqrt(d)
    # Layer pattern: the repeating unit of layer kinds; layers follow the
    # pattern cyclically. Kinds: attn | attn_local | recurrent | rwkv.
    pattern: Tuple[str, ...] = ("attn",)
    moe: Optional[MoESpec] = None
    # RG-LRU (recurrentgemma) specifics
    conv_width: int = 4
    lru_width: int = 0              # 0 -> d_model
    # RWKV specifics
    rwkv_head_dim: int = 64
    # Modality frontend stub: None | audio | vision
    frontend: Optional[str] = None
    n_patches: int = 256            # vision-stub prefix length
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # --- execution knobs (the paper's technique toggles) -------------------
    # block_impl "reference" = layer-by-layer matmuls, the (tokens, d_ff)
    # intermediates materialized. "fused" = the chunk-streamed dataflow; on
    # a CUDA tensor it is the hand-written fused-FFN kernel.
    block_impl: str = "reference"   # reference | fused  (FFN dataflow)
    attn_impl: str = "fused"        # reference | fused | kernel
    # Training memory discipline. "full" = per-unit nothing-saveable remat:
    # each pattern unit's internals (incl. every fused-scan residual) are
    # recomputed in the backward pass — recompute-over-store, the paper's
    # trade, applied at unit granularity. "zero_buffer" refuses only the
    # named d_ff/score tensors; "none" saves everything.
    remat: str = "full"             # none | zero_buffer | full
    scan_layers: bool = True
    dtype: str = "bfloat16"
    ffn_chunk: int = 2048           # fused-FFN d_ff streaming chunk
    attn_chunk: int = 1024          # fused-attention k-block
    # Microbatching (gradient accumulation) per shape, e.g. {"train_4k": 8}.
    microbatches: Tuple[Tuple[str, int], ...] = ()
    # Zero-padded attention heads (§Perf: TP-shardability). Pad heads have
    # zero q/k/v/o weights, so the model output is EXACTLY that of the
    # unpadded arch (zero wo columns annihilate their contribution), but
    # the flat head dim becomes divisible by the 16-way model axis —
    # un-replicating attention for archs like qwen3 (40 -> 48 heads).
    head_pad: int = 0

    # Features of the architectures the port runs beyond the reference's
    # ten (``PortArchConfig``), off here. Class attributes, not fields, so
    # that the ten configs' ``asdict`` stays the reference's.
    n_dense_layers = 0              # leading layers with a dense FFN
    attn_gate = False               # a = a * sigmoid(h W_g) before W_o
    rope_local_only = False         # RoPE on attn_local layers; global NoPE

    # --- derived ------------------------------------------------------------

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_heads_padded(self) -> int:
        return self.n_heads + self.head_pad

    @property
    def lru_width_(self) -> int:
        return self.lru_width or self.d_model

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def vocab_padded(self, multiple: int = 16) -> int:
        """Physical vocab (padded so TP sharding divides evenly)."""
        if self.vocab < 10_000:
            return self.vocab          # tiny vocab: replicated, no padding
        return -(-self.vocab // multiple) * multiple

    @property
    def norm_plus_one(self) -> bool:
        """RMSNorm scales as (1 + w), gemma's convention, which the
        reference ties to ``embed_scale``."""
        return self.embed_scale

    def layer_kinds(self) -> Tuple[str, ...]:
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    @property
    def lead_kinds(self) -> Tuple[str, ...]:
        """The leading dense-FFN layers (unrolled, before the units)."""
        return self.layer_kinds()[:self.n_dense_layers]

    @property
    def unit_pattern(self) -> Tuple[str, ...]:
        """The layer kinds of one stacked unit: the pattern from the phase
        at which the units start, after the leading layers."""
        s = self.n_dense_layers % len(self.pattern)
        return self.pattern[s:] + self.pattern[:s] if s else self.pattern

    @property
    def n_units(self) -> int:
        return (self.n_layers - self.n_dense_layers) // len(self.pattern)

    @property
    def tail_kinds(self) -> Tuple[str, ...]:
        """Layers after the last whole pattern unit (unrolled, not scanned)."""
        rem = (self.n_layers - self.n_dense_layers) % len(self.pattern)
        return self.unit_pattern[:rem]

    def microbatch_for(self, shape_name: str) -> int:
        return dict(self.microbatches).get(shape_name, 1)

    # --- analytic model size / FLOPs ----------------------------------------

    def param_count(self) -> int:
        """Exact parameter count from the config (embeddings included)."""
        d, hd = self.d_model, self.head_dim_
        n = 0
        if self.frontend != "audio":                      # audio: frame stub
            n += self.vocab_padded() * d                  # embed
        if not self.tie_embeddings:
            n += d * self.vocab_padded()                  # lm head
        for layer, kind in enumerate(self.layer_kinds()):
            n += d                                        # pre-norm
            if self.sandwich_norm:
                n += d
            if kind in ("attn", "attn_local"):
                hp = self.n_heads_padded
                qkv = d * hp * hd + 2 * d * self.n_kv_heads * hd
                n += qkv + hp * hd * d
                if self.qkv_bias:
                    n += (hp + 2 * self.n_kv_heads) * hd
                if self.qk_norm:
                    n += 2 * hd
                if self.attn_gate:
                    n += d * hp * hd
            elif kind == "recurrent":
                w = self.lru_width_
                n += 2 * d * w + w * d                    # in x2, out
                n += self.conv_width * w + w              # temporal conv + b
                n += 2 * w * (w // self.n_heads)          # block-diag gates
                n += 2 * w + w                            # gate biases + Lambda
            elif kind == "rwkv":
                n += 4 * d * d + d * d                    # r,k,v,g,o
                n += 2 * self.n_rwkv_heads * self.rwkv_head_dim  # decay/bonus
                n += d * 64 + 64 * d                      # decay LoRA (A, B)
                n += d                                    # ln_x
                n += 7 * d                                # mu (5) + cm_mu (2)
            # FFN / MoE
            n += d                                        # ffn pre-norm
            if self.sandwich_norm:
                n += d
            if self.moe is not None and layer >= self.n_dense_layers:
                m = self.moe
                n += d * m.n_experts                      # router
                per = (2 if self.gated else 1) * d * m.d_ff_expert \
                    + m.d_ff_expert * d
                n += m.n_experts * per
                if m.shared_d_ff:
                    n += (2 if self.gated else 1) * d * m.shared_d_ff \
                        + m.shared_d_ff * d
            elif kind != "rwkv":   # rwkv channel-mix counted here too
                n += (2 if self.gated else 1) * d * self.d_ff + self.d_ff * d
            else:                                         # rwkv channel mix
                n += d * self.d_ff + self.d_ff * d + d * d  # k, v, receptance
        n += d                                            # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed-active experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        per = ((2 if self.gated else 1) * self.d_model * m.d_ff_expert
               + m.d_ff_expert * self.d_model)
        inactive = (m.n_experts - m.top_k) * per * (self.n_layers
                                                    - self.n_dense_layers)
        return self.param_count() - inactive

    def model_flops_per_token(self) -> float:
        """6*N_active per token (the §Roofline MODEL_FLOPS convention)."""
        return 6.0 * self.active_param_count()


@dataclasses.dataclass(frozen=True)
class PortArchConfig(ArchConfig):
    """An architecture the port runs that the reference does not: the
    features ``ArchConfig`` keeps off as class attributes are fields here.
    Its RMSNorm is the plain x * w whatever ``embed_scale``."""

    n_dense_layers: int = 0
    attn_gate: bool = False
    rope_local_only: bool = False

    @property
    def norm_plus_one(self) -> bool:
        return False


def reduced(cfg: ArchConfig, **over) -> ArchConfig:
    """A smoke-scale config of the same family (for CPU tests)."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 2 * max(1, len(cfg.pattern))),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab=512,
        lru_width=128 if cfg.lru_width_ else 0,
        rwkv_head_dim=32,
        n_patches=8,
        ffn_chunk=64,
        attn_chunk=32,
        window=min(cfg.window, 16) if cfg.window else None,
        microbatches=(),
        block_impl="fused",   # smoke tests exercise the paper's dataflow
        head_pad=0,           # padding exactness tested separately
    )
    if cfg.moe is not None:
        kw["moe"] = MoESpec(
            n_experts=min(cfg.moe.n_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
            shared_d_ff=64 if cfg.moe.shared_d_ff else 0,
            capacity_factor=cfg.moe.capacity_factor,
            router_aux_weight=cfg.moe.router_aux_weight,
        )
    kw.update(over)
    return dataclasses.replace(cfg, **kw)
