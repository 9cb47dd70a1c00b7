"""Composable LM (port of ``repro.models.lm``), dense attention layers only,
with the reference's two modality stubs.

A model is assembled from an ``ArchConfig``: the layer *pattern* (for
gemma2, ``("attn_local", "attn")``) repeats over ``n_layers``. Whole pattern
units keep the reference's parameter layout, each leaf stacked on a leading
``n_units`` axis, and run in a Python loop (the reference's ``lax.scan``);
remainder layers are the "tail".

Every layer is a pre-norm residual pair (with gemma2's sandwich norms)

    x += post1(attn(norm1(x)))
    x += post2(ffn(norm2(x)))

and the FFN runs the paper's fused expand->mix->project dataflow when
``cfg.block_impl == "fused"``: on a card, the hand-written fused-FFN kernel.

Entry points:

    init_params(cfg, seed, device, dtype)      -> params
    params_from_numpy(tree, cfg, device, dtype) -> params
    forward(params, cfg, tokens, patches, frames) -> logits (B, T, V)
    prefill(params, cfg, tokens, patches, frames, max_len) -> (last logits,
                                                               cache)
    decode_step(params, cfg, cache, token, pos) -> (logits, cache)

Frontend stubs, as in the reference: ``frontend == "audio"`` (hubert) has
no token embedding and takes precomputed ``frames`` (B, T, d_model);
``frontend == "vision"`` (internvl2) prepends precomputed ``patches`` (B,
n_patches, d_model) to the token embeddings, so a decode step after such a
prefill is at ``pos`` = n_patches + prompt length + step.
``decode_step`` and ``prefill`` write the KV cache in place: the returned
cache is the one passed in (decode) or just allocated (prefill).
MoE, ``recurrent`` (RG-LRU) and ``rwkv`` layers are not ported yet.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import fused_ffn as ffnlib
from repro_torch.models import layers as L

Params = Dict[str, Any]

ATTN_KINDS = ("attn", "attn_local")
FRONTENDS = (None, "audio", "vision")
_NOT_PORTED = ("ROADMAP.md Queue 1, item 5: MoE, RG-LRU and RWKV6 layers "
               "come after the dense configs")


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE layers are not ported "
                                  f"yet ({_NOT_PORTED})")
    for kind in cfg.pattern:
        if kind not in ATTN_KINDS:
            raise NotImplementedError(f"{cfg.name}: layer kind {kind!r} is "
                                      f"not ported yet ({_NOT_PORTED})")
    if cfg.frontend not in FRONTENDS:
        raise ValueError(f"{cfg.name}: unknown frontend {cfg.frontend!r}; "
                         f"one of {FRONTENDS}")


# ---------------------------------------------------------------------------
# Per-layer init
# ---------------------------------------------------------------------------


def _normal(gen, shape, scale, device, dtype):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def init_ffn(gen: torch.Generator, cfg: ArchConfig, device=None,
             dtype=torch.float32) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    p = {}
    if cfg.gated:
        p["w_gate"] = _normal(gen, (d, f), d ** -0.5, device, dtype)
    p["w_up"] = _normal(gen, (d, f), d ** -0.5, device, dtype)
    p["w_down"] = _normal(gen, (f, d), f ** -0.5, device, dtype)
    return p


def init_layer(gen: torch.Generator, kind: str, cfg: ArchConfig, device=None,
               dtype=torch.float32) -> Params:
    """One layer's weights; norm scales are f32 ones whatever ``dtype``."""
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"layer kind {kind!r}: {_NOT_PORTED}")
    p: Params = {"norm1": L.init_rms(cfg.d_model, device),
                 "norm2": L.init_rms(cfg.d_model, device)}
    if cfg.sandwich_norm:
        p["post_norm1"] = L.init_rms(cfg.d_model, device)
        p["post_norm2"] = L.init_rms(cfg.d_model, device)
    p["sub1"] = L.init_attention(gen, cfg, device, dtype)
    p["sub2"] = init_ffn(gen, cfg, device, dtype)
    return p


# ---------------------------------------------------------------------------
# Per-layer apply (full sequence / prefill / decode)
# ---------------------------------------------------------------------------


def _norm(x, s, cfg):
    return L.rms_norm(x, s, eps=cfg.norm_eps, zero_centered=cfg.embed_scale)


def _ffn(h, p, cfg: ArchConfig):
    return ffnlib.ffn_apply(h, p, gated=cfg.gated, act_name=cfg.act,
                            impl=cfg.block_impl, chunk=cfg.ffn_chunk)


def _ffn_half(x, p, cfg: ArchConfig):
    y = _ffn(_norm(x, p["norm2"], cfg), p["sub2"], cfg)
    if cfg.sandwich_norm:
        y = _norm(y, p["post_norm2"], cfg)
    return x + y


def _attn_residual(x, y, p, cfg: ArchConfig):
    if cfg.sandwich_norm:
        y = _norm(y, p["post_norm1"], cfg)
    return x + y


def layer_apply(x, p: Params, kind: str, cfg: ArchConfig):
    """Full-sequence layer."""
    y = L.attention_layer(_norm(x, p["norm1"], cfg), p["sub1"], cfg,
                          local=(kind == "attn_local"))
    return _ffn_half(_attn_residual(x, y, p, cfg), p, cfg)


def init_layer_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None) -> Params:
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"layer kind {kind!r}: {_NOT_PORTED}")
    return L.init_kv_cache(cfg, batch, max_len, local=(kind == "attn_local"),
                           dtype=dtype, device=device)


def layer_prefill(x, p, kind, cfg, cache):
    y, cache = L.attention_prefill(_norm(x, p["norm1"], cfg), p["sub1"], cfg,
                                   cache, local=(kind == "attn_local"))
    return _ffn_half(_attn_residual(x, y, p, cfg), p, cfg), cache


def layer_decode(x, p, kind, cfg, cache, pos: int):
    y, cache = L.attention_decode(_norm(x, p["norm1"], cfg), p["sub1"], cfg,
                                  cache, pos, local=(kind == "attn_local"))
    return _ffn_half(_attn_residual(x, y, p, cfg), p, cfg), cache


# ---------------------------------------------------------------------------
# Whole-model parameters
# ---------------------------------------------------------------------------


def _stacked_units(gen, cfg: ArchConfig, device, dtype) -> Params:
    """The pattern units' layers, each leaf stacked on a leading n_units
    axis, filled one unit at a time so that the peak is one unit over the
    stack."""
    def unit():
        return {str(i): init_layer(gen, kind, cfg, device, dtype)
                for i, kind in enumerate(cfg.pattern)}

    def alloc(node):
        if isinstance(node, Mapping):
            return {k: alloc(v) for k, v in node.items()}
        return torch.empty((cfg.n_units,) + tuple(node.shape),
                           dtype=node.dtype, device=node.device)

    def fill(dst, src, u):
        if isinstance(src, Mapping):
            for k in src:
                fill(dst[k], src[k], u)
        else:
            dst[u].copy_(src)

    first = unit()
    stacked = alloc(first)
    fill(stacked, first, 0)
    del first
    for u in range(1, cfg.n_units):
        fill(stacked, unit(), u)
    return stacked


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda",
                dtype=None) -> Params:
    """Seeded random weights drawn on ``device`` from a ``torch.Generator``
    (not the reference's ``jax.random`` numbers). Matrices are stored in
    ``dtype`` (default ``cfg.dtype``), norm scales in f32."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype) if dtype is None else dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    vp, d = cfg.vocab_padded(), cfg.d_model
    p: Params = {}
    if cfg.frontend != "audio":   # audio: precomputed frames, no embedding
        p["embed"] = _normal(gen, (vp, d), d ** -0.5, dev, dt)
    if cfg.n_units > 0:
        p["units"] = _stacked_units(gen, cfg, dev, dt)
    if cfg.tail_kinds:
        p["tail"] = {str(i): init_layer(gen, kind, cfg, dev, dt)
                     for i, kind in enumerate(cfg.tail_kinds)}
    p["final_norm"] = L.init_rms(d, dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal(gen, (d, vp), d ** -0.5, dev, dt)
    return p


def params_from_numpy(tree, cfg: ArchConfig, device="cuda",
                      dtype=None) -> Params:
    """Carry the reference's parameter tree across: nested dicts of numpy
    arrays (``units`` stacked on a leading axis, as the reference stores
    them). Norm scales stay f32; every other leaf is cast to ``dtype``
    (default ``cfg.dtype``) once here, where the reference casts its f32
    masters at every use, so the values are the same."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype) if dtype is None else dtype

    def carry(node, name=""):
        if isinstance(node, Mapping):
            return {k: carry(v, k) for k, v in node.items()}
        t = torch.from_numpy(np.array(node, dtype=np.float32, copy=True))
        keep_f32 = "norm" in name
        return t.to(device=dev, dtype=torch.float32 if keep_f32 else dt)

    return carry(tree)


def _unit_layer(params: Params, u: int, i: int) -> Params:
    """Views of layer ``i`` of pattern unit ``u`` in the stacked tree."""
    def take(node):
        if isinstance(node, Mapping):
            return {k: take(v) for k, v in node.items()}
        return node[u]
    return take(params["units"][str(i)])


def _layers(params: Params, cfg: ArchConfig):
    """(layer params, kind, cache key) in execution order."""
    for u in range(cfg.n_units):
        for i, kind in enumerate(cfg.pattern):
            yield _unit_layer(params, u, i), kind, ("units", u, str(i))
    for i, kind in enumerate(cfg.tail_kinds):
        yield params["tail"][str(i)], kind, ("tail", None, str(i))


# ---------------------------------------------------------------------------
# Whole-model forward / prefill / decode
# ---------------------------------------------------------------------------


def _device(params) -> torch.device:
    return params["final_norm"].device


def _embed(params, cfg: ArchConfig, tokens, patches=None, frames=None):
    dt = getattr(torch, cfg.dtype)
    dev = _device(params)
    if cfg.frontend == "audio":
        return torch.as_tensor(frames, device=dev).to(dt)   # stub: frames
    x = params["embed"][_tokens(tokens, dev)].to(dt)
    if cfg.embed_scale:
        # sqrt(d_model) rounded to the compute dtype, multiplied in it
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=x.device)
    if cfg.frontend == "vision" and patches is not None:
        x = torch.cat([torch.as_tensor(patches, device=dev).to(dt), x], dim=1)
    return x


def _head(params, cfg: ArchConfig, x):
    x = _norm(x, params["final_norm"], cfg)
    w = (params["embed"].T if cfg.tie_embeddings
         else params["lm_head"]).to(x.dtype)
    logits = (x @ w).float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _tokens(tokens, device):
    return torch.as_tensor(tokens, dtype=torch.long, device=device)


def forward(params, cfg: ArchConfig, tokens=None, patches=None,
            frames=None):
    """Full-sequence forward: logits (B, T, Vp) in f32 (T counts the vision
    prefix)."""
    x = _embed(params, cfg, tokens, patches, frames)
    for p, kind, _ in _layers(params, cfg):
        x = layer_apply(x, p, kind, cfg)
    return _head(params, cfg, x)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Params:
    cache: Params = {}
    if cfg.n_units > 0:
        cache["units"] = {}
        for i, kind in enumerate(cfg.pattern):
            one = init_layer_cache(cfg, kind, batch, max_len, dtype, device)
            cache["units"][str(i)] = {
                k: torch.zeros((cfg.n_units,) + tuple(a.shape), dtype=dtype,
                               device=a.device) for k, a in one.items()}
    if cfg.tail_kinds:
        cache["tail"] = {str(i): init_layer_cache(cfg, kind, batch, max_len,
                                                  dtype, device)
                         for i, kind in enumerate(cfg.tail_kinds)}
    return cache


def _layer_cache(cache: Params, key) -> Params:
    group, u, i = key
    c = cache[group][i]
    return c if u is None else {"k": c["k"][u], "v": c["v"][u]}


def prefill(params, cfg: ArchConfig, tokens=None, patches=None, frames=None,
            max_len: Optional[int] = None, cache_dtype=torch.bfloat16):
    """Process a prompt (after the vision prefix, if any); return
    (last-token logits (B, Vp), cache). ``max_len`` counts the prefix."""
    x = _embed(params, cfg, tokens, patches, frames)
    b, t = x.shape[0], x.shape[1]
    cache = init_cache(cfg, b, max_len or t, cache_dtype, x.device)
    for p, kind, key in _layers(params, cfg):
        x, _ = layer_prefill(x, p, kind, cfg, _layer_cache(cache, key))
    return _head(params, cfg, x[:, -1:])[:, 0], cache


def decode_step(params, cfg: ArchConfig, cache, token, pos: int):
    """One decode step. token: (B,) ints; pos: the absolute position of
    this token. Returns (logits (B, Vp), cache), the cache updated in
    place."""
    if cfg.frontend == "audio":
        raise ValueError(f"{cfg.name} is encoder-only: it has no decode step")
    x = _embed(params, cfg, _tokens(token, _device(params))[:, None])
    for p, kind, key in _layers(params, cfg):
        x, _ = layer_decode(x, p, kind, cfg, _layer_cache(cache, key), int(pos))
    return _head(params, cfg, x)[:, 0], cache
