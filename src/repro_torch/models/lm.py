"""Composable LM (port of ``repro.models.lm``): one functional model for all
ten of the reference's archs, with its two modality stubs.

A model is assembled from an ``ArchConfig``: the layer *pattern* (for
recurrentgemma, ``("recurrent", "recurrent", "attn_local")``) repeats over
``n_layers``. Whole pattern units keep the reference's parameter layout,
each leaf stacked on a leading ``n_units`` axis, and run in a Python loop
(the reference's ``lax.scan``); remainder layers are the "tail".

Every layer is a pre-norm residual pair (with gemma2's sandwich norms)

    x += post1(sub1(norm1(x)))   # attention | RG-LRU block | RWKV time-mix
    x += post2(sub2(norm2(x)))   # FFN | MoE | RWKV channel-mix

and every FFN-shaped sub2 runs the paper's fused expand->mix->project
dataflow when ``cfg.block_impl == "fused"``: on a card, the hand-written
fused-FFN kernel (for MoE, its shared expert). An rwkv layer keeps its
channel-mix weights in ``sub1`` and has ``sub2 = {}``, as in the reference.

Entry points:

    init_params(cfg, seed, device, dtype)      -> params
    abstract_params(cfg, dtype)                -> params on the meta device
    params_from_numpy(tree, cfg, device, dtype) -> params
    forward(params, cfg, tokens, patches, frames) -> logits (B, T, V)
    forward_aux(params, cfg, tokens, patches, frames) -> (logits, aux)
    loss_fn(params, cfg, batch)                -> (loss, metrics)
    prefill(params, cfg, tokens, patches, frames, max_len) -> (last logits,
                                                               cache)
    decode_step(params, cfg, cache, token, pos) -> (logits, cache)

Frontend stubs, as in the reference: ``frontend == "audio"`` (hubert) has
no token embedding and takes precomputed ``frames`` (B, T, d_model);
``frontend == "vision"`` (internvl2) prepends precomputed ``patches`` (B,
n_patches, d_model) to the token embeddings, so a decode step after such a
prefill is at ``pos`` = n_patches + prompt length + step.
``decode_step`` and ``prefill`` write the cache in place: the returned
cache is the one passed in (decode) or just allocated (prefill). Its leaves
keep the reference's dtypes: the KV caches, RG-LRU's conv window and RWKV's
last tokens in the cache dtype, RG-LRU's ``h`` and RWKV's ``S`` in f32.

The reference's ``forward`` returns (logits, aux), aux the MoE layers'
summed load-balance loss, which only training reads. Here ``forward_aux``
returns that pair for training, and ``forward``, which serving calls, the
logits alone, with no remat. In ``forward_aux`` under grad, ``cfg.remat``
applies per pattern unit as in the reference
(``core/fused_ffn.apply_remat``): ``full`` recomputes each unit in the
backward pass, ``zero_buffer`` only its FFN and attention cores.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor import zeros as dtensor_zeros

from repro_torch import resolve_device, tree
from repro_torch.configs.base import ArchConfig
from repro_torch.core import fused_ffn as ffnlib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rg
from repro_torch.models import rwkv6 as rwkv
from repro_torch.runtime import trace
from repro_torch.runtime.actctx import (constrain, local_call, local_rank,
                                        mesh_size, placed, sharded_on)

Params = Dict[str, Any]

ATTN_KINDS = ("attn", "attn_local")
FRONTENDS = (None, "audio", "vision")


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.frontend not in FRONTENDS:
        raise ValueError(f"{cfg.name}: unknown frontend {cfg.frontend!r}; "
                         f"one of {FRONTENDS}")


# ---------------------------------------------------------------------------
# Per-layer init
# ---------------------------------------------------------------------------


def init_ffn(gen: torch.Generator, cfg: ArchConfig, device=None,
             dtype=torch.float32) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    p = {}
    if cfg.gated:
        p["w_gate"] = L.normal_leaf(gen, "w_gate", (d, f), d ** -0.5, device,
                                    dtype)
    p["w_up"] = L.normal_leaf(gen, "w_up", (d, f), d ** -0.5, device, dtype)
    p["w_down"] = L.normal_leaf(gen, "w_down", (f, d), f ** -0.5, device,
                                dtype)
    return p


def init_layer(gen: torch.Generator, kind: str, cfg: ArchConfig, device=None,
               dtype=torch.float32) -> Params:
    """One layer's weights; norm scales and ``layers.F32_LEAVES`` are f32
    whatever ``dtype``."""
    p: Params = {"norm1": L.init_rms(cfg.d_model, device),
                 "norm2": L.init_rms(cfg.d_model, device)}
    if cfg.sandwich_norm:
        p["post_norm1"] = L.init_rms(cfg.d_model, device)
        p["post_norm2"] = L.init_rms(cfg.d_model, device)
    if kind in ATTN_KINDS:
        p["sub1"] = L.init_attention(gen, cfg, device, dtype)
    elif kind == "recurrent":
        p["sub1"] = rg.init_rglru_block(gen, cfg, device, dtype)
    elif kind == "rwkv":
        p["sub1"] = rwkv.init_rwkv_block(gen, cfg, device, dtype)  # cm too
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    if kind == "rwkv":
        p["sub2"] = {}                  # channel-mix params live in sub1
    elif cfg.moe is not None:
        p["sub2"] = moe_mod.init_moe(gen, cfg, device, dtype)
    else:
        p["sub2"] = init_ffn(gen, cfg, device, dtype)
    return p


# ---------------------------------------------------------------------------
# Per-layer apply (full sequence / prefill / decode)
# ---------------------------------------------------------------------------


def _norm(x, s, cfg):
    return L.rms_norm(x, s, eps=cfg.norm_eps, zero_centered=cfg.embed_scale)


def _sub2(h, p, kind: str, cfg: ArchConfig, cache=None):
    """The second half's block on the normed h: (y, aux, cache). rwkv's
    channel-mix carries its last token in the cache; aux is an MoE layer's
    load-balance loss and None for every other block."""
    if kind == "rwkv":
        y, cache = rwkv.channel_mix(h, p["sub1"], cfg, cache)
        return y, None, cache
    if cfg.moe is not None:
        y, aux = moe_mod.moe_layer(h, p["sub2"], cfg)
        return y, aux, cache
    return ffnlib.ffn_apply(h, p["sub2"], gated=cfg.gated, act_name=cfg.act,
                            impl=cfg.block_impl, chunk=cfg.ffn_chunk), None, \
        cache


def _residual(x, y, p, post: str, cfg: ArchConfig):
    if cfg.sandwich_norm:
        y = _norm(y, p[post], cfg)
    return x + y


def _second_half(x, p, kind, cfg: ArchConfig, cache=None, remat="none"):
    """(x, aux, cache) after the second residual pair; under ``zero_buffer``
    its block is recomputed in the backward pass."""
    y, aux, cache = ffnlib.remat_core(_sub2, remat)(
        _norm(x, p["norm2"], cfg), p, kind, cfg, cache)
    return _residual(x, y, p, "post_norm2", cfg), aux, cache


def _add_aux(aux, more):
    return aux if more is None else (more if aux is None else aux + more)


def layer_apply(x, p: Params, kind: str, cfg: ArchConfig, aux=None,
                remat: str = "none"):
    """Full-sequence layer: (x, aux), aux summed with the layer's MoE
    load-balance loss (None while no layer had one)."""
    h = _norm(x, p["norm1"], cfg)
    if kind in ATTN_KINDS:
        y = L.attention_layer(h, p["sub1"], cfg, local=(kind == "attn_local"),
                              remat=remat)
    elif kind == "recurrent":
        y = rg.rglru_block(h, p["sub1"], cfg)
    else:
        y, _ = rwkv.time_mix(h, p["sub1"], cfg)
    x, aux2, _ = _second_half(_residual(x, y, p, "post_norm1", cfg), p, kind,
                              cfg, remat=remat)
    return x, _add_aux(aux, aux2)


def init_layer_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None) -> Params:
    if kind in ATTN_KINDS:
        return L.init_kv_cache(cfg, batch, max_len,
                               local=(kind == "attn_local"), dtype=dtype,
                               device=device)
    if kind == "recurrent":
        return rg.init_rglru_cache(cfg, batch, dtype, device)
    if kind == "rwkv":
        return rwkv.init_rwkv_cache(cfg, batch, dtype, device)
    raise ValueError(f"unknown layer kind {kind!r}")


def layer_prefill(x, p, kind, cfg, cache, layer: int):
    """Returns (x, cache): the attention layers' KV cache is written in
    place; the recurrent and rwkv layers return new state, which the
    caller stores. Spans (``runtime.trace``, ``layer`` the layer's index
    as their arg): an attention layer's attention ``lm.attention`` and the
    second residual pair ``lm.ffn``."""
    h = _norm(x, p["norm1"], cfg)
    if kind in ATTN_KINDS:
        with trace.span("lm.attention") as rec:
            if rec is not None:
                rec.args["layer"] = layer
            y, cache = L.attention_prefill(h, p["sub1"], cfg, cache,
                                           local=(kind == "attn_local"))
    elif kind == "recurrent":
        y, cache = rg.rglru_prefill(h, p["sub1"], cfg, cache)
    else:
        y, cache = rwkv.time_mix(h, p["sub1"], cfg, cache)
    x = _residual(x, y, p, "post_norm1", cfg)
    with trace.span("lm.ffn") as rec:
        if rec is not None:
            rec.args["layer"] = layer
        x, _, cache = _second_half(x, p, kind, cfg, cache)
    return x, cache


def layer_decode(x, p, kind, cfg, cache, pos: int, layer: int):
    """As ``layer_prefill``, one token at absolute position ``pos``."""
    h = _norm(x, p["norm1"], cfg)
    if kind in ATTN_KINDS:
        with trace.span("lm.attention") as rec:
            if rec is not None:
                rec.args["layer"] = layer
            y, cache = L.attention_decode(h, p["sub1"], cfg, cache, pos,
                                          local=(kind == "attn_local"))
    elif kind == "recurrent":
        y, cache = rg.rglru_decode(h, p["sub1"], cfg, cache)
    else:
        y, cache = rwkv.time_mix(h, p["sub1"], cfg, cache)
    x = _residual(x, y, p, "post_norm1", cfg)
    with trace.span("lm.ffn") as rec:
        if rec is not None:
            rec.args["layer"] = layer
        x, _, cache = _second_half(x, p, kind, cfg, cache)
    return x, cache


# ---------------------------------------------------------------------------
# Whole-model parameters
# ---------------------------------------------------------------------------


def _stacked_units(gen, cfg: ArchConfig, device, dtype, keep) -> Params:
    """The pattern units' layers, each leaf stacked on a leading n_units
    axis, filled one unit at a time so that the peak is one unit over the
    stack (``keep`` applied to each unit before it is stacked)."""
    def unit():
        return keep("units", {str(i): init_layer(gen, kind, cfg, device,
                                                 dtype)
                              for i, kind in enumerate(cfg.pattern)})

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
                dtype=None, local=None) -> Params:
    """Seeded random weights drawn on ``device`` from a ``torch.Generator``
    (not the reference's ``jax.random`` numbers). Matrices are stored in
    ``dtype`` (default ``cfg.dtype``), norm scales and
    ``layers.F32_LEAVES`` in f32.

    ``local(path, leaf)``, where given, takes each leaf as it is drawn (a
    pattern unit's before it is stacked; ``path`` is the leaf's in the
    whole tree) to the part to keep: the tree then holds only those parts,
    of the same numbers, and no more than one layer or one top-level leaf
    is ever whole."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _init(cfg, gen, dev, dtype, local)


def abstract_params(cfg: ArchConfig, dtype=torch.float32) -> Params:
    """The parameter tree's shapes and dtypes as tensors on the meta device
    (no storage): a template to restore a checkpoint into."""
    _check_supported(cfg)
    return _init(cfg, torch.Generator(), torch.device("meta"), dtype)


def _init(cfg: ArchConfig, gen, dev, dtype, local=None) -> Params:
    dt = getattr(torch, cfg.dtype) if dtype is None else dtype
    vp, d = cfg.vocab_padded(), cfg.d_model

    def keep(prefix, node):
        if local is None:
            return node
        return tree.unflatten(node, [
            local(tree.SEP.join(x for x in (prefix, path) if x), leaf)
            for path, leaf in tree.flatten_with_path(node)])

    p: Params = {}
    if cfg.frontend != "audio":   # audio: precomputed frames, no embedding
        p["embed"] = keep("embed", L.normal_leaf(gen, "embed", (vp, d),
                                                 d ** -0.5, dev, dt))
    if cfg.n_units > 0:
        p["units"] = _stacked_units(gen, cfg, dev, dt, keep)
    if cfg.tail_kinds:
        p["tail"] = {str(i): keep(f"tail{tree.SEP}{i}",
                                  init_layer(gen, kind, cfg, dev, dt))
                     for i, kind in enumerate(cfg.tail_kinds)}
    p["final_norm"] = keep("final_norm", L.init_rms(d, dev))
    if not cfg.tie_embeddings:
        p["lm_head"] = keep("lm_head", L.normal_leaf(
            gen, "lm_head", (d, vp), d ** -0.5, dev, dt))
    return p


def params_from_numpy(tree, cfg: ArchConfig, device="cuda",
                      dtype=None) -> Params:
    """Carry the reference's parameter tree across: nested dicts of numpy
    arrays (``units`` stacked on a leading axis, as the reference stores
    them). Norm scales and ``layers.F32_LEAVES``, which the reference uses
    at their f32 masters, stay f32; every other leaf is cast to ``dtype``
    (default ``cfg.dtype``) once here, where the reference casts its f32
    masters at every use, so the values are the same."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype) if dtype is None else dtype

    def carry(node, name=""):
        if isinstance(node, Mapping):
            return {k: carry(v, k) for k, v in node.items()}
        t = torch.from_numpy(np.array(node, dtype=np.float32, copy=True))
        return t.to(device=dev, dtype=L.leaf_dtype(name, dt))

    return carry(tree)


def _unbind_units(params: Params, cfg: ArchConfig):
    """Each pattern unit's layer tree, its leaves views of the stacked ones
    by one ``torch.unbind`` per leaf: the backward pass then stacks each
    leaf's gradient once, where a view per unit and layer would add a
    zero-filled stack-sized gradient per unit."""
    if cfg.n_units == 0:
        return []
    stacked = tree.leaves(params["units"])
    pieces = [torch.unbind(leaf) for leaf in stacked]
    return [tree.unflatten(params["units"], [p[u] for p in pieces])
            for u in range(cfg.n_units)]


def _unit_layer(params: Params, u: int, i: int) -> Params:
    """Views of layer ``i`` of pattern unit ``u`` in the stacked tree."""
    def take(node):
        if isinstance(node, Mapping):
            return {k: take(v) for k, v in node.items()}
        return node[u]
    return take(params["units"][str(i)])


def _layers(params: Params, cfg: ArchConfig):
    """(layer params, kind, cache key) in execution order: serving's walk,
    a view per unit and layer; on a mesh the units' views come from one
    ``unbind`` per leaf (one DTensor op per leaf, not per unit and leaf)."""
    units = (_unbind_units(params, cfg)
             if isinstance(params["final_norm"], DTensor) else None)
    for u in range(cfg.n_units):
        for i, kind in enumerate(cfg.pattern):
            p = units[u][str(i)] if units else _unit_layer(params, u, i)
            yield p, kind, ("units", u, str(i))
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
    if isinstance(params["final_norm"], DTensor):
        return _embed_sharded(params, cfg, tokens, patches, frames)
    if cfg.frontend == "audio":
        return torch.as_tensor(frames, device=dev).to(dt)   # stub: frames
    x = params["embed"][_tokens(tokens, dev)].to(dt)
    if cfg.embed_scale:
        # sqrt(d_model) rounded to the compute dtype, multiplied in it
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=x.device)
    if cfg.frontend == "vision" and patches is not None:
        x = torch.cat([torch.as_tensor(patches, device=dev).to(dt), x], dim=1)
    return x


def _embed_sharded(params, cfg: ArchConfig, tokens, patches, frames):
    """``_embed`` on a mesh: the batch DTensors (``sharding.batch_specs``)
    looked up in the table's local d_model columns, then gathered to the
    canonical activation layout, batch-sharded and whole over ``model``
    (the reference's pin right after its lookup)."""
    dt = getattr(torch, cfg.dtype)
    if cfg.frontend == "audio":
        return constrain(placed(frames, "B", None, None).to(dt),
                         "B", None, None)
    table = params["embed"]
    tokens = placed(tokens, "B", *(None,) * (tokens.dim() - 1))
    scale = cfg.d_model ** 0.5 if cfg.embed_scale else None

    def lookup(tab, tok):
        x = tab[tok].to(dt)
        if scale is not None:
            x = x * torch.tensor(scale, dtype=dt, device=x.device)
        return (x,)

    out_pl = list(tokens.placements)
    names = tokens.device_mesh.mesh_dim_names
    if "model" in names and sharded_on(table):
        out_pl[names.index("model")] = Shard(tokens.dim())
    x = local_call(lookup, (out_pl,), table, tokens)[0]
    x = placed(x, "B", None, None)
    if cfg.frontend == "vision" and patches is not None:
        x = torch.cat([placed(patches, "B", None, None).to(dt), x], dim=1)
    return constrain(x, "B", None, None)


def _head(params, cfg: ArchConfig, x):
    """The final norm and the logits: the span ``lm.head``."""
    with trace.span("lm.head"):
        x = _norm(x, params["final_norm"], cfg)
        if isinstance(x, DTensor):
            logits = _head_sharded(params, cfg, x)
        else:
            w = (params["embed"].T if cfg.tie_embeddings
                 else params["lm_head"]).to(x.dtype)
            logits = (x @ w).float()
        logits = constrain(logits, "B", None, "M")   # vocab TP-sharded
        if cfg.final_softcap is not None:
            logits = cfg.final_softcap * torch.tanh(logits
                                                    / cfg.final_softcap)
        return logits


def _head_sharded(params, cfg: ArchConfig, x):
    """The head's product on local shards: x batch-sharded and whole over
    ``model``, the weight with its vocab over ``model`` (the tied table
    moved from d_model to vocab over ``model``; lm_head's FSDP dim
    gathered), the logits' vocab over ``model``."""
    x = placed(x, "B", *(None,) * (x.dim() - 1))
    if cfg.tie_embeddings:
        w = placed(params["embed"].to(x.dtype), "M", None)
        fn = lambda xl, wl: ((xl @ wl.T).float(),)           # noqa: E731
        split = sharded_on(w)
    else:
        w = placed(params["lm_head"].to(x.dtype), None, "M")
        fn = lambda xl, wl: ((xl @ wl).float(),)             # noqa: E731
        split = sharded_on(w)
    pl = list(x.placements)
    names = x.device_mesh.mesh_dim_names
    if split:
        pl[names.index("model")] = Shard(x.dim() - 1)
    return local_call(fn, (pl,), x, w)[0]


def _tokens(tokens, device):
    return torch.as_tensor(tokens, dtype=torch.long, device=device)


def _run_layers(x, params, cfg: ArchConfig):
    """(x, aux) after every layer: the pattern units, each under
    ``cfg.remat`` while grad is on, then the tail, which the reference
    runs without remat. aux is the MoE layers' summed load-balance loss."""
    mode = cfg.remat if torch.is_grad_enabled() else "none"

    def unit(x, aux, unit_p):
        for i, kind in enumerate(cfg.pattern):
            x, aux = layer_apply(x, unit_p[str(i)], kind, cfg, aux, mode)
        return x, aux

    run_unit = ffnlib.apply_remat(unit, mode)
    aux = None
    for unit_p in _unbind_units(params, cfg):
        x = constrain(x, "B", None, None)     # pin the unit-carry layout
        x, aux = run_unit(x, aux, unit_p)
    for i, kind in enumerate(cfg.tail_kinds):
        x, aux = layer_apply(x, params["tail"][str(i)], kind, cfg, aux)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if isinstance(x, DTensor):
            aux = DTensor.from_local(aux, x.device_mesh,
                                     [Replicate()] * x.device_mesh.ndim)
    return x, aux


def forward_aux(params, cfg: ArchConfig, tokens=None, patches=None,
                frames=None):
    """Full-sequence forward: (logits (B, T, Vp) in f32, T counting the
    vision prefix; aux, the MoE layers' summed load-balance loss, an f32
    scalar, 0 without MoE): the reference's ``forward``."""
    x = _embed(params, cfg, tokens, patches, frames)
    x, aux = _run_layers(x, params, cfg)
    return _head(params, cfg, x), aux


def forward(params, cfg: ArchConfig, tokens=None, patches=None,
            frames=None):
    """Full-sequence forward: logits (B, T, Vp) in f32 (T counts the vision
    prefix). Serving's forward: no remat, the MoE aux loss dropped;
    training goes through ``forward_aux``."""
    x = _embed(params, cfg, tokens, patches, frames)
    for p, kind, _ in _layers(params, cfg):
        x = constrain(x, "B", None, None)
        x = layer_apply(x, p, kind, cfg)[0]
    return _head(params, cfg, x)


def loss_fn(params, cfg: ArchConfig, batch: Mapping):
    """Next-token (causal) or per-frame (encoder) cross entropy plus the
    MoE aux loss: (loss, {"loss", "nll", "aux"}), f32 scalars. ``batch``
    holds numpy arrays or tensors: ``labels`` (B, T) and ``tokens``,
    ``patches`` or ``frames`` as ``forward`` takes them. Vision logits are
    cut to the text positions, and the padded vocab is masked out of the
    softmax with -1e30, as in the reference."""
    logits, aux = forward_aux(params, cfg, tokens=batch.get("tokens"),
                              patches=batch.get("patches"),
                              frames=batch.get("frames"))
    if isinstance(logits, DTensor):
        nll = _nll_sharded(logits, batch, cfg)
        loss = nll + aux
        return loss, {"loss": loss, "nll": nll, "aux": aux}
    labels = _tokens(batch["labels"], logits.device)
    if cfg.frontend == "vision" and batch.get("patches") is not None:
        logits = logits[:, batch["patches"].shape[1]:]   # text positions
    vp = logits.shape[-1]
    if vp != cfg.vocab:
        pad = torch.arange(vp, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    nll = F.cross_entropy(logits.reshape(-1, vp), labels.reshape(-1))
    loss = nll + aux
    return loss, {"loss": loss, "nll": nll, "aux": aux}


def _nll_sharded(logits, batch, cfg: ArchConfig):
    """``loss_fn``'s mean cross entropy on a mesh, without gathering the
    vocab: each rank holds a slice of the (masked, padded) vocab for its
    batch rows, the log-sum-exp and the label's logit are combined over
    ``model`` by all-reduces, and the mean over all tokens is each batch
    shard's sum over the global count, a pending sum over the batch axes."""
    mesh = logits.device_mesh
    logits = placed(logits, "B", None, "M")
    labels = placed(batch["labels"], "B", None)
    if cfg.frontend == "vision" and batch.get("patches") is not None:
        logits = logits[:, batch["patches"].shape[1]:]   # text positions
    names = mesh.mesh_dim_names
    split = sharded_on(logits)
    group = mesh.get_group("model") if split else None
    v_local = logits.shape[-1] // (mesh_size(mesh, "model") if split else 1)
    v0 = local_rank(mesh, "model") * v_local if split else 0

    def nll(lg, lab):
        col = torch.arange(v0, v0 + lg.shape[-1], device=lg.device)
        lg = lg.masked_fill(col >= cfg.vocab, -1e30)
        if group is None:       # the whole vocab here: loss_fn's own form
            mean = F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                                   lab.reshape(-1).long())
            return (mean * (lab.numel() / n_tokens),)
        mx = lg.amax(dim=-1, keepdim=True).detach()
        if group is not None:
            mx = funcol.all_reduce(mx, "max", group)
        se = torch.exp(lg - mx).sum(dim=-1)
        mine = (lab >= v0) & (lab < v0 + lg.shape[-1])
        idx = (lab - v0).clamp(0, lg.shape[-1] - 1)
        picked = torch.where(mine, lg.gather(-1, idx[..., None])[..., 0],
                             torch.zeros_like(se))
        if group is not None:
            se = _AllReduceSum.apply(se, group)
            picked = _AllReduceSum.apply(picked, group)
        return ((torch.log(se) + mx[..., 0] - picked).sum() / n_tokens,)

    n_tokens = labels.numel()
    part = [Replicate()] * mesh.ndim
    for a in ("pod", "data"):
        if a in names and labels.placements[names.index(a)].is_shard():
            part[names.index(a)] = Partial()
    out = local_call(nll, (part,), logits, labels)[0]
    return out.redistribute(mesh, [Replicate()] * mesh.ndim)


class _AllReduceSum(torch.autograd.Function):
    """A sum over ``group`` whose gradient reaches every rank's input
    unchanged (each rank's term enters the sum once)."""

    @staticmethod
    def forward(ctx, x, group):
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Params:
    cache: Params = {}
    if cfg.n_units > 0:
        cache["units"] = {}
        for i, kind in enumerate(cfg.pattern):
            one = init_layer_cache(cfg, kind, batch, max_len, dtype, device)
            cache["units"][str(i)] = {
                k: torch.zeros((cfg.n_units,) + tuple(a.shape),
                               dtype=a.dtype, device=a.device)
                for k, a in one.items()}
    if cfg.tail_kinds:
        cache["tail"] = {str(i): init_layer_cache(cfg, kind, batch, max_len,
                                                  dtype, device)
                         for i, kind in enumerate(cfg.tail_kinds)}
    return cache


def sharded_cache(cfg: ArchConfig, batch: int, max_len: int, mesh,
                  dtype=torch.bfloat16) -> Params:
    """``init_cache``'s zeros as DTensors on ``mesh``, placed by
    ``sharding.cache_specs``; each rank allocates only its shard."""
    from repro_torch.runtime import sharding as shd
    abstract = init_cache(cfg, batch, max_len, dtype, torch.device("meta"))
    specs = shd.cache_specs(cfg, mesh, abstract)

    def zeros(path, a):
        pl = shd.placements(shd.spec_at(specs, path), mesh, tuple(a.shape))
        return dtensor_zeros(a.shape, dtype=a.dtype, device_mesh=mesh,
                             placements=pl)
    return tree.unflatten(abstract, [zeros(p, a) for p, a in
                                     tree.flatten_with_path(abstract)])


def _layer_cache(cache: Params, key) -> Params:
    """Views of one layer's leaves in the (stacked) cache."""
    group, u, i = key
    c = cache[group][i]
    return c if u is None else {k: a[u] for k, a in c.items()}


def _layer_caches(cache: Params, cfg: ArchConfig):
    """``_layer_cache`` of every layer, {key: views}; a stacked DTensor
    leaf is split by one ``unbind``."""
    out = {("tail", None, i): c for i, c in cache.get("tail", {}).items()}
    for i, c in cache.get("units", {}).items():
        pieces = {k: torch.unbind(a) if isinstance(a, DTensor) else a
                  for k, a in c.items()}
        for u in range(cfg.n_units):
            out[("units", u, i)] = {k: p[u] for k, p in pieces.items()}
    return out


def _store(view: Params, new: Params) -> None:
    """Write a layer's new state into its cache views (a no-op for the
    leaves an attention layer already wrote in place)."""
    for k, a in new.items():
        if a is not view[k]:
            view[k].copy_(a)


def prefill(params, cfg: ArchConfig, tokens=None, patches=None, frames=None,
            max_len: Optional[int] = None, cache_dtype=torch.bfloat16):
    """Process a prompt (after the vision prefix, if any); return
    (last-token logits (B, Vp), cache). ``max_len`` counts the prefix.
    The whole call is the span ``lm.prefill``."""
    with trace.span("lm.prefill") as rec:
        x = _embed(params, cfg, tokens, patches, frames)
        b, t = x.shape[0], x.shape[1]
        if rec is not None:
            rec.args.update(B=b, T=t)
        if isinstance(x, DTensor):
            cache = sharded_cache(cfg, b, max_len or t, x.device_mesh,
                                  cache_dtype)
        else:
            cache = init_cache(cfg, b, max_len or t, cache_dtype, x.device)
        views = _layer_caches(cache, cfg)
        for n, (p, kind, key) in enumerate(_layers(params, cfg)):
            x = constrain(x, "B", None, None)
            view = views[key]
            x, new = layer_prefill(x, p, kind, cfg, view, layer=n)
            _store(view, new)
        return _head(params, cfg, x[:, -1:])[:, 0], cache


def decode_step(params, cfg: ArchConfig, cache, token, pos: int):
    """One decode step. token: (B,) ints; pos: the absolute position of
    this token. Returns (logits (B, Vp), cache), the cache updated in
    place. The whole call is the span ``lm.decode_step``."""
    if cfg.frontend == "audio":
        raise ValueError(f"{cfg.name} is encoder-only: it has no decode step")
    with trace.span("lm.decode_step") as rec:
        if not isinstance(token, DTensor):
            token = _tokens(token, _device(params))
        if rec is not None:
            rec.args.update(B=token.shape[0], pos=int(pos))
        x = _embed(params, cfg, token[:, None])
        views = _layer_caches(cache, cfg)
        for n, (p, kind, key) in enumerate(_layers(params, cfg)):
            x = constrain(x, "B", None, None)
            view = views[key]
            x, new = layer_decode(x, p, kind, cfg, view, int(pos), layer=n)
            _store(view, new)
        return _head(params, cfg, x)[:, 0], cache
