"""Mixture-of-Experts FFN with capacity-based scatter dispatch (port of
``repro.models.moe``, single device), and the dropless sigmoid-routed layer
of the port's own MoE architectures (``SigmoidMoESpec``).

Expert weights are stacked on a leading ``experts`` axis. Dispatch avoids the
O(T x E x C) one-hot einsum of the classic GShard formulation: the position
in its expert comes from a cumsum over the (T*k, E) assignment one-hot, then
each slot of the (E * C, d) expert buffer gathers its token directly
(out-of-capacity tokens fall into a drop slot, which is discarded). The
routed experts are batched products over E, plain torch as in the
reference, whose einsums run outside any Pallas kernel; the shared expert
goes through
``core/fused_ffn.ffn_apply``, on a card the fused-FFN kernel.

The router runs in f32 against its f32 weights (``layers.F32_LEAVES``); a
Switch-style auxiliary load-balance loss (E * sum(f_e * p_e)) is returned
to the caller.

A sigmoid-routed layer (``SigmoidMoESpec``) is dropless: it routes by
sigmoid scores, the top-k of the scores plus the selection bias
``route_bias`` picking the experts and the unbiased scores, normalized and
times ``route_scale``, weighting them; ``experts`` then computes every
assignment: the assignments grouped by expert (a stable sort), one
product per group, the groups' offsets on the device (``torch._grouped_mm``
on a card, a loop over the groups on the CPU), so nothing waits on the
host; no capacity, no drop slot. Spans: ``moe.layer`` (args: layer,
tokens, assignments) around ``moe.route``, ``moe.dispatch`` (its counters
from device values, read after the profile: experts hit, the largest
load, and the assignments the grouped products do not compute with their
own expert), ``moe.experts`` and ``moe.combine``.

On a mesh (``_moe_sharded``) the layout is the reference's pins: experts
over ``model``, capacity over ``data``. Every rank sees all tokens' routes
(so the capacity and the drops are those of one device), fills and runs
only its own (experts, capacity slots) window, and scatters back its
contributions; the sum over ranks is the reduce the placements state.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.configs.base import ArchConfig, MoESpec
from repro_torch.core import fused_ffn as ffnlib
from repro_torch.kernels.build import on_card
from repro_torch.kernels.ref import ACTS
from repro_torch.models.layers import normal_leaf
from repro_torch.runtime import trace
from repro_torch.runtime.actctx import (local_call, local_rank, mesh_size,
                                        placed, sharded_on)

# the scale of the seeded selection bias of a sigmoid-routed layer
ROUTE_BIAS_SCALE = 0.05

Params = Dict[str, Any]


def init_moe(gen: torch.Generator, cfg: ArchConfig, device=None,
             dtype=torch.float32) -> Params:
    """Seeded random router, experts and shared expert (the router in
    f32)."""
    m = cfg.moe
    d, fe, e = cfg.d_model, m.d_ff_expert, m.n_experts

    def normal(name, shape, scale):
        return normal_leaf(gen, name, shape, scale, device, dtype)

    p = {"router": normal("router", (d, e), d ** -0.5)}
    if m.score_func == "sigmoid":
        p["route_bias"] = normal("route_bias", (e,), ROUTE_BIAS_SCALE)
    if cfg.gated:
        p["w_gate"] = normal("w_gate", (e, d, fe), d ** -0.5)
    p["w_up"] = normal("w_up", (e, d, fe), d ** -0.5)
    p["w_down"] = normal("w_down", (e, fe, d), fe ** -0.5)
    if m.shared_d_ff:
        fs = m.shared_d_ff
        sp = {}
        if cfg.gated:
            sp["w_gate"] = normal("w_gate", (d, fs), d ** -0.5)
        sp["w_up"] = normal("w_up", (d, fs), d ** -0.5)
        sp["w_down"] = normal("w_down", (fs, d), fs ** -0.5)
        p["shared"] = sp
    return p


def capacity(n_tokens: int, m: MoESpec) -> int:
    c = int(n_tokens * m.top_k / m.n_experts * m.capacity_factor)
    return max(8, -(-c // 8) * 8)  # multiple of 8, floor 8


def _route(xf, p: Params, m: MoESpec):
    """(probs (n, E), gates (n, k), ids (n, k)), all from f32 logits; with
    sigmoid scores, the probs are the scores, the ids the top-k of the
    scores plus the selection bias, and the gates the unbiased scores of
    those, normalized and times ``route_scale``."""
    if m.score_func == "sigmoid":
        s = torch.sigmoid(xf.float() @ p["router"])
        ids = torch.topk(s + p["route_bias"], m.top_k, dim=-1)[1]
        gates = s.gather(-1, ids)
        return s, gates * (m.route_scale / gates.sum(-1, keepdim=True)), ids
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    gates, ids = torch.topk(probs, m.top_k, dim=-1)
    if m.top_k > 1:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    return probs, gates, ids


def _dispatch(ids, n_experts: int, cap: int):
    """(dest (n*k,), keep (n*k,)): each assignment's row in the (E * cap +
    1, d) buffer, token-major, the drop slot ``E * cap`` past capacity."""
    flat_ids = ids.reshape(-1)
    # the token-major cumsum runs along the contiguous axis of the (E, n*k)
    # one-hot: along axis 0 of (n*k, E), CUDA scans only E columns in
    # parallel (1.5 ms a layer at qwen2-moe's prefill on an H100)
    oh = F.one_hot(flat_ids, n_experts).t().contiguous()
    pos = torch.cumsum(oh, dim=1) - 1
    pos_in_e = pos.gather(0, flat_ids[None, :])[0]
    keep = pos_in_e < cap
    dest = torch.where(keep, flat_ids * cap + pos_in_e,
                       torch.full_like(flat_ids, n_experts * cap))
    return dest, keep


def _aux(probs, ids, m: MoESpec):
    """The Switch-style load-balance loss, E * sum(f_e * p_e), weighted."""
    e = m.n_experts
    f_e = F.one_hot(ids[:, 0], e).float().mean(dim=0)
    return e * torch.sum(f_e * probs.mean(dim=0)) * m.router_aux_weight


def moe_layer(x, p: Params, cfg: ArchConfig, layer=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (y, aux_loss). ``layer``: the layer's index, the
    arg of a dropless layer's span."""
    if isinstance(x, DTensor):
        return _moe_sharded(x, p, cfg)
    m = cfg.moe
    if m.score_func == "sigmoid":
        return _moe_dropless(x, p, cfg, layer)
    b, t, d = x.shape
    n, dt = b * t, x.dtype
    xf = x.reshape(n, d)
    probs, gates, ids = _route(xf, p, m)
    w = {k: p[k].to(dt) for k in _EXPERTS if k in p}
    y = _routed(xf, w, gates, ids, cfg, 0, 0, capacity(n, m))

    # --- shared-expert path (dense, always on) -------------------------------
    if m.shared_d_ff:
        y = y + ffnlib.ffn_apply(xf, p["shared"], gated=cfg.gated,
                                 act_name=cfg.act, impl=cfg.block_impl,
                                 chunk=cfg.ffn_chunk)
    return y.reshape(b, t, d), _aux(probs, ids, m)


_EXPERTS = ("w_gate", "w_up", "w_down")


def _moe_dropless(x, p: Params, cfg: ArchConfig, layer):
    """The dropless sigmoid-routed layer: the span ``moe.layer``. The router
    reads x cast to f32, the experts take it in ``cfg.dtype``; the routed
    sum is f32, the shared expert's added to it. Its aux is 0: the
    selection bias, not a loss, balances the experts."""
    m = cfg.moe
    b, t, d = x.shape
    n, dt = b * t, getattr(torch, cfg.dtype)
    xf = x.reshape(n, d)
    with trace.span("moe.layer") as rec:
        if rec is not None:
            rec.args.update(layer=layer, tokens=n, assignments=n * m.top_k)
        with trace.span("moe.route"):
            _, gates, ids = _route(xf, p, m)
        xf = xf.to(dt)
        y = experts(xf, ids, gates, p["w_gate"].to(dt), p["w_up"].to(dt),
                    p["w_down"].to(dt), act=cfg.act)
        if m.shared_d_ff:
            y = y + ffnlib.ffn_apply(xf, p["shared"], gated=cfg.gated,
                                     act_name=cfg.act, impl=cfg.block_impl,
                                     chunk=cfg.ffn_chunk)
    return y.reshape(b, t, d), xf.new_zeros((), dtype=torch.float32)


def experts(xf, ids, gates, w_gate, w_up, w_down, *, act: str = "silu"):
    """The routed experts' gated SwiGLU sum for tokens xf (n, d), routed
    to ids (n, k) with f32 gates (n, k), from the stacked experts w_gate,
    w_up (E, d, f) and w_down (E, f, d): every assignment computed
    (dropless). The assignments are grouped by expert (a stable sort,
    tokens in order within a group), each group's products run on its
    rows (``_grouped``), each row's hidden is scaled by its gate (in xf's
    dtype) before the down product, and each token's k rows are summed in
    f32. Returns (n, d) in f32. Spans
    ``moe.dispatch``, ``moe.experts``, ``moe.combine``; no host
    synchronisation on a card."""
    n, d = xf.shape
    k = ids.shape[1]
    flat = ids.reshape(-1)
    with trace.span("moe.dispatch") as rec:
        sid, order = torch.sort(flat, stable=True)
        counts = torch.zeros(w_up.shape[0], dtype=torch.int64,
                             device=xf.device).scatter_add_(
            0, flat, torch.ones_like(flat))
        offs = _offsets(counts)
        rows = xf[order // k]                                  # (n * k, d)
        if rec is not None:
            rec.args.update(tokens=n, assignments=n * k)
            rec.later = COUNTERS, _counters(sid, counts, offs)
    with trace.span("moe.experts"):
        h = ACTS[act](_grouped(rows, w_gate, offs)) * _grouped(rows, w_up,
                                                               offs)
        h = h * gates.reshape(-1)[order, None].to(h.dtype)
        out = _grouped(h, w_down, offs)                        # (n * k, d)
    with trace.span("moe.combine"):
        inv = torch.empty_like(order)
        inv[order] = torch.arange(n * k, device=xf.device)
        return out[inv].view(n, k, d).sum(1, dtype=torch.float32)


def _offsets(counts):
    """The end of each expert's group of sorted rows: the running sum of
    the per-expert counts, int32 on the device."""
    return torch.cumsum(counts, 0).to(torch.int32)


# a profiled dispatch's counters, read after the profile (``trace``)
COUNTERS = ("experts_hit", "max_load", "dropped")


def _counters(sid, counts, offs):
    """``COUNTERS`` as one device tensor: the experts with an assignment,
    the largest count, and the assignments that the grouped products do
    not compute with their own expert: sorted row r, of expert sid[r],
    lies outside the rows [offs[e - 1], offs[e]) that ``_grouped`` hands
    expert e (past offs[-1]: computed by none)."""
    row = torch.arange(sid.numel(), dtype=offs.dtype, device=sid.device)
    group = torch.searchsorted(offs, row, right=True)
    return torch.stack([(counts > 0).sum(), counts.max(),
                        (group != sid).sum()])


def _grouped(a, w, offs):
    """Rows a (M, K) by groups, group g the rows [offs[g-1], offs[g]) times
    w[g] (K, N), in a's dtype: one ``torch._grouped_mm`` on a card, whose
    offsets stay on the device; on the CPU a product per group (its bounds
    read on the host)."""
    if on_card(a):
        return torch._grouped_mm(a, w, offs=offs)
    out = a.new_empty((a.shape[0], w.shape[2]))
    lo = 0
    for g, hi in enumerate(offs.tolist()):
        out[lo:hi] = a[lo:hi] @ w[g]
        lo = hi
    return out


def _routed(xf, w: Params, gates, ids, cfg: ArchConfig, e0: int, c0: int,
            n_c: int):
    """The routed experts' sum for tokens xf (n, d), routed as (gates,
    ids), from the experts [e0, e0 + n_e) whose weights ``w`` holds (n_e of
    them) and their capacity slots [c0, c0 + n_c) alone: ``moe_layer`` runs
    the whole window, a rank of a mesh its own. No buffer outgrows the
    window, (n, d) or one block of the combine (``_COMBINE_BLOCK``
    tokens)."""
    m = cfg.moe
    n, d = xf.shape
    k, dt = m.top_k, xf.dtype
    n_e = w["w_up"].shape[0]
    act = ACTS[cfg.act]

    # --- capacity-based scatter dispatch into the window ---------------------
    cap = capacity(n, m)
    dest, keep = _dispatch(ids, m.n_experts, cap)
    flat_ids = ids.reshape(-1)
    slot = dest - flat_ids * cap
    mine = keep & (flat_ids >= e0) & (flat_ids < e0 + n_e) & (slot >= c0) \
        & (slot < c0 + n_c)
    size = n_e * n_c
    local = torch.where(mine, (flat_ids - e0) * n_c + slot - c0,
                        torch.full_like(flat_ids, size))
    # each slot's token, n where empty; indices repeat only at the drop
    # slot, whose entry is discarded
    tok = torch.full((size + 1,), n, dtype=local.dtype, device=xf.device)
    tok.index_copy_(0, local,
                    torch.arange(n * k, device=xf.device) // k)
    tok = tok[:-1, None]
    expert_in = torch.where(tok < n, xf[tok[:, 0].clamp(max=n - 1)], 0)
    expert_in = expert_in.reshape(n_e, n_c, d)

    # --- per-expert FFN, batched over the window's experts -------------------
    if cfg.gated:
        h = act(torch.bmm(expert_in, w["w_gate"]))
        h = h * torch.bmm(expert_in, w["w_up"])
    else:
        h = act(torch.bmm(expert_in, w["w_up"]))
    out = torch.bmm(h, w["w_down"]).reshape(size, d)

    # --- combine: gather back + gate-weighted sum over k ---------------------
    # a block of tokens at a time: the (tokens, k, d) gather stays
    # block-sized
    flat_out = torch.cat([out, out.new_zeros((1, d))])
    local = local.reshape(n, k)
    weight = (gates * mine.reshape(n, k)).to(dt)[..., None]

    def combine(s):
        return (flat_out[local[s]] * weight[s]).sum(dim=1)
    if n <= _COMBINE_BLOCK:
        return combine(slice(0, n))
    y = xf.new_empty((n, d))
    for s in range(0, n, _COMBINE_BLOCK):
        rows = slice(s, s + _COMBINE_BLOCK)
        y[rows] = combine(rows)
    return y


# tokens per block of the combine: 256 MiB of bf16 gather at d 4096, k 1
_COMBINE_BLOCK = 32768


def _moe_sharded(x, p: Params, cfg: ArchConfig):
    """``moe_layer`` on a mesh: experts over ``model`` and capacity slots
    over ``data`` (the reference's ("M", "D", None) pins on the expert
    buffers). Each rank routes its own rows; the routes and the tokens are
    gathered over the batch axes, so that every rank sees the capacity and
    the drops of one device; each fills and runs only its own (experts,
    capacity slots) window, and its contributions are summed by a
    reduce-scatter back to the batch shards (and an all-reduce over
    ``model``). Where the experts or the slots do not divide their axis
    (qwen2-moe's 60 experts and 87,384 slots on 16), the windows are of
    the rounded-up size and the last ones hold fewer or none: a slot past
    the capacity is never filled, so the sum is the same."""
    m = cfg.moe
    b, t, d = x.shape
    n, dt = b * t, x.dtype
    mesh = x.device_mesh
    x = placed(x, "B", None, None)
    xf = x.reshape(n, d)
    rows = list(xf.placements)
    probs, gates, ids = local_call(
        lambda xl, r: _route(xl, {"router": r}, m), (rows, rows, rows), xf,
        placed(p["router"], None, None))
    probs, gates, ids = (placed(a, None, None) for a in (probs, gates, ids))
    xg = placed(xf, None, None)
    w = {k: placed(p[k].to(dt), "M", None, None) for k in _EXPERTS if k in p}
    n_model, n_data = mesh_size(mesh, "model"), mesh_size(mesh, "data")
    e_split = sharded_on(w["w_up"])        # whole local experts
    n_e = -(-m.n_experts // n_model)
    cap = capacity(n, m)
    n_c = -(-cap // n_data)
    e0 = local_rank(mesh, "model") * n_e
    c0 = local_rank(mesh, "data") * n_c
    n_c = max(0, min(n_c, cap - c0))
    names = mesh.mesh_dim_names
    y_pl = [Replicate()] * mesh.ndim
    for axis, size in (("model", n_model), ("data", n_data)):
        if size > 1:
            y_pl[names.index(axis)] = Partial()
    # every rank of the split axes computes the same aux: each states its
    # share, so that its gradient is counted once (``local_call``)
    shares = n_model * n_data

    def routed(xl, wl, pl, gl, il):
        if not e_split:                    # replicated: this rank's slice
            wl = {k: v[e0:e0 + n_e] for k, v in wl.items()}
        y = _routed(xl, wl, gl, il, cfg, e0, c0, n_c)
        return y, _aux(pl, il, m) / shares

    y, aux = local_call(routed, (y_pl, y_pl), xg, w, probs, gates, ids)
    aux = placed(aux)
    y = placed(y, "B", None)
    if m.shared_d_ff:
        y = y + ffnlib.ffn_apply(xf, p["shared"], gated=cfg.gated,
                                 act_name=cfg.act, impl=cfg.block_impl,
                                 chunk=cfg.ffn_chunk)
    return y.reshape(b, t, d), aux


def expert_load(x, p: Params, cfg: ArchConfig) -> Dict[str, Any]:
    """What ``moe_layer`` dispatches for x (B, T, D), for reporting: the
    capacity, the assignments each expert receives (k per token, before
    the capacity cut) and the assignments dropped past capacity."""
    m = cfg.moe
    xf = x.reshape(-1, x.shape[-1])
    _, _, ids = _route(xf, p, m)
    cap = capacity(xf.shape[0], m)
    _, keep = _dispatch(ids, m.n_experts, cap)
    load = torch.bincount(ids.reshape(-1), minlength=m.n_experts)
    return {"capacity": cap, "load": load.tolist(),
            "dropped": int((~keep).sum())}
