"""Mixture-of-Experts FFN with capacity-based scatter dispatch (port of
``repro.models.moe``, single device).

Expert weights are stacked on a leading ``experts`` axis. Dispatch avoids the
O(T x E x C) one-hot einsum of the classic GShard formulation: the position
in its expert comes from a cumsum over the (T*k, E) assignment one-hot, then
tokens scatter directly into the (E * C, d) expert buffer (out-of-capacity
tokens fall into a drop slot, which is discarded). The routed experts are
batched products over E, plain torch as in the reference, whose einsums run
outside any Pallas kernel; the shared expert goes through
``core/fused_ffn.ffn_apply``, on a card the fused-FFN kernel.

The router runs in f32 against its f32 weights (``layers.F32_LEAVES``); a
Switch-style auxiliary load-balance loss (E * sum(f_e * p_e)) is returned
to the caller.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoESpec
from repro_torch.core import fused_ffn as ffnlib
from repro_torch.kernels.ref import ACTS
from repro_torch.models.layers import normal_leaf

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
    """(probs (n, E), gates (n, k), ids (n, k)), all from f32 logits."""
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


def moe_layer(x, p: Params, cfg: ArchConfig) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """x: (B, T, D) -> (y, aux_loss)."""
    m = cfg.moe
    b, t, d = x.shape
    n, e, dt = b * t, m.n_experts, x.dtype
    xf = x.reshape(n, d)
    act = ACTS[cfg.act]

    # --- routing (f32) -------------------------------------------------------
    probs, gates, ids = _route(xf, p, m)
    f_e = F.one_hot(ids[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(f_e * probs.mean(dim=0)) * m.router_aux_weight

    # --- capacity-based scatter dispatch -------------------------------------
    cap = capacity(n, m)
    dest, keep = _dispatch(ids, e, cap)
    buf = torch.zeros((e * cap + 1, d), dtype=dt, device=x.device)
    # indices repeat only at the drop slot, whose row is discarded
    buf.index_copy_(0, dest, xf.repeat_interleave(m.top_k, dim=0))
    expert_in = buf[:-1].reshape(e, cap, d)

    # --- per-expert FFN, batched over E --------------------------------------
    if cfg.gated:
        h = act(torch.bmm(expert_in, p["w_gate"].to(dt)))
        h = h * torch.bmm(expert_in, p["w_up"].to(dt))
    else:
        h = act(torch.bmm(expert_in, p["w_up"].to(dt)))
    expert_out = torch.bmm(h, p["w_down"].to(dt)).reshape(e * cap, d)

    # --- combine: gather back + gate-weighted sum over k ---------------------
    flat_out = torch.cat([expert_out, expert_out.new_zeros((1, d))])
    weight = (gates.reshape(-1) * keep).to(dt)
    y = (flat_out[dest] * weight[:, None]).reshape(n, m.top_k, d).sum(dim=1)

    # --- shared-expert path (dense, always on) -------------------------------
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
