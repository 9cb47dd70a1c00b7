"""Fusion schedules: the paper's v0..v3 pipeline evolution (torch port).

The paper evolves one piece of hardware through three schedules (Fig. 9):

    v0  software layer-by-layer on the RISC-V core (baseline)
    v1  fused pixel-wise, sequential: Ex -> Dw -> Pr per pixel, no overlap
    v2  inter-stage pipeline: the three units work on pixels i+1, i, i-1
    v3  intra-stage pipeline: MAC and Quantize split -> 5 balanced stages

Two artifacts live here, as in ``repro.core.fusion``:

1. ``run_block(x, params, schedule)`` executes an int8 DSC block under a
   schedule. v0/v1 map to the reference / pixel-wise dataflows in
   ``core.dsc``; v2 is a literal 3-deep software pipeline (a loop of ticks
   whose carry holds the in-flight F1 tile and F2 vector, the pipeline
   registers); v3 maps to the row-tile dataflow. All four give
   bit-identical outputs: the schedules differ in when, never in what.

2. ``modeled_cycles(spec, h, w, schedule)``: the analytic cycle model of the
   paper's engines (9 expansion engines x 8-way MACs, one 9-way depthwise
   engine, 56 output-stationary projection engines), calibrated to the
   relative v1/v2/v3 gains of Fig. 14 and the cycle counts of Table III(A).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict

import torch

from repro_torch.core import dsc as dsc_mod
from repro_torch.core import quant
from repro_torch.core.dsc import DSCBlockSpec, QuantizedDSCParams


class Schedule(enum.Enum):
    V0_LAYER_BY_LAYER = "v0"
    V1_PIXEL_SEQUENTIAL = "v1"
    V2_INTER_STAGE = "v2"
    V3_INTRA_STAGE = "v3"


def run_block(x_q: torch.Tensor, p: QuantizedDSCParams, schedule: Schedule,
              **kw) -> torch.Tensor:
    if schedule is Schedule.V0_LAYER_BY_LAYER:
        return dsc_mod.dsc_block_reference(x_q, p)
    if schedule is Schedule.V1_PIXEL_SEQUENTIAL:
        return dsc_mod.dsc_block_fused_pixelwise(x_q, p)
    if schedule is Schedule.V2_INTER_STAGE:
        return dsc_block_pipelined(x_q, p)
    if schedule is Schedule.V3_INTRA_STAGE:
        return dsc_mod.dsc_block_fused_rowtile(x_q, p, **kw)
    raise ValueError(schedule)


# ---------------------------------------------------------------------------
# v2: a literal inter-stage pipeline
# ---------------------------------------------------------------------------


def dsc_block_pipelined(x_q: torch.Tensor,
                        p: QuantizedDSCParams) -> torch.Tensor:
    """3-stage software pipeline: tick t runs Expansion(pixel t),
    Depthwise(pixel t-1) and Projection(pixel t-2), with the carry playing
    the role of the paper's pipeline registers.

    The carry holds exactly one F1 tile (3x3xM) and one F2 vector (M,) per
    image, the total live intermediate state of the v2 hardware, whatever
    the feature-map size. The ticks are a Python loop over n + 2 pixels, so
    this is a model for small maps; leading batch axes run in lockstep.
    """
    spec = p.spec
    h, w = x_q.shape[-3], x_q.shape[-2]
    lead = x_q.shape[:-3]
    h2, w2 = spec.out_hw(h, w)
    n = h2 * w2
    k = spec.kernel
    iy, ix = dsc_mod._window_indices(h2, w2, spec.stride, k, x_q.device)
    flat_iy = iy.reshape(n, k, k)
    flat_ix = ix.reshape(n, k, k)

    def stage_ex(idx):
        wy = flat_iy[min(max(idx, 0), n - 1)]
        wx = flat_ix[min(max(idx, 0), n - 1)]
        win = dsc_mod.gather_window_otf(x_q, wy, wx, p.qp_in.zero_point)
        f1 = quant.requantize(dsc_mod._expansion_acc(win, p), p.m_exp,
                              p.qp_f1.zero_point, relu=True,
                              relu6_max_q=p.q6_f1)
        return f1.masked_fill(~dsc_mod._in_map(wy, wx, h, w)[..., None],
                              p.qp_f1.zero_point)

    def stage_dw(f1_tile):
        acc = dsc_mod._depthwise_acc_from_tile(f1_tile, p.w_dw, p.b_dw)
        return quant.requantize(acc, p.m_dw, p.qp_f2.zero_point,
                                relu=True, relu6_max_q=p.q6_f2)

    def stage_pr(f2_vec):
        return quant.requantize(dsc_mod._projection_acc(f2_vec, p), p.m_proj,
                                p.qp_out.zero_point, relu=False)

    f1_reg = torch.full(lead + (k, k, spec.cmid), p.qp_f1.zero_point,
                        dtype=torch.int8, device=x_q.device)
    f2_reg = torch.full(lead + (spec.cmid,), p.qp_f2.zero_point,
                        dtype=torch.int8, device=x_q.device)
    ys = []
    # n + 2 ticks: the 2 fill ticks produce garbage outputs that are dropped.
    for t in range(n + 2):
        y = stage_pr(f2_reg)             # projection consumes pixel t-2
        f2_reg = stage_dw(f1_reg)        # depthwise consumes pixel t-1
        f1_reg = stage_ex(t)             # expansion produces pixel t
        ys.append(y)
    y_q = torch.stack(ys[2:], dim=-2).reshape(lead + (h2, w2, spec.cout))
    if spec.has_residual:
        y_q = dsc_mod.residual_add_q(y_q, x_q, p)
    return y_q


# ---------------------------------------------------------------------------
# Analytic cycle model of the paper's engines
# ---------------------------------------------------------------------------

# The model has two layers:
#  * NOMINAL datapath throughput from Section III-B (9 expansion engines x
#    8-way MAC trees = 72 MACs/cyc, one 9-way depthwise engine, 56 OS
#    projection engines). This is the paper-hardware *roofline*.
#  * EFFECTIVE per-stage costs CALIBRATED to the paper's measurements
#    (Table III(A) + the 27.4x/46.3x/59.3x progression for block 3).
#    Solving the published cycle counts for a per-pixel linear model gives
#        v3 cycles/pixel = 2.1 * M * C + 350
#    which reproduces Table III(A) v3 for blocks 5/8/15 within 5% and the
#    v1/v2 ratios for block 3 within 1%. The gap between nominal (C/8 * M
#    per pixel) and effective (2.1 * C * M) is CPU->CFU instruction issue +
#    single-port buffer stalls, which the paper does not break out.
EXPANSION_MACS_PER_CYCLE = 9 * 8   # nominal
DEPTHWISE_MACS_PER_CYCLE = 9
PROJECTION_ENGINES = 56

# Calibrated effective per-mid-channel stage costs (cycles):
C_EX_PER_IN_CH = 2.1      # expansion: 2.1 cycles per (mid ch x in ch) pair
C_EXQ = 6.8               # expansion requantize, per mid channel
C_DW = 7.25               # depthwise MAC, per mid channel
C_DWQ = 6.8               # depthwise requantize, per mid channel
C_PR = 7.25               # projection MAC, per mid channel (per 56-out grp)
C_PX_FIXED = 350.0        # per-pixel fixed overhead (CFU issue + readback)

# Software baseline (v0): TFLite int8 kernels on VexRiscv. Cost per MAC is
# modeled as  a + b/L  where L is the kernel's inner-loop length (input
# channels for 1x1 convs, 9 taps for the depthwise) — the b/L term is the
# per-output loop overhead (requantize, address arithmetic, function calls)
# amortized over the inner loop. (a, b) least-squares fitted to the four
# published v0 cycle counts of Table III(A): reproduces them within 3% for
# blocks 3/8, ~20-30% for blocks 5/15. The intermediate feature-map
# transfer cost comes straight from Table VI (14.0M cycles / 307200 B =
# 45.6 cycles/byte).
SW_CYCLES_PER_MAC_A = 0.92
SW_CYCLES_PER_LOOP_B = 545.0
SW_CYCLES_PER_XFER_BYTE = 45.6


@dataclasses.dataclass(frozen=True)
class CycleReport:
    schedule: str
    cycles: float
    speedup_vs_v0: float


def _stage_cycles_per_pixel(spec: DSCBlockSpec) -> Dict[str, float]:
    """Effective (calibrated) per-pixel latency of each pipeline stage."""
    m, c, n = spec.cmid, spec.cin, spec.cout
    groups = -(-n // PROJECTION_ENGINES)
    return {
        "ex_mac": C_EX_PER_IN_CH * c * m,
        "ex_q": C_EXQ * m,
        "dw_mac": C_DW * m,
        "dw_q": C_DWQ * m,
        "pr_mac": C_PR * m * groups,
    }


def nominal_stage_cycles_per_pixel(spec: DSCBlockSpec) -> Dict[str, float]:
    """Datapath-limit stage latencies (the paper hardware's own roofline)."""
    m, c, n = spec.cmid, spec.cin, spec.cout
    k2 = spec.kernel * spec.kernel
    return {
        "ex_mac": k2 * m * c / EXPANSION_MACS_PER_CYCLE,
        "dw_mac": k2 * m / DEPTHWISE_MACS_PER_CYCLE,
        "pr_mac": m * -(-n // PROJECTION_ENGINES),
    }


def modeled_cycles(spec: DSCBlockSpec, h: int, w: int,
                   schedule: Schedule) -> float:
    """Total cycles for one block under a schedule (paper's hardware)."""
    h2, w2 = spec.out_hw(h, w)
    n_px = h2 * w2
    st = _stage_cycles_per_pixel(spec)
    if schedule is Schedule.V0_LAYER_BY_LAYER:
        macs = spec.macs(h, w)
        inner = {"expansion": spec.cin, "depthwise": spec.kernel ** 2,
                 "projection": spec.cmid}
        mac_cycles = sum(
            m * (SW_CYCLES_PER_MAC_A + SW_CYCLES_PER_LOOP_B / inner[k])
            for k, m in macs.items())
        xfer_bytes = 2 * (h * w * spec.cmid) + 2 * (h2 * w2 * spec.cmid)
        return mac_cycles + xfer_bytes * SW_CYCLES_PER_XFER_BYTE
    if schedule is Schedule.V1_PIXEL_SEQUENTIAL:
        return n_px * (sum(st.values()) + C_PX_FIXED)
    if schedule is Schedule.V2_INTER_STAGE:
        stages = [st["ex_mac"] + st["ex_q"], st["dw_mac"] + st["dw_q"],
                  st["pr_mac"]]
        return (n_px + 2) * (max(stages) + C_PX_FIXED)  # II = slowest stage
    if schedule is Schedule.V3_INTRA_STAGE:
        return (n_px + 4) * (max(st.values()) + C_PX_FIXED)
    raise ValueError(schedule)


def speedup_table(spec: DSCBlockSpec, h: int, w: int) -> Dict[str, CycleReport]:
    base = modeled_cycles(spec, h, w, Schedule.V0_LAYER_BY_LAYER)
    out = {}
    for s in Schedule:
        c = modeled_cycles(spec, h, w, s)
        out[s.value] = CycleReport(s.value, c, base / c)
    return out
