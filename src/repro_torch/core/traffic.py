"""Analytic data-movement model (paper Eq. 1/2, Tables VI & VII).

All quantities are BYTES for int8 tensors unless noted. The three execution
models compared in the paper:

* layer-by-layer via DRAM (Eq. 1):   every intermediate is written to and
  read back from off-chip memory.
* layer-by-layer via SRAM buffer (Eq. 2): intermediates stay on chip but
  require a buffer of at least H1*W1*C1 bytes.
* fused pixel-wise (this work):      intermediates never exist in memory;
  only the block input, the three filters, and the block output move.

On TPU the analogue of "DRAM traffic" is HBM traffic and the analogue of
"on-chip buffer" is VMEM footprint; benchmarks/bench_traffic.py checks this
model against the bytes reported by XLA's cost analysis for the reference
vs fused lowerings.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core.dsc import DSCBlockSpec


@dataclasses.dataclass(frozen=True)
class BlockTraffic:
    name: str
    intermediate_bytes: int      # bytes of F1+F2 moved (baseline)
    buffer_bytes: int            # Eq. 2 minimum SRAM buffer
    baseline_total: int          # all bytes moved, layer-by-layer
    fused_total: int             # all bytes moved, fused dataflow
    reduction_pct: float


def intermediate_feature_bytes(spec: DSCBlockSpec, h: int, w: int) -> int:
    """Paper Eq. 1 (bytes for int8): 2*(H1 W1 C1) + 2*(H2 W2 C2).

    F1 is the expanded map (H x W x M, at the *input* resolution), F2 is the
    depthwise output (H2 x W2 x M).
    """
    h2, w2 = spec.out_hw(h, w)
    return 2 * (h * w * spec.cmid) + 2 * (h2 * w2 * spec.cmid)


def min_sram_buffer_bytes(spec: DSCBlockSpec, h: int, w: int) -> int:
    """Paper Eq. 2: a pipelined non-fused design must buffer all of F1."""
    return h * w * spec.cmid


def weight_bytes(spec: DSCBlockSpec) -> int:
    return (spec.cin * spec.cmid
            + spec.kernel * spec.kernel * spec.cmid
            + spec.cmid * spec.cout)


def io_bytes(spec: DSCBlockSpec, h: int, w: int) -> int:
    h2, w2 = spec.out_hw(h, w)
    inp = h * w * spec.cin
    out = h2 * w2 * spec.cout
    if spec.has_residual:
        inp *= 2  # residual path reads the input again
    return inp + out


def block_traffic(spec: DSCBlockSpec, h: int, w: int,
                  name: str = "") -> BlockTraffic:
    inter = intermediate_feature_bytes(spec, h, w)
    base = io_bytes(spec, h, w) + weight_bytes(spec) + inter
    fused = io_bytes(spec, h, w) + weight_bytes(spec)
    return BlockTraffic(
        name=name,
        intermediate_bytes=inter,
        buffer_bytes=min_sram_buffer_bytes(spec, h, w),
        baseline_total=base,
        fused_total=fused,
        reduction_pct=100.0 * (1.0 - fused / base),
    )


def network_traffic(blocks: List[Tuple[str, DSCBlockSpec, int, int]]
                    ) -> Dict[str, object]:
    """Aggregate over a whole network (list of (name, spec, h, w))."""
    rows = [block_traffic(s, h, w, name) for name, s, h, w in blocks]
    base = sum(r.baseline_total for r in rows)
    fused = sum(r.fused_total for r in rows)
    return {
        "rows": rows,
        "baseline_total": base,
        "fused_total": fused,
        "reduction_pct": 100.0 * (1.0 - fused / base),
    }


# ---------------------------------------------------------------------------
# LM generalization: d_ff intermediate traffic for an expand->mix->project
# transformer FFN (DESIGN.md §3), bf16 activations.
# ---------------------------------------------------------------------------


def ffn_intermediate_bytes(tokens: int, d_ff: int, *, gated: bool = True,
                           bytes_per_el: int = 2) -> int:
    """HBM bytes for the d_ff intermediates in layer-by-layer execution:
    write + read of h_gate and h_up (if gated) and of the activated h."""
    n_tensors = 3 if gated else 2  # gate, up, act(h)  vs  h, act(h)
    return 2 * tokens * d_ff * n_tensors * bytes_per_el


def ffn_io_bytes(tokens: int, d_model: int, d_ff: int, *,
                 gated: bool = True, bytes_per_el: int = 2) -> int:
    w = (2 if gated else 1) * d_model * d_ff + d_ff * d_model
    return (2 * tokens * d_model + w) * bytes_per_el


def ffn_traffic_reduction(tokens: int, d_model: int, d_ff: int, *,
                          gated: bool = True) -> Dict[str, float]:
    inter = ffn_intermediate_bytes(tokens, d_ff, gated=gated)
    io = ffn_io_bytes(tokens, d_model, d_ff, gated=gated)
    return {
        "baseline_bytes": io + inter,
        "fused_bytes": io,
        "reduction_pct": 100.0 * inter / (io + inter),
    }
