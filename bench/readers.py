"""What the per-layer metrics' readers share: shares of the device's time,
of a kernel's roofline and of the card's peak, from a traced window.

A reader that finds nothing to read returns None, and the metric is left
out of the result; none returns 0 for a share of a roofline or a peak.
"""

from __future__ import annotations

from bench import cost

DSC = "repro_torch.kernels.ops:dsc_block"
FFN = "repro_torch.kernels.ops:ffn"
# the peak that a configuration's precision is held to
RATE_OF = {"int8": "int8_ops", "bfloat16": "bf16_flops"}


def idle_share(v):
    """Per cent of the traced window in which no operation ran on the
    device."""
    t = v.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline(v, entry: str, count, peak: str):
    """Per cent of the kernels' device time under ``entry``'s spans that
    the work of those calls needs at least: calls x max(ops / peak, bytes /
    HBM bandwidth), each call's ops and bytes from ``count(shapes)``."""
    calls = (v.calls or {}).get(entry)
    kernel_s = v.trace.span_kernel_s.get(entry, 0.0) if v.trace else 0.0
    if not calls or kernel_s <= 0:
        return None
    least = sum(cost.least_s(*count(c), v.peaks[peak], v.peaks["hbm_bytes"])
                for c in calls)
    return 100.0 * least / kernel_s


def mfu(v):
    """Per cent of the card's peak, at the configuration's precision, that
    the window's useful work, counted from its shapes by ``cost``, would
    fill."""
    t = v.trace
    if t is None or t.window_s <= 0 or not v.rec.work:
        return None
    ops = sum(cost.work_ops(v.cfg, w) for w in v.rec.work)
    return 100.0 * ops / (t.window_s * v.peaks[RATE_OF[v.cfg["precision"]]])


def dsc_roofline(v):
    return roofline(v, DSC, cost.dsc_block_call, "int8_ops")


def ffn_roofline(v):
    return roofline(v, FFN, cost.ffn_call, "bf16_flops")
