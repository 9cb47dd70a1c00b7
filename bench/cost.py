"""The benchmark's own count of the work: operations and bytes from shapes.

Frozen copies of the bound arithmetic of ``chip_smoke.py``: a kernel's least
time is max(operations / peak rate, bytes / HBM bandwidth), counting each
input and weight byte once and each output byte once. The counts depend
only on the work asked for, never on how the port plans it (no waves,
slices or padding). Model FLOPs count the useful work of a step: matrix
products at 2 operations a multiply-add, causal attention at each
position's own context, the LM head only where a token is produced.
"""

from __future__ import annotations

import math


def least_s(ops: float, nbytes: float, peak_ops: float,
            hbm_bytes: float) -> float:
    """The least time a call can take on the card."""
    return max(ops / peak_ops, nbytes / hbm_bytes)


# --- the int8 DSC block and the MobileNet -----------------------------------


def out_hw(h: int, w: int, stride: int):
    """SAME padding (TFLite): ceil division by the stride."""
    return -(-h // stride), -(-w // stride)


def dsc_macs(h: int, w: int, cin: int, cmid: int, cout: int, stride: int,
             kernel: int = 3) -> int:
    """Multiply-adds of one image through expansion, depthwise and
    projection (the paper's Section II formulas)."""
    h2, w2 = out_hw(h, w, stride)
    return (h * w * cin * cmid + h2 * w2 * kernel * kernel * cmid
            + h2 * w2 * cmid * cout)


def dsc_block_call(shapes) -> tuple:
    """(int8 ops, bytes) of one ``ops.dsc_block`` call from its arguments'
    shapes: x (B, H, W, Cin) int8, w_exp (Cin, Cmid), w_dw9 (9, Cmid),
    w_proj (Cmid, Cout), the three int32 biases and three f32 multipliers;
    the output (B, H2, W2, Cout) int8."""
    args, kw = shapes
    (b, h, w, cin), _ = args[0]
    (_, cmid), _ = args[1]
    (_, cout), _ = args[3]
    stride = kw["stride"]
    h2, w2 = out_hw(h, w, stride)
    ops = 2 * b * dsc_macs(h, w, cin, cmid, cout, stride)
    nbytes = b * h * w * cin + b * h2 * w2 * cout
    nbytes += sum(math.prod(shape) * item for shape, item in args[1:10])
    return ops, nbytes


def mbv2_ops_per_image(cfg: dict) -> int:
    """int8 operations of one image through the whole network: the 3x3 s2
    stem, every block, the 1x1 head and the FC (2 a multiply-add)."""
    hw, ch = cfg["img_hw"], cfg["img_ch"]
    s = cfg["stem"]
    h, w = out_hw(hw, hw, s["stride"])
    macs = h * w * s["kernel"] * s["kernel"] * ch * s["cout"]
    for _, cin, cmid, cout, stride in cfg["blocks"]:
        macs += dsc_macs(h, w, cin, cmid, cout, stride)
        h, w = out_hw(h, w, stride)
    macs += h * w * cfg["blocks"][-1][3] * cfg["head_ch"]
    macs += cfg["head_ch"] * cfg["n_classes"]
    return 2 * macs


# --- the LM ----------------------------------------------------------------


def ffn_call(shapes) -> tuple:
    """(flops, bytes) of one ``ops.ffn`` call: x (T, d), w_gate (d, f) or
    None, w_up (d, f), w_down (f, d); x, the weights and y moved once."""
    args, _ = shapes
    (t, d), item = args[0]
    gated = args[1] is not None
    (_, f), _ = args[2]
    n_w = 3 if gated else 2
    return 2 * n_w * t * d * f, item * (2 * t * d + n_w * d * f)


def lm_layer_matmul_params(arch: dict) -> int:
    """Weights of one layer's matrix products: q, k, v, o and the FFN."""
    d, hd = arch["d_model"], arch["head_dim"]
    h, hkv, f = arch["n_heads"], arch["n_kv_heads"], arch["d_ff"]
    attn = d * (h + 2 * hkv) * hd + h * hd * d
    ffn = (3 if arch["gated"] else 2) * d * f
    return attn + ffn


def lm_flops(arch: dict, kind: str, batch: int, length: int) -> float:
    """Model FLOPs of a prefill of ``batch`` prompts of ``length`` tokens
    (kind ``prefill``; the head at the last position only) or of one decode
    step whose token sits at position ``length`` (kind ``decode``)."""
    layers = arch["n_layers"]
    per_token = 2 * layers * lm_layer_matmul_params(arch)
    attn_per_ctx = 4 * layers * arch["n_heads"] * arch["head_dim"]
    head = 2 * arch["d_model"] * arch["vocab"]
    if kind == "prefill":
        ctx = length * (length + 1) / 2
        return batch * (per_token * length + attn_per_ctx * ctx + head)
    if kind == "decode":
        return batch * (per_token + attn_per_ctx * (length + 1) + head)
    raise ValueError(f"unknown LM call kind {kind!r}")


def work_ops(cfg: dict, item: tuple) -> float:
    """Model operations of one work item that a window records:
    ``("images", n)``, or an LM call ``(kind, batch, length)``."""
    if item[0] == "images":
        return item[1] * mbv2_ops_per_image(cfg)
    return lm_flops(cfg["arch"], *item)
