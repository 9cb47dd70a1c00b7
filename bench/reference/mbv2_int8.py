"""Plain NumPy reference of the int8 MobileNetV2-VWW network.

It reads the quantized tree that the benchmark made (``families/mbv2_int8``)
and the float frames, and works out everything else again: the image's
quantization, the zero-point padding, each integer product and sum, the
requantization (float32 multiply, rounded half to even), ReLU6 in the
quantized domain, the residual rescale, the average pool and the
classifier. It follows the semantics that ``configs/mbv2-vww-int8.json``
states: TFLite int8 arithmetic, 3x3 convolutions padded by one zero-point
row and column on every side. It imports nothing of the port and no JAX.

Integer values are held in float32 arrays: every product of two int8
values, every sum of up to 336 of them with its bias, stays below 2**24 in
magnitude, where float32 is exact in any order of summation.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

F32 = np.float32
CHUNK = 64             # images per block of the reference's work


def relu6_max_q(scale, zp: int) -> int:
    """The quantized value of 6.0 in a domain, capped at 127."""
    return int(min(127, zp + round(6.0 / float(np.asarray(scale)))))


EXACT = 1 << 24


def quantize(x: np.ndarray, scale, zp: int) -> np.ndarray:
    q = np.round(x.astype(F32) / F32(scale))
    return np.clip(q + F32(zp), -128, 127)


def requantize(acc: np.ndarray, m, zp: int, *, relu: bool,
               hi: int = 127) -> np.ndarray:
    """int32 accumulator -> int8 value."""
    if acc.dtype != F32:
        raise TypeError(f"accumulator of {acc.dtype}, not float32")
    y = np.round(acc * np.asarray(m, F32)) + F32(zp)
    return np.clip(y, zp if relu else -128, min(hi, 127))


def product(a: np.ndarray, w, bias) -> np.ndarray:
    """Integer product over the last axis of int8 values ``a`` and ``w``,
    plus the int32 bias."""
    if a.shape[-1] * (1 << 14) >= EXACT:
        raise ValueError(f"K={a.shape[-1]}: float32 sums would not be exact")
    return a @ np.asarray(w, F32) + np.asarray(bias, F32)


def taps(xp: np.ndarray, ho: int, wo: int, stride: int):
    """(dy, dx, window) of a 3x3 stride-``stride`` window over a padded
    (N, Hp, Wp, C) map."""
    for dy in range(3):
        for dx in range(3):
            yield dy, dx, xp[:, dy:dy + (ho - 1) * stride + 1:stride,
                             dx:dx + (wo - 1) * stride + 1:stride, :]


def pad_zp(x: np.ndarray, zp: int) -> np.ndarray:
    return np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=zp)


def out_hw(h: int, w: int, stride: int):
    return -(-h // stride), -(-w // stride)


def block(x: np.ndarray, b: dict) -> np.ndarray:
    """One inverted-residual block, stage by stage, on int8 values."""
    cin, cmid, cout, stride = (int(b["spec"][k]) for k in
                               ("cin", "cmid", "cout", "stride"))
    zp_in, zp_f1 = b["qp_in"]["zero_point"], b["qp_f1"]["zero_point"]
    zp_f2, zp_out = b["qp_f2"]["zero_point"], b["qp_out"]["zero_point"]
    f1 = requantize(product(x, b["w_exp"], b["b_exp"]), b["m_exp"], zp_f1,
                    relu=True, hi=relu6_max_q(b["qp_f1"]["scale"], zp_f1))
    n, h, w, _ = x.shape
    ho, wo = out_hw(h, w, stride)
    acc = np.zeros((n, ho, wo, cmid), F32)
    w_dw = np.asarray(b["w_dw"], F32)
    for dy, dx, win in taps(pad_zp(f1, zp_f1), ho, wo, stride):
        acc += win * w_dw[dy, dx]
    f2 = requantize(acc + np.asarray(b["b_dw"], F32), b["m_dw"], zp_f2,
                    relu=True, hi=relu6_max_q(b["qp_f2"]["scale"], zp_f2))
    y = requantize(product(f2, b["w_proj"], b["b_proj"]), b["m_proj"], zp_out,
                   relu=False)
    if stride == 1 and cin == cout:           # TFLite quantized ADD
        s_y, s_x = F32(b["qp_out"]["scale"]), F32(b["qp_in"]["scale"])
        acc = s_y * (y - F32(zp_out)) + s_x * (x - F32(zp_in))
        y = np.clip(np.round(acc / s_y) + F32(zp_out), -128, 127)
    return y


def forward(tree: dict, imgs: np.ndarray) -> np.ndarray:
    """int8 logits (N, classes) of float frames (N, H, W, 3), blocks of
    ``CHUNK`` frames on a thread each (NumPy releases the interpreter lock
    in its array loops)."""
    blocks = [imgs[i:i + CHUNK] for i in range(0, len(imgs), CHUNK)]
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        out = list(pool.map(lambda b: _forward(tree, b), blocks))
    return np.concatenate(out).astype(np.int8)


def _forward(t: dict, imgs: np.ndarray) -> np.ndarray:
    zp_img = t["qp_img"]["zero_point"]
    x = quantize(imgs, t["qp_img"]["scale"], zp_img)
    n, hw = x.shape[0], x.shape[1]
    ho, wo = out_hw(hw, hw, 2)
    cols = np.concatenate([win for _, _, win in
                           taps(pad_zp(x, zp_img), ho, wo, 2)], axis=-1)
    w = np.asarray(t["stem_w"])
    zp_stem = t["qp_stem"]["zero_point"]
    x = requantize(product(cols, w.reshape(-1, w.shape[-1]), t["stem_b"]),
                   t["stem_m"], zp_stem, relu=True,
                   hi=relu6_max_q(t["qp_stem"]["scale"], zp_stem))
    for b in t["blocks"]:
        x = block(x, b)
    zp_head = t["qp_head"]["zero_point"]
    h = requantize(product(x, t["head_w"], t["head_b"]), t["head_m"], zp_head,
                   relu=True, hi=relu6_max_q(t["qp_head"]["scale"], zp_head))
    g = np.round(h.sum(axis=(1, 2)) / F32(h.shape[1] * h.shape[2]))
    g = np.clip(g, -128, 127)
    return requantize(product(g, t["fc_w"], t["fc_b"]), t["fc_m"],
                      t["qp_logits"]["zero_point"], relu=False)


def lower_precision(tree: dict) -> dict:
    """The control: the same network with every int8 weight held at int4
    precision (the nearest step below the configuration's int8)."""
    def int4(w):
        return (np.clip(np.round(np.asarray(w, np.float64) / 16), -8, 7)
                * 16).astype(np.int8)
    out = dict(tree, stem_w=int4(tree["stem_w"]), head_w=int4(tree["head_w"]),
               fc_w=int4(tree["fc_w"]))
    out["blocks"] = [dict(b, w_exp=int4(b["w_exp"]), w_dw=int4(b["w_dw"]),
                          w_proj=int4(b["w_proj"])) for b in tree["blocks"]]
    return out
