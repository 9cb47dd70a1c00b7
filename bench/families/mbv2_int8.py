"""The int8 MobileNetV2-VWW family: the paper's own deployment.

The benchmark draws float weights and calibration frames from the seed and
quantizes them with its own frozen copy of the TFLite post-training
quantizer (the port's ``mobilenetv2.init_and_quantize`` and
``dsc.quantize_dsc_block``, in NumPy), calibrated over several frames so
that every activation uses its int8 range. The quantized tree goes to the
port through ``mobilenetv2.params_from_numpy``, and to the reference as it
is. The entry that the window drives is ``mobilenetv2.forward_batch`` with
the fused DSC kernel, returning the int8 logits.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
ENTRY = "mobilenetv2.forward_batch(use_kernel=True, return_quantized=True)"
COVERS = "int8 logits of the stem, the seven fused blocks, head, GAP and FC"
CALIBRATION_FRAMES = 8


# --- the frozen quantizer --------------------------------------------------


def choose_qparams(x, channel_axis=None) -> dict:
    """Scale and zero point covering ``x``: per-channel symmetric for
    weights, per-tensor asymmetric for activations."""
    x = np.asarray(x)
    if channel_axis is not None:
        axes = tuple(i for i in range(x.ndim) if i != channel_axis)
        amax = np.maximum(np.abs(x).max(axis=axes), 1e-8)
        return {"scale": (amax / 127.0).astype(F32), "zero_point": 0}
    lo, hi = min(float(x.min()), 0.0), max(float(x.max()), 0.0)
    scale = max((hi - lo) / 255.0, 1e-8)
    zp = int(np.clip(int(round(-128 - lo / scale)), -128, 127))
    return {"scale": scale, "zero_point": zp}


def quantize_weights(w, qp, channel_axis) -> np.ndarray:
    shape = [1] * np.ndim(w)
    shape[channel_axis] = -1
    s = np.asarray(qp["scale"], F32).reshape(shape)
    return np.clip(np.round(np.asarray(w, F32) / s), -128, 127).astype(np.int8)


def effective_scale(s_in, s_w, s_out) -> np.ndarray:
    return (np.asarray(s_in, np.float64) * np.asarray(s_w, np.float64)
            / np.asarray(s_out, np.float64)).astype(F32)


def fold_zp(w_q, zp_in: int, axes) -> np.ndarray:
    """The -zp_in * sum_k(w) term, folded into the int32 bias."""
    return (-int(zp_in) * np.asarray(w_q, np.int64).sum(axis=axes)).astype(
        np.int32)


def relu6_max_q(qp: dict) -> int:
    return int(min(127, qp["zero_point"]
                   + round(6.0 / float(np.asarray(qp["scale"])))))


def conv3x3(x, w, stride: int) -> np.ndarray:
    """Float 3x3 convolution of (N, H, W, C), one zero on every side."""
    n, h, wd, _ = x.shape
    ho, wo = -(-h // stride), -(-wd // stride)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    cols = np.concatenate([xp[:, dy:dy + (ho - 1) * stride + 1:stride,
                              dx:dx + (wo - 1) * stride + 1:stride]
                           for dy in range(3) for dx in range(3)], axis=-1)
    return cols @ w.reshape(-1, w.shape[-1])


def depthwise3x3(x, w, stride: int) -> np.ndarray:
    n, h, wd, c = x.shape
    ho, wo = -(-h // stride), -(-wd // stride)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = np.zeros((n, ho, wo, c), F32)
    for dy in range(3):
        for dx in range(3):
            acc += xp[:, dy:dy + (ho - 1) * stride + 1:stride,
                      dx:dx + (wo - 1) * stride + 1:stride] * w[dy, dx]
    return acc


def quantize_block(p: dict, spec: dict, x) -> dict:
    """Post-training quantization of one float block over the calibration
    activations ``x`` (N, H, W, Cin)."""
    f1 = np.clip(x @ p["w_exp"] + p["b_exp"], 0, 6)
    f2 = np.clip(depthwise3x3(f1, p["w_dw"], spec["stride"]) + p["b_dw"],
                 0, 6)
    y = f2 @ p["w_proj"] + p["b_proj"]
    qp = {k: choose_qparams(v) for k, v in
          (("qp_in", x), ("qp_f1", f1), ("qp_f2", f2), ("qp_out", y))}
    qw = {"w_exp": choose_qparams(p["w_exp"], 1),
          "w_dw": choose_qparams(p["w_dw"], 2),
          "w_proj": choose_qparams(p["w_proj"], 1)}
    w_exp = quantize_weights(p["w_exp"], qw["w_exp"], 1)
    w_dw = quantize_weights(p["w_dw"], qw["w_dw"], 2)
    w_proj = quantize_weights(p["w_proj"], qw["w_proj"], 1)

    def qbias(b, s_in, s_w):
        return np.round(b / (np.asarray(s_in) * np.asarray(s_w))).astype(
            np.int64)

    s = {k: v["scale"] for k, v in qp.items()}
    zp = {k: v["zero_point"] for k, v in qp.items()}
    return dict(
        spec=dict(spec, kernel=3), **qp,
        w_exp=w_exp, w_dw=w_dw, w_proj=w_proj,
        b_exp=(qbias(p["b_exp"], s["qp_in"], qw["w_exp"]["scale"])
               + fold_zp(w_exp, zp["qp_in"], (0,))).astype(np.int32),
        b_dw=(qbias(p["b_dw"], s["qp_f1"], qw["w_dw"]["scale"])
              + fold_zp(w_dw, zp["qp_f1"], (0, 1))).astype(np.int32),
        b_proj=(qbias(p["b_proj"], s["qp_f2"], qw["w_proj"]["scale"])
                + fold_zp(w_proj, zp["qp_f2"], (0,))).astype(np.int32),
        m_exp=effective_scale(s["qp_in"], qw["w_exp"]["scale"], s["qp_f1"]),
        m_dw=effective_scale(s["qp_f1"], qw["w_dw"]["scale"], s["qp_f2"]),
        m_proj=effective_scale(s["qp_f2"], qw["w_proj"]["scale"],
                               s["qp_out"]),
        q6_f1=relu6_max_q(qp["qp_f1"]), q6_f2=relu6_max_q(qp["qp_f2"]))


def quantized_tree(cfg: dict, seed: int) -> dict:
    """The network's int8 tree, all from ``seed``: He-normal float weights,
    zero biases, calibrated on ``CALIBRATION_FRAMES`` standard-normal
    frames (the traffic's own distribution)."""
    rng = np.random.default_rng([seed, 0])
    hw, ch = cfg["img_hw"], cfg["img_ch"]
    imgs = rng.standard_normal((CALIBRATION_FRAMES, hw, hw, ch)).astype(F32)
    c0 = cfg["stem"]["cout"]
    stem_w = rng.standard_normal((3, 3, ch, c0)).astype(F32) * F32(0.3)
    x = np.clip(conv3x3(imgs, stem_w, cfg["stem"]["stride"]), 0, 6)
    qp_img, qp_stem = choose_qparams(imgs), choose_qparams(x)
    qpw = choose_qparams(stem_w, 3)
    stem_wq = quantize_weights(stem_w, qpw, 3)
    tree = dict(qp_img=qp_img, qp_stem=qp_stem, stem_w=stem_wq,
                stem_b=fold_zp(stem_wq, qp_img["zero_point"], (0, 1, 2)),
                stem_m=effective_scale(qp_img["scale"], qpw["scale"],
                                       qp_stem["scale"]), blocks=[])
    for _, cin, cmid, cout, stride in cfg["blocks"]:
        spec = {"cin": cin, "cmid": cmid, "cout": cout, "stride": stride}

        def he(shape, fan_in):
            return (rng.standard_normal(shape).astype(F32)
                    * F32(np.sqrt(2.0 / fan_in)))
        p = {"w_exp": he((cin, cmid), cin), "b_exp": np.zeros(cmid, F32),
             "w_dw": he((3, 3, cmid), 9), "b_dw": np.zeros(cmid, F32),
             "w_proj": he((cmid, cout), cmid), "b_proj": np.zeros(cout, F32)}
        tree["blocks"].append(quantize_block(p, spec, x))
        f1 = np.clip(x @ p["w_exp"] + p["b_exp"], 0, 6)
        f2 = np.clip(depthwise3x3(f1, p["w_dw"], stride) + p["b_dw"], 0, 6)
        y = f2 @ p["w_proj"] + p["b_proj"]
        x = y + x if (stride == 1 and cin == cout) else y
    head_ch, n_cls = cfg["head_ch"], cfg["n_classes"]
    head_w = rng.standard_normal((x.shape[-1], head_ch)).astype(F32) * F32(0.1)
    h = np.clip(x @ head_w, 0, 6)
    qp_in_head = tree["blocks"][-1]["qp_out"]
    qp_head, qpw_h = choose_qparams(h), choose_qparams(head_w, 1)
    head_wq = quantize_weights(head_w, qpw_h, 1)
    g = h.mean(axis=(1, 2))
    fc_w = rng.standard_normal((head_ch, n_cls)).astype(F32) * F32(0.1)
    qp_logits, qpw_fc = choose_qparams(g @ fc_w), choose_qparams(fc_w, 1)
    fc_wq = quantize_weights(fc_w, qpw_fc, 1)
    tree.update(
        head_w=head_wq,
        head_b=fold_zp(head_wq, qp_in_head["zero_point"], (0,)),
        head_m=effective_scale(qp_in_head["scale"], qpw_h["scale"],
                               qp_head["scale"]), qp_head=qp_head,
        fc_w=fc_wq, fc_b=fold_zp(fc_wq, qp_head["zero_point"], (0,)),
        fc_m=effective_scale(qp_head["scale"], qpw_fc["scale"],
                             qp_logits["scale"]), qp_logits=qp_logits)
    return tree


# --- the system under test ---------------------------------------------------


class System:
    """The port's network on ``device``, built from the benchmark's tree."""

    def __init__(self, cfg: dict, seed: int, device):
        from repro_torch.models import mobilenetv2
        self._mnv2 = mobilenetv2
        self.cfg = cfg
        self.tree = quantized_tree(cfg, seed)
        self.params = mobilenetv2.params_from_numpy(self.tree, device)

    @property
    def reference_args(self):
        return (self.tree,)

    def classify(self, imgs):
        """int8 logits (B, classes) of float frames (B, H, W, 3), on the
        parameters' device."""
        return self._mnv2.forward_batch(imgs, self.params, use_kernel=True,
                                        return_quantized=True)

