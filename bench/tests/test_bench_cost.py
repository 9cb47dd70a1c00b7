"""The benchmark's counts of operations and bytes against hand counts."""

import json

import numpy as np
import torch

from bench import cost, trace
from bench.families import mbv2_int8
from conftest import ROOT

GLM4 = json.loads((ROOT / "bench" / "configs" / "glm4-9b.json").read_text())
MBV2 = json.loads((ROOT / "bench" / "configs" /
                   "mbv2-vww-int8.json").read_text())


def test_dsc_block_counts_from_the_wrapped_call():
    """Block "3rd" (8 -> 48 -> 8, stride 1, 40x40) at batch 2, its shapes
    as the span's wrapper records them from a real call."""
    from repro_torch.kernels import ops
    from repro_torch.models import mobilenetv2
    tree = mbv2_int8.quantized_tree(MBV2, 3)
    net = mobilenetv2.params_from_numpy(tree, "cpu")
    with trace.Spans(["repro_torch.kernels.ops:dsc_block"]) as spans:
        spans.recording = True
        qp = net.blocks[0]
        x = torch.zeros((2, 40, 40, 8), dtype=torch.int8)
        ops.dsc_block(x, qp.w_exp, qp.w_dw.reshape(9, 48), qp.w_proj,
                      qp.b_exp, qp.b_dw, qp.b_proj, qp.m_exp, qp.m_dw,
                      qp.m_proj, stride=1, zps=qp.zps,
                      q6=(qp.q6_f1, qp.q6_f2))
    (call,) = spans.calls["repro_torch.kernels.ops:dsc_block"]
    ops_, nbytes = cost.dsc_block_call(call)
    macs = 40 * 40 * 8 * 48 + 40 * 40 * 9 * 48 + 40 * 40 * 48 * 8
    assert ops_ == 2 * 2 * macs == 7_680_000
    # x and y int8; w_exp, w_dw, w_proj int8; three int32 biases and three
    # f32 multipliers of 48, 48 and 8 channels
    assert nbytes == (2 * 2 * 1600 * 8 + 384 + 432 + 384
                      + 2 * 4 * (48 + 48 + 8))


def test_ffn_counts():
    shapes = ((((2048, 4096), 2), ((4096, 13696), 2), ((4096, 13696), 2),
               ((13696, 4096), 2)), {"act": "silu"})
    flops, nbytes = cost.ffn_call(shapes)
    assert flops == 6 * 2048 * 4096 * 13696 == 689_342_251_008
    assert nbytes == 2 * (2 * 2048 * 4096 + 3 * 4096 * 13696) == 370_147_328
    ungated = ((shapes[0][0], None) + shapes[0][2:], {})
    assert cost.ffn_call(ungated) == (4 * 2048 * 4096 * 13696,
                                      2 * (2 * 2048 * 4096
                                           + 2 * 4096 * 13696))


def test_mbv2_ops_per_image():
    stem = 40 * 40 * 9 * 3 * 8
    blocks = [(40, 40, 8, 48, 8, 40), (40, 20, 8, 48, 16, 20),
              (20, 20, 16, 96, 16, 20), (20, 10, 16, 96, 24, 10),
              (10, 10, 24, 144, 24, 10), (10, 5, 24, 144, 56, 5),
              (5, 5, 56, 336, 56, 5)]
    macs = stem + sum(h * h * ci * cm + o * o * 9 * cm + o * o * cm * co
                      for h, _, ci, cm, co, o in blocks)
    macs += 5 * 5 * 56 * 128 + 128 * 2
    assert macs == 8_461_856
    assert cost.mbv2_ops_per_image(MBV2) == 2 * macs


def test_lm_flops_glm4():
    a = GLM4["arch"]
    layer = 4096 * (32 + 2 + 2) * 128 + 32 * 128 * 4096 + 3 * 4096 * 13696
    assert cost.lm_layer_matmul_params(a) == layer == 203_948_032
    attn = 4 * 40 * 32 * 128
    head = 2 * 4096 * 151552
    assert cost.lm_flops(a, "prefill", 1, 2048) == (
        2 * 40 * layer * 2048 + attn * 2048 * 2049 / 2 + head)
    assert cost.lm_flops(a, "decode", 16, 200) == 16 * (
        2 * 40 * layer + attn * 201 + head)


def test_least_time_is_the_larger_bound():
    assert cost.least_s(989e12, 1.0, 989e12, 3.35e12) == 1.0
    assert np.isclose(cost.least_s(1.0, 6.7e12, 989e12, 3.35e12), 2.0)
