"""The port's int8 MobileNetV2-VWW forward against the JAX reference.

The JAX package builds the network once (seed 0, 32x32: at 16x16 the logits
saturate and would hide a wrong result); ``params_from_numpy`` carries it
across. Every stage's int8 output (stem, seven blocks, logits) must be equal,
for the port's v0, v3 and kernel paths (the kernel's plain version here).
The 80x80 network is held bit-exact on the card by chip_smoke.py.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.core.fusion import Schedule as JSchedule
from repro.core.fusion import run_block as jrun_block
from repro.models import mobilenetv2 as jmnv2
from repro_torch.core.fusion import Schedule
from repro_torch.kernels import fused_dsc
from repro_torch.models import mobilenetv2 as tmnv2

from test_torch_dsc import to_numpy

STAGES = ["stem"] + [name for name, *_ in jmnv2.PAPER_BLOCKS] + ["logits"]


@pytest.fixture(scope="module")
def case():
    net = jmnv2.init_and_quantize(jax.random.PRNGKey(0), img_hw=32)
    imgs = np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)

    def stages(img):
        x = jmnv2._stem_int8(jquant.quantize(img, net.qp_img), net)
        out = [x]
        for qp in net.blocks:
            x = jrun_block(x, qp, JSchedule.V0_LAYER_BY_LAYER)
            out.append(x)
        out.append(jmnv2.forward_int8(img, net, return_quantized=True,
                                      schedule=JSchedule.V0_LAYER_BY_LAYER))
        return out

    want = [np.asarray(s) for s in jax.jit(jax.vmap(stages))(imgs)]
    pallas = jax.jit(lambda im: jmnv2.forward_int8(
        im, net, use_pallas=True, return_quantized=True))
    want_pallas = np.stack([np.asarray(pallas(im)) for im in imgs])
    want_deq = np.asarray(jax.jit(jax.vmap(lambda im: jmnv2.forward_int8(
        im, net, schedule=JSchedule.V0_LAYER_BY_LAYER)))(imgs))
    port = tmnv2.params_from_numpy(to_numpy(net), device="cpu")
    return dict(imgs=imgs, want=want, want_pallas=want_pallas,
                want_deq=want_deq, port=port)


@pytest.mark.parametrize("path", ["v0", "v3", "kernel"])
def test_every_stage_matches_jax(case, path):
    schedule = (Schedule.V0_LAYER_BY_LAYER if path == "v0"
                else Schedule.V3_INTRA_STAGE)
    got = tmnv2.forward_stages(case["imgs"], case["port"], schedule,
                               use_kernel=path == "kernel")
    assert len(got) == len(STAGES)
    for name, g, w in zip(STAGES, got, case["want"]):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"stage {name}")
    # the logits are not saturated: a wrong block would show
    assert np.abs(case["want"][-1]).max() < 127


def test_kernel_path_matches_jax_pallas_and_counts_no_launch(case):
    before = fused_dsc.LAUNCHES
    got = tmnv2.forward_batch(case["imgs"], case["port"], use_kernel=True,
                              return_quantized=True)
    assert fused_dsc.LAUNCHES == before   # CPU tensors: the plain version
    np.testing.assert_array_equal(got.numpy(), case["want_pallas"])


def test_dequantized_logits_and_single_image_equal(case):
    got = tmnv2.forward_batch(case["imgs"], case["port"],
                              schedule=Schedule.V0_LAYER_BY_LAYER)
    assert got.dtype == torch.float32 and got.shape == (2, 2)
    np.testing.assert_array_equal(got.numpy(), case["want_deq"])
    one = tmnv2.forward_int8(case["imgs"][1], case["port"],
                             return_quantized=True)
    np.testing.assert_array_equal(one.numpy(), case["want"][-1][1])


def test_port_network_runs_and_raises_without_card():
    net = tmnv2.init_and_quantize(3, img_hw=16, device="cpu")
    assert [b.spec for b in net.blocks] == [s for _, s in tmnv2.block_specs()]
    imgs = np.random.default_rng(3).standard_normal((2, 16, 16, 3))
    v0 = tmnv2.forward_batch(imgs, net, schedule=Schedule.V0_LAYER_BY_LAYER,
                             return_quantized=True)
    v3 = tmnv2.forward_batch(imgs, net, return_quantized=True)
    assert v0.dtype == torch.int8 and torch.equal(v0, v3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmnv2.init_and_quantize(3, img_hw=16)
