"""The port's DSC block disciplines against the JAX reference: the same
float parameters quantize to the same int8 block, and v0 / v3 (any row
tiling) give the reference's int8 output bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dsc as jdsc
from repro.core import quant as jquant
from repro.core.dsc import DSCBlockSpec
from repro_torch.core import dsc as tdsc
from repro_torch.core import fusion as tfusion
from repro_torch.models import mobilenetv2 as tmnv2

# tests/test_dsc.py SPECS
SPECS = [
    (DSCBlockSpec(cin=8, cmid=48, cout=8, stride=1), 12),     # residual
    (DSCBlockSpec(cin=8, cmid=48, cout=16, stride=2), 12),    # downsample
    (DSCBlockSpec(cin=16, cmid=96, cout=16, stride=1), 10),   # paper 5th
    (DSCBlockSpec(cin=8, cmid=24, cout=8, stride=1), 7),      # odd H/W
]


def to_numpy(obj):
    """A JAX parameter tree as plain numpy arrays, ints, floats and dicts."""
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, list):
        return [to_numpy(o) for o in obj]
    if obj is None or isinstance(obj, (bool, int, float)):
        return obj
    return np.asarray(obj)


def jax_block(spec, hw, seed=0):
    """The reference's block and input, built as tests/test_dsc.py does."""
    p32 = jdsc.init_dsc_block_f32(jax.random.PRNGKey(seed), spec)
    calib = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1),
                                         (hw, hw, spec.cin)))
    qp = jdsc.quantize_dsc_block(p32, spec, calib)
    x_q = np.asarray(jquant.quantize(calib, qp.qp_in))
    return p32, calib, qp, x_q


@pytest.mark.parametrize("spec,hw", SPECS)
def test_quantize_dsc_block_equal(spec, hw):
    p32, calib, jqp, _ = jax_block(spec, hw)
    tqp = tdsc.quantize_dsc_block({k: np.asarray(v) for k, v in p32.items()},
                                  spec, calib)
    for name in ("w_exp", "w_dw", "w_proj", "b_exp", "b_dw", "b_proj",
                 "m_exp", "m_dw", "m_proj"):
        np.testing.assert_array_equal(getattr(tqp, name).numpy(),
                                      np.asarray(getattr(jqp, name)),
                                      err_msg=name)
    for name in ("qp_in", "qp_f1", "qp_f2", "qp_out"):
        a, b = getattr(jqp, name), getattr(tqp, name)
        assert (a.scale, a.zero_point) == (b.scale, b.zero_point), name
    assert (tqp.q6_f1, tqp.q6_f2) == (jqp.q6_f1, jqp.q6_f2)


@pytest.mark.parametrize("spec,hw", SPECS)
def test_reference_and_rowtile_match_jax(spec, hw):
    _, _, jqp, x_q = jax_block(spec, hw)
    want = np.asarray(jdsc.dsc_block_reference(jnp.asarray(x_q), jqp))
    tqp = tmnv2.params_from_numpy(to_numpy(jqp), device="cpu")
    x = torch.from_numpy(x_q)
    np.testing.assert_array_equal(tdsc.dsc_block_reference(x, tqp).numpy(),
                                  want)
    for tile_rows in (1, 2, 3, 5):
        got = tdsc.dsc_block_fused_rowtile(x, tqp, tile_rows=tile_rows)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"tile_rows={tile_rows}")
    # a leading batch axis computes each image on its own
    batch = torch.stack([x, x.flip(0)])
    got = tdsc.dsc_block_fused_rowtile(batch, tqp)
    np.testing.assert_array_equal(got[0].numpy(), want)
    np.testing.assert_array_equal(
        got[1].numpy(), tdsc.dsc_block_reference(x.flip(0), tqp).numpy())


def test_residual_add_q_matches_jax():
    spec = DSCBlockSpec(cin=8, cmid=48, cout=8, stride=1)
    _, _, jqp, x_q = jax_block(spec, 12)
    rng = np.random.default_rng(0)
    y_q = rng.integers(-128, 128, x_q.shape).astype(np.int8)
    want = np.asarray(jdsc.residual_add_q(jnp.asarray(y_q),
                                          jnp.asarray(x_q), jqp))
    tqp = tmnv2.params_from_numpy(to_numpy(jqp), device="cpu")
    got = tdsc.residual_add_q(torch.from_numpy(y_q), torch.from_numpy(x_q),
                              tqp)
    np.testing.assert_array_equal(got.numpy(), want)


def test_run_block_schedules():
    spec, hw = SPECS[0]
    _, _, jqp, x_q = jax_block(spec, hw)
    tqp = tmnv2.params_from_numpy(to_numpy(jqp), device="cpu")
    x = torch.from_numpy(x_q)
    v0 = tfusion.run_block(x, tqp, tfusion.Schedule.V0_LAYER_BY_LAYER)
    v3 = tfusion.run_block(x, tqp, tfusion.Schedule.V3_INTRA_STAGE,
                           tile_rows=3)
    assert torch.equal(v0, v3)
    for sched in (tfusion.Schedule.V1_PIXEL_SEQUENTIAL,
                  tfusion.Schedule.V2_INTER_STAGE):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
            tfusion.run_block(x, tqp, sched)
