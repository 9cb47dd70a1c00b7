"""The port's fusion schedules, traffic model and cycle model against the
JAX reference.

v1 (fused pixel-wise) and v2 (the literal inter-stage pipeline) must give
the reference's int8 output bit for bit on the tests/test_dsc.py cases, with
the reference's own quantized blocks carried across by
``params_from_numpy``. The Eq. 1/2 traffic model and the calibrated cycle
model are pure Python: their numbers must be equal (``==``), and the
Fig. 14 / Table III(A) checks of tests/test_fusion_model.py must hold on
the port.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dsc as jdsc
from repro.core import fusion as jfusion
from repro.core import traffic as jtraffic
from repro.core.dsc import DSCBlockSpec as JSpec
from repro_torch.core import dsc as tdsc
from repro_torch.core import fusion as tfusion
from repro_torch.core import traffic as ttraffic
from repro_torch.core.dsc import DSCBlockSpec
from repro_torch.models import mobilenetv2 as tmnv2

from test_torch_dsc import SPECS, jax_block, to_numpy

V1, V2 = tfusion.Schedule.V1_PIXEL_SEQUENTIAL, tfusion.Schedule.V2_INTER_STAGE


def _port(jqp):
    return tmnv2.params_from_numpy(to_numpy(jqp), device="cpu")


@pytest.mark.parametrize("spec,hw", SPECS)
@pytest.mark.parametrize("sched", [V1, V2], ids=["v1", "v2"])
def test_v1_v2_match_jax(spec, hw, sched):
    _, _, jqp, x_q = jax_block(spec, hw)
    jsched = jfusion.Schedule(sched.value)
    want = np.asarray(jfusion.run_block(jnp.asarray(x_q), jqp, jsched))
    np.testing.assert_array_equal(
        np.asarray(jdsc.dsc_block_reference(jnp.asarray(x_q), jqp)), want)
    got = tfusion.run_block(torch.from_numpy(x_q), _port(jqp), sched)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want, err_msg=str(sched))


@pytest.mark.parametrize("sched", [V1, V2], ids=["v1", "v2"])
def test_v1_v2_batched_images_independent(sched):
    spec, hw = SPECS[1]                      # stride 2
    _, _, jqp, x_q = jax_block(spec, hw)
    tqp = _port(jqp)
    x = torch.from_numpy(x_q)
    batch = torch.stack([x, x.flip(0), x.flip(1)])
    got = tfusion.run_block(batch, tqp, sched)
    for i in range(3):
        np.testing.assert_array_equal(
            got[i].numpy(), tdsc.dsc_block_reference(batch[i], tqp).numpy())


def test_on_the_fly_padding_matches_explicit_and_jax():
    """Fig. 13: the F1-domain mask of out-of-map taps, pinned on a map so
    small that most windows touch the border."""
    spec = DSCBlockSpec(cin=8, cmid=48, cout=8, stride=1)
    _, _, jqp, x_q = jax_block(spec, 6)
    want = np.asarray(jdsc.dsc_block_fused_pixelwise(jnp.asarray(x_q), jqp))
    got = tdsc.dsc_block_fused_pixelwise(torch.from_numpy(x_q), _port(jqp))
    np.testing.assert_array_equal(got.numpy(), want)
    iy, ix = tdsc._window_indices(3, 3, 2, 3)
    jy, jx = jdsc._window_indices(3, 3, 2, 3)
    np.testing.assert_array_equal(iy.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(ix.numpy(), np.asarray(jx))


def test_gather_window_otf_matches_jax():
    x = np.random.default_rng(0).integers(-128, 128, (5, 7, 4)
                                          ).astype(np.int8)
    jy, jx = jdsc._window_indices(3, 4, 2, 3)
    want = np.asarray(jdsc.gather_window_otf(jnp.asarray(x), jy, jx, -7))
    iy, ix = tdsc._window_indices(3, 4, 2, 3)
    got = tdsc.gather_window_otf(torch.from_numpy(x), iy, ix, -7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_run_block_every_schedule_runs():
    spec, hw = SPECS[3]                      # odd H/W
    _, _, jqp, x_q = jax_block(spec, hw)
    tqp = _port(jqp)
    x = torch.from_numpy(x_q)
    v0 = tfusion.run_block(x, tqp, tfusion.Schedule.V0_LAYER_BY_LAYER)
    for sched in tfusion.Schedule:
        assert torch.equal(tfusion.run_block(x, tqp, sched), v0), sched


# --- Eq. 1/2 traffic model ---------------------------------------------------

TRAFFIC_SPECS = [(8, 48, 8, 1, 40), (8, 48, 16, 2, 40), (16, 96, 16, 1, 20),
                 (24, 144, 56, 2, 10), (56, 336, 56, 1, 5), (5, 30, 7, 1, 9)]


def _specs(ci, cm, co, s):
    return (JSpec(cin=ci, cmid=cm, cout=co, stride=s),
            DSCBlockSpec(cin=ci, cmid=cm, cout=co, stride=s))


@pytest.mark.parametrize("ci,cm,co,s,hw", TRAFFIC_SPECS)
def test_block_traffic_equal(ci, cm, co, s, hw):
    js, ts = _specs(ci, cm, co, s)
    for fn in ("intermediate_feature_bytes", "min_sram_buffer_bytes",
               "io_bytes"):
        assert (getattr(ttraffic, fn)(ts, hw, hw)
                == getattr(jtraffic, fn)(js, hw, hw)), fn
    assert ttraffic.weight_bytes(ts) == jtraffic.weight_bytes(js)
    assert (dataclasses.asdict(ttraffic.block_traffic(ts, hw, hw, "b"))
            == dataclasses.asdict(jtraffic.block_traffic(js, hw, hw, "b")))


def test_network_and_ffn_traffic_equal():
    rows_j = [(f"b{i}", _specs(*t[:4])[0], t[4], t[4])
              for i, t in enumerate(TRAFFIC_SPECS)]
    rows_t = [(f"b{i}", _specs(*t[:4])[1], t[4], t[4])
              for i, t in enumerate(TRAFFIC_SPECS)]
    got, want = ttraffic.network_traffic(rows_t), jtraffic.network_traffic(
        rows_j)
    assert [dataclasses.asdict(r) for r in got.pop("rows")] == [
        dataclasses.asdict(r) for r in want.pop("rows")]
    assert got == want
    for gated in (True, False):
        kw = dict(tokens=4096, d_model=8192, d_ff=29568, gated=gated)
        assert (ttraffic.ffn_traffic_reduction(**kw)
                == jtraffic.ffn_traffic_reduction(**kw))


def test_table_vi_and_eq2_on_port():
    """tests/test_traffic.py's exact Table VI counts, on the port."""
    want = {(8, 48, 8, 40): 307_200, (16, 96, 16, 20): 153_600,
            (24, 144, 24, 10): 57_600, (56, 336, 56, 5): 33_600}
    for (ci, cm, co, hw), b in want.items():
        spec = DSCBlockSpec(cin=ci, cmid=cm, cout=co)
        assert ttraffic.intermediate_feature_bytes(spec, hw, hw) == b
    assert ttraffic.min_sram_buffer_bytes(
        DSCBlockSpec(cin=16, cmid=96, cout=16), 20, 20) == 38_400


# --- calibrated cycle model --------------------------------------------------

LAYERS = {
    "3rd": ((8, 48, 8, 1), 40),
    "5th": ((16, 96, 16, 1), 20),
    "8th": ((24, 144, 24, 1), 10),
    "15th": ((56, 336, 56, 1), 5),
    "b2": ((8, 48, 16, 2), 40),
    "odd": ((5, 30, 7, 1), 9),
}


def test_calibrated_constants_equal():
    names = [n for n in dir(jfusion) if n.isupper()]
    assert names
    for n in names:
        assert getattr(tfusion, n) == getattr(jfusion, n), n


@pytest.mark.parametrize("layer", list(LAYERS))
def test_modeled_cycles_and_speedup_table_equal(layer):
    (ci, cm, co, s), hw = LAYERS[layer]
    js, ts = _specs(ci, cm, co, s)
    for sched in tfusion.Schedule:
        jsched = jfusion.Schedule(sched.value)
        assert (tfusion.modeled_cycles(ts, hw, hw, sched)
                == jfusion.modeled_cycles(js, hw, hw, jsched)), sched
    got = {k: dataclasses.asdict(v)
           for k, v in tfusion.speedup_table(ts, hw, hw).items()}
    want = {k: dataclasses.asdict(v)
            for k, v in jfusion.speedup_table(js, hw, hw).items()}
    assert got == want
    assert (tfusion.nominal_stage_cycles_per_pixel(ts)
            == jfusion.nominal_stage_cycles_per_pixel(js))


def test_fig14_layer3_speedup_progression_on_port():
    tbl = tfusion.speedup_table(DSCBlockSpec(cin=8, cmid=48, cout=8), 40, 40)
    assert tbl["v1"].speedup_vs_v0 == pytest.approx(27.4, rel=0.10)
    assert tbl["v2"].speedup_vs_v0 == pytest.approx(46.3, rel=0.10)
    assert tbl["v3"].speedup_vs_v0 == pytest.approx(59.3, rel=0.10)


TABLE_III = {"3rd": (109.7e6, 1.8e6), "5th": (46.1e6, 1.4e6),
             "8th": (20.5e6, 0.76e6), "15th": (18.2e6, 1.0e6)}


@pytest.mark.parametrize("layer", list(TABLE_III))
def test_table_iii_absolute_cycles_on_port(layer):
    (ci, cm, co, s), hw = LAYERS[layer]
    spec = DSCBlockSpec(cin=ci, cmid=cm, cout=co, stride=s)
    v0_want, v3_want = TABLE_III[layer]
    v0 = tfusion.modeled_cycles(spec, hw, hw,
                                tfusion.Schedule.V0_LAYER_BY_LAYER)
    v3 = tfusion.modeled_cycles(spec, hw, hw, tfusion.Schedule.V3_INTRA_STAGE)
    assert v0 == pytest.approx(v0_want, rel=0.35)
    assert v3 == pytest.approx(v3_want, rel=0.35)
    tbl = tfusion.speedup_table(spec, hw, hw)
    assert tbl["v0"].cycles > tbl["v1"].cycles > tbl["v2"].cycles
    assert tbl["v3"].cycles < tbl["v2"].cycles * 1.03


# --- the CFU report tables built on these models -----------------------------


def test_cfu_report_tables_equal():
    """``cfu.report`` prices the paper's layers with the traffic and cycle
    models above plus the CFU timing model: its table lines must be the
    reference's, character for character."""
    from repro.cfu import report as jreport
    from repro.models import mobilenetv2 as jmnv2
    from repro_torch.cfu import report as treport
    jrows, trows = jreport.build_layer_reports(), treport.build_layer_reports()
    for fn in ("table_iii_lines", "table_v_lines", "table_vi_lines"):
        assert getattr(treport, fn)(trows) == getattr(jreport, fn)(jrows), fn
    assert (treport.schedule_comparison_md(treport.schedule_comparison())
            == jreport.schedule_comparison_md(jreport.schedule_comparison()))
    kw = dict(streams_list=(1, 2), batches=(1, 4))
    assert (treport.multistream_comparison_md(
        treport.multistream_comparison(**kw))
        == jreport.multistream_comparison_md(
            jreport.multistream_comparison(**kw)))
    assert (treport.modeled_network_sw_cycles(tmnv2.block_specs(), 80)
            == jreport.modeled_network_sw_cycles(jmnv2.block_specs(), 80))
