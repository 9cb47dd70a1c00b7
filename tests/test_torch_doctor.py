"""The port's perf doctor and roofline points against the JAX package's.

``cfu/doctor.py`` and ``roofline/points.py`` are host code (Python floats)
carried over expression for expression, so their products must be equal
with ``==``: the attributions and what-ifs as plain dicts, the lines as
strings, the ``launch.doctor`` payload as JSON. The conservation (the
categories' left-to-right sum equals the model total bit for bit) is
checked on the port's own numbers at the reference points.
"""

import dataclasses
import json
import math

import numpy as np
import pytest

from repro.cfu import compiler as jcompiler
from repro.cfu import doctor as jdoctor
from repro.cfu import timing as jtiming
from repro.cfu.ir import SCHEDULES as JSCHEDULES
from repro.cfu.report import PAPER_LAYERS as JLAYERS
from repro.launch import doctor as jdoctor_cli
from repro.models import mobilenetv2 as jmnv2
from repro.roofline import points as jpoints
from repro_torch.cfu import compiler as tcompiler
from repro_torch.cfu import doctor as tdoctor
from repro_torch.cfu import timing as ttiming
from repro_torch.cfu.ir import SCHEDULES
from repro_torch.cfu.report import PAPER_LAYERS as TLAYERS
from repro_torch.launch import doctor as tdoctor_cli
from repro_torch.models import mobilenetv2 as tmnv2
from repro_torch.roofline import points as tpoints

SCHEDULE_NAMES = sorted(SCHEDULES)
JSPEC3, HW3 = {n: (s, hw) for n, s, hw in JLAYERS}["3rd"]
TSPEC3 = {n: s for n, s, _ in TLAYERS}["3rd"]
WG_PE = (9, 2, 56)          # the depthwise-starved winograd gate split
VWW_HW = 24                 # the serving gate geometry
BASE_PE = (4, 4, 21)


def plain(obj):
    """Dataclasses as dicts, tuples as lists: one shape for ``==`` across
    the two packages' classes."""
    if dataclasses.is_dataclass(obj):
        return plain(dataclasses.asdict(obj))
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    return obj


def _block3(sched, pe=None):
    """(reference program, port program) of block 3 at 40x40."""
    kw = {} if pe is None else {"pe": jtiming.PEConfig(*pe)}
    jp = jcompiler.compile_block(JSPEC3, HW3, HW3, sched, name="3rd", **kw)
    kw = {} if pe is None else {"pe": ttiming.PEConfig(*pe)}
    tp = tcompiler.compile_block(TSPEC3, HW3, HW3, sched, name="3rd", **kw)
    return jp, tp


@pytest.fixture(scope="module")
def vww2core():
    """The 2-core auto-hetero VWW pipeline at the serving gate geometry."""
    jp = jcompiler.compile_vww_network(
        jmnv2.block_specs(), VWW_HW, "fused", pe=jtiming.PEConfig(*BASE_PE),
        streams=2, pe_per_core="auto-hetero")
    tp = tcompiler.compile_vww_network(
        tmnv2.block_specs(), VWW_HW, "fused", pe=ttiming.PEConfig(*BASE_PE),
        streams=2, pe_per_core="auto-hetero")
    return jp, tp


def _lr_sum(values):
    s = 0.0
    for v in values:
        s += v
    return s


# --- attribution -----------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("sched", SCHEDULE_NAMES)
def test_attribute_equal_and_conserved(sched, batch):
    jp, tp = _block3(sched)
    ja = jdoctor.attribute(jp, "v3", batch=batch)
    ta = tdoctor.attribute(tp, "v3", batch=batch)
    assert plain(ta) == plain(ja)
    assert ta.top == ja.top
    assert tuple(ta.categories) == tdoctor.CATEGORIES
    assert _lr_sum(ta.categories.values()) == ta.total_cycles
    for per_phase in (False, True):
        assert (tdoctor.attribution_lines(ta, per_phase=per_phase)
                == jdoctor.attribution_lines(ja, per_phase=per_phase))


@pytest.mark.parametrize("pipeline", ["v1", "v2", "v3"])
def test_attribute_multistream_equal_and_conserved(vww2core, pipeline):
    jp, tp = vww2core
    ja = jdoctor.attribute_multistream(jp, pipeline, batch=4)
    ta = tdoctor.attribute_multistream(tp, pipeline, batch=4)
    assert plain(ta) == plain(ja)
    assert ta.to_json() == ja.to_json()
    assert _lr_sum(ta.categories.values()) == ta.interval_cycles
    ta.check()
    assert tdoctor.attribution_lines(ta) == jdoctor.attribution_lines(ja)


def test_winograd_gate_point_equal():
    """Block 3 under fused-rowtile at (9, 2, 56): dw-bound, and the top
    what-if is the fused-winograd swap, in both packages."""
    jp, tp = _block3("fused-rowtile", WG_PE)
    ja, ta = jdoctor.attribute(jp, "v3"), tdoctor.attribute(tp, "v3")
    assert plain(ta) == plain(ja) and ta.top == "dw_mac"
    jrows = jdoctor.rank(
        jdoctor.what_if(jp, "v3") + jdoctor.what_if_schedules(
            JSPEC3, HW3, HW3, JSCHEDULES["fused-rowtile"][0],
            pipeline="v3", pe=jtiming.PEConfig(*WG_PE)))
    trows = tdoctor.rank(
        tdoctor.what_if(tp, "v3") + tdoctor.what_if_schedules(
            TSPEC3, HW3, HW3, SCHEDULES["fused-rowtile"][0],
            pipeline="v3", pe=ttiming.PEConfig(*WG_PE)))
    assert plain(trows) == plain(jrows)
    assert [r.to_json() for r in trows] == [r.to_json() for r in jrows]
    assert trows[0].name == "schedule=fused-winograd"
    assert tdoctor.what_if_lines(trows) == jdoctor.what_if_lines(jrows)


# --- what-ifs --------------------------------------------------------------


@pytest.mark.parametrize("knobs", [
    {}, {"sram_port_bytes": 4, "dram_cycles_per_byte": 20.0},
    {"handoff_sync_cycles": 16.0}])
@pytest.mark.parametrize("sched", ["fused", "layer-sram", "fused-rowtile"])
def test_what_if_equal_and_exact(sched, knobs):
    jp, tp = _block3(sched)
    jrows = jdoctor.what_if(jp, "v3", batch=2, **knobs)
    trows = tdoctor.what_if(tp, "v3", batch=2, **knobs)
    assert plain(trows) == plain(jrows)
    for r in trows:     # the quoted number is the model's, re-run fresh
        p = dict(r.params)
        pipeline, b = p.pop("pipeline"), p.pop("batch")
        assert (ttiming.BatchCostModel(tp, pipeline, **p).report(b)
                .total_cycles == r.new_cycles), r.name


def test_what_if_multistream_equal(vww2core):
    jp, tp = vww2core
    jrows = jdoctor.what_if_multistream(jp, "v3", batch=4)
    trows = tdoctor.what_if_multistream(tp, "v3", batch=4)
    assert plain(trows) == plain(jrows)
    assert tdoctor.what_if_lines(trows) == jdoctor.what_if_lines(jrows)


# --- explain_auto, roofline points -----------------------------------------


@pytest.mark.parametrize("pe", [None, WG_PE])
def test_explain_auto_equal(pe):
    from repro.cfu.ir import build_chain_ir as jbuild
    from repro_torch.cfu.ir import build_chain_ir as tbuild
    jpe = None if pe is None else jtiming.PEConfig(*pe)
    tpe = None if pe is None else ttiming.PEConfig(*pe)
    je = jdoctor.explain_auto(jbuild(jmnv2.block_specs(), 40, 40),
                              pipeline="v3", pe=jpe)
    te = tdoctor.explain_auto(tbuild(tmnv2.block_specs(), 40, 40),
                              pipeline="v3", pe=tpe)
    assert plain(te) == plain(je)
    assert te.lines() == je.lines()
    assert [te.margin(b) for b in te.table] == [je.margin(b)
                                                for b in je.table]


def test_roofline_points_equal(vww2core):
    jp, tp = vww2core
    jpts = [jdoctor.roofline_point(r, f"core{i}") for i, r in enumerate(
        jtiming.analyze_multistream(jp, "v3", batch=4).per_stream)]
    tpts = [tdoctor.roofline_point(r, f"core{i}") for i, r in enumerate(
        ttiming.analyze_multistream(tp, "v3", batch=4).per_stream)]
    for sched in SCHEDULE_NAMES:
        jb, tb = _block3(sched)
        jpts.append(jdoctor.roofline_point(jtiming.analyze(jb, "v3"), sched,
                                           sram_port_bytes=2))
        tpts.append(tdoctor.roofline_point(ttiming.analyze(tb, "v3"), sched,
                                           sram_port_bytes=2))
    assert plain(tpts) == plain(jpts)
    assert tpoints.points_json(tpts) == jpoints.points_json(jpts)
    assert tpoints.points_table(tpts) == jpoints.points_table(jpts)
    assert (tpoints.points_table(tpts, ops_unit="FLOPs")
            == jpoints.points_table(jpts, ops_unit="FLOPs"))
    assert all(p.bound in p.ceilings and p.utilization > 0.0 for p in tpts)


def test_points_table_edges_equal():
    """Unbounded, NaN-ceiling and zero-cycle points render alike."""
    def pts(mod):
        return [mod.RooflinePoint("none", 10.0, 0.0, {}),
                mod.RooflinePoint("nan", 4.0, 2.0, {"a": math.nan,
                                                    "b": 3.0}),
                mod.RooflinePoint("inf", 4.0, 2.0, {"a": math.inf},
                                  {"a": 0.0})]
    assert tpoints.points_table(pts(tpoints)) == jpoints.points_table(
        pts(jpoints))
    assert json.dumps(tpoints.points_json(pts(tpoints))) == json.dumps(
        jpoints.points_json(pts(jpoints)))


# --- the repair itself -----------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_conserve_repairs_like_the_reference(seed):
    """Totals a few ULPs off the re-associated sum: the port's repair
    lands on the same bits as the reference's, slot for slot."""
    rng = np.random.default_rng(seed)
    vals = [float(v) for v in rng.uniform(0.0, 1e6, len(tdoctor.CATEGORIES))]
    vals[int(rng.integers(len(vals)))] = 0.0
    cats = dict(zip(tdoctor.CATEGORIES, vals))
    total = math.fsum(vals)
    for _ in range(int(rng.integers(1, 4))):
        total = math.nextafter(total, math.inf)
    jc, tc = dict(cats), dict(cats)
    jdoctor._conserve(jc, total, "ref")
    tdoctor._conserve(tc, total, "port")
    assert tc == jc and tdoctor._csum(tc) == total
    with pytest.raises(tdoctor.ConservationError):
        tdoctor._conserve(dict(cats), total * 1.01, "off by 1%")


# --- the CLI ---------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--block", "3rd", "--schedule", "fused-rowtile", "--pe", "9,2,56"],
    ["--block", "3rd", "--per-phase", "--batch", "2"],
    ["--net", "mobilenetv2", "--schedule", "auto", "--hw", "20"],
    ["--network", "vww", "--img-hw", "24", "--streams", "2",
     "--pe-per-core", "auto-hetero", "--batch", "4"],
], ids=["winograd-gate", "per-phase", "auto", "vww-2core"])
def test_doctor_cli_payload_equal(argv, tmp_path, capsys):
    jpath, tpath = tmp_path / "ref.json", tmp_path / "port.json"
    jdoctor_cli.main(argv + ["--json", str(jpath)])
    jout = capsys.readouterr().out.splitlines()
    tdoctor_cli.main(argv + ["--json", str(tpath)])
    tout = capsys.readouterr().out.splitlines()
    assert tout[:-1] == jout[:-1]          # the last line names the file
    assert json.loads(tpath.read_text()) == json.loads(jpath.read_text())
