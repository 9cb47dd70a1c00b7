"""The port's spans (``runtime.trace``) on the CPU: off without a profile,
on the profiler's clock with one, and where the MobileNet and the LM put
them. Recording must not change a number."""

import collections
import gc
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import registry
from repro_torch.models import lm
from repro_torch.models import mobilenetv2 as mnv2
from repro_torch.runtime import trace


@pytest.fixture(autouse=True)
def empty_store():
    trace.clear()
    yield
    trace.clear()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def profiler_on():
    return torch.autograd.profiler._is_profiler_enabled


def span_events(prof):
    """The profile's host events of the port's spans, by entry order."""
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.name().startswith(trace.PREFIX)]
    return sorted(evs, key=lambda e: e.start_ns())


def test_no_profile_records_nothing_and_never_enters_the_profiler(
        monkeypatch):
    entered = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: entered.append(name))
    assert not profiler_on()
    with trace.span("outer") as rec:
        assert rec is None
        with trace.span("inner"):
            pass
    assert trace.span("a") is trace.span("b")     # one shared null context
    assert entered == [] and trace.records() == []


def test_spans_lie_in_the_profile_with_their_names_and_nesting():
    with cpu_profile() as prof:
        assert profiler_on()
        with trace.span("outer"):
            with trace.span("inner"):
                torch.ones(8).add_(1)
    assert not profiler_on()
    outer, inner = span_events(prof)
    assert (outer.name(), inner.name()) == ("repro_torch::outer",
                                            "repro_torch::inner")
    assert outer.start_ns() <= inner.start_ns()
    assert inner.end_ns() <= outer.end_ns()
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::add_"]
    assert ops and inner.start_ns() <= ops[0].start_ns()
    assert ops[0].end_ns() <= inner.end_ns()


def test_records_contain_their_events_on_the_profilers_clock():
    with cpu_profile() as prof:
        for i in range(50):
            with trace.span("step") as step:
                step.args["i"] = i
                with trace.span("part"):
                    torch.ones(16).mul_(2)
    recs, evs = trace.records(), span_events(prof)
    assert [r.name for r in recs] == ["step", "part"] * 50
    assert [trace.PREFIX + r.name for r in recs] == [e.name() for e in evs]
    for r, e in zip(recs, evs):
        assert r.start_ns <= e.start_ns() and e.end_ns() <= r.end_ns
        assert e.start_ns() - r.start_ns < 1_000_000
        assert r.end_ns - e.end_ns() < 1_000_000


def test_parents_args_and_the_returned_span():
    with cpu_profile():
        with trace.span("a") as a:
            a.args.update(x=1, late="yes")
            with trace.span("b") as b:
                with trace.span("c") as c:
                    pass
            with trace.span("d") as d:
                d.args["grid"] = (3, 1)
        with trace.span("e"):
            pass
    recs = {r.name: r for r in trace.records()}
    assert [r.name for r in trace.records()] == list("abcde")
    assert [recs[n].index for n in "abc"] == [a.index, b.index, c.index]
    assert recs["a"].parent is None and recs["e"].parent is None
    assert recs["b"].parent == a.index and recs["d"].parent == a.index
    assert recs["c"].parent == b.index
    assert recs["a"].args == {"x": 1, "late": "yes"}
    assert recs["d"].args == {"grid": (3, 1)} and recs["e"].args == {}
    assert [r.name for r in trace.records("d")] == ["d"]
    trace.clear()
    assert trace.records() == []


def test_spans_leave_nothing_the_garbage_collector_counts():
    """Kept objects it counts made a profiled window pause for
    collections; a record is kept as numbers and strings."""
    def spans(n):
        for i in range(n):
            with trace.span("s") as s:
                s.args.update(i=i, grid=(i, 2))
                with trace.span("t"):
                    pass

    with cpu_profile():
        spans(1)                    # first use: the thread's span stack
        trace.clear()
        gc.disable()
        try:
            before = gc.get_count()[0]
            spans(200)
            grew = gc.get_count()[0] - before
        finally:
            gc.enable()
    assert grew == 0
    assert len(trace.records("s")) == 200
    assert trace.records("s")[5].args == {"i": 5, "grid": (5, 2)}


def test_a_threads_spans_have_their_own_parents():
    seen = {}

    def other():
        with trace.span("other") as rec:
            seen["other"] = rec

    with cpu_profile():
        with trace.span("main"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    assert seen["other"].parent is None


def test_a_span_closes_when_its_body_raises():
    with cpu_profile():
        with pytest.raises(ValueError):
            with trace.span("fails"):
                raise ValueError("boom")
        with trace.span("next"):
            pass
    fails, nxt = trace.records()
    assert fails.name == "fails" and fails.end_ns >= fails.start_ns
    assert nxt.parent is None


def test_the_store_keeps_the_newest_records(monkeypatch):
    fields = trace._store.maxlen // trace.CAP
    assert trace.CAP == 1 << 20 and trace._store.maxlen == fields * trace.CAP
    monkeypatch.setattr(trace, "_store",
                        collections.deque(maxlen=fields * 5))
    with cpu_profile():
        for i in range(12):
            with trace.span("s") as s:
                s.args["i"] = i
    assert [r.args["i"] for r in trace.records()] == list(range(7, 12))


@pytest.fixture(scope="module")
def net():
    return mnv2.init_and_quantize(3, img_hw=32, device="cpu")


@pytest.fixture(scope="module")
def imgs():
    return np.random.default_rng(5).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)


def test_forward_batch_spans(net, imgs):
    with cpu_profile():
        mnv2.forward_batch(imgs, net, use_kernel=True, return_quantized=True)
    recs = trace.records()
    counts = collections.Counter(r.name for r in recs)
    assert counts == {"mbv2.forward_batch": 1, "mbv2.input": 1,
                      "mbv2.stem": 1, "mbv2.block": 7, "dsc_block": 7,
                      "mbv2.head": 1}
    (top,) = trace.records("mbv2.forward_batch")
    assert top.args == {"batch": 2} and top.parent is None
    blocks = trace.records("mbv2.block")
    assert [b.args["index"] for b in blocks] == list(range(7))
    assert [b.args["stride"] for b in blocks] == [
        s for *_, s in mnv2.PAPER_BLOCKS]
    assert all(r.parent == top.index for r in recs
               if r.name.startswith("mbv2.") and r.index != top.index)
    for block, dsc in zip(blocks, trace.records("dsc_block")):
        assert dsc.parent == block.index
        assert dsc.args["stride"] == block.args["stride"]
        assert set(dsc.args) == {"B", "H", "W", "C", "M", "N", "stride"}
    assert trace.records("dsc_block")[0].args["B"] == 2


def test_int8_logits_equal_with_and_without_a_profile(net, imgs):
    off = mnv2.forward_batch(imgs, net, use_kernel=True,
                             return_quantized=True)
    with cpu_profile():
        on = mnv2.forward_batch(imgs, net, use_kernel=True,
                                return_quantized=True)
    assert torch.equal(off, on) and len(trace.records()) == 18


def smoke_lm(name):
    cfg = registry.get_smoke(name)
    return cfg, lm.init_params(cfg, 0, device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("name", ["glm4-9b", "recurrentgemma-9b"])
def test_lm_prefill_and_decode_spans(name):
    cfg, params = smoke_lm(name)
    kinds = list(cfg.pattern) * cfg.n_units + list(cfg.tail_kinds)
    attn = [i for i, k in enumerate(kinds) if k in lm.ATTN_KINDS]
    assert attn
    tokens = torch.randint(0, cfg.vocab, (2, 6),
                           generator=torch.Generator().manual_seed(0))
    with cpu_profile():
        logits, cache = lm.prefill(params, cfg, tokens, max_len=8)
        lm.decode_step(params, cfg, cache, logits.argmax(-1), 6)
    (pre,) = trace.records("lm.prefill")
    (step,) = trace.records("lm.decode_step")
    assert pre.args == {"B": 2, "T": 6} and step.args == {"B": 2, "pos": 6}
    for parent in (pre, step):
        kids = [r for r in trace.records() if r.parent == parent.index]
        att = [r for r in kids if r.name == "lm.attention"]
        assert [r.args["layer"] for r in att] == attn
        assert [r.args["layer"] for r in kids if r.name == "lm.ffn"] == \
            list(range(len(kinds)))
        assert [r.name for r in kids][-1] == "lm.head"


def test_lm_logits_equal_with_and_without_a_profile():
    cfg, params = smoke_lm("glm4-9b")
    tokens = torch.randint(0, cfg.vocab, (2, 6),
                           generator=torch.Generator().manual_seed(1))

    def run():
        logits, cache = lm.prefill(params, cfg, tokens, max_len=8)
        step, _ = lm.decode_step(params, cfg, cache, logits.argmax(-1), 6)
        return logits, step

    off = run()
    with cpu_profile():
        on = run()
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    assert trace.records("lm.decode_step")
