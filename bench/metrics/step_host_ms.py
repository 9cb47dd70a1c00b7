"""Host milliseconds of one MobileNet step, the median over the traced
run's device-only pass: the port's own ``mbv2.forward_batch`` spans
(``repro_torch.runtime.trace``), one for each request of that pass. That
pass records the device's operations and the port's spans but no host op,
so its steps run near an untraced run's pace; the host pass, which records
every host op, slows them. A port without spans gives nothing.

``device_pass`` finds a pass's records for every reader of the port's
spans: they record in each profiled pass of a traced run, the traced
warm-up, the device-only pass and the host pass, in that order.
"""

from statistics import median

from bench.readers import DSC

SPANS = (DSC,)


def device_pass(v, entry: str, first: str, step: str):
    """The port's ``step`` records of the device-only pass, one for each
    step that its record counts (``v.rec.work``), or None. The host pass
    begins with the first of the last ``n`` ``first`` records, ``n`` the
    calls of ``entry`` that the harness counted in it; the device-only
    pass's steps are the last that ended before that."""
    n = len((v.calls or {}).get(entry, ()))
    want = len(v.rec.work) if v.rec is not None else 0
    if not n or not want:
        return None
    try:
        from repro_torch.runtime import trace
    except ImportError:                  # a port without spans
        return None
    marks = trace.records(first)
    if len(marks) < n:
        return None
    begun = marks[-n].start_ns
    steps = [r for r in trace.records(step) if r.end_ns <= begun]
    return steps[-want:] if len(steps) >= want else None


def host_ms(records) -> float:
    return median(r.end_ns - r.start_ns for r in records) * 1e-6


def read(v):
    steps = device_pass(v, DSC, "dsc_block", "mbv2.forward_batch")
    return host_ms(steps) if steps else None
