"""Host microseconds of one ``ops.dsc_block`` call, dispatch, checks, plan
and launch, the median over the traced run's device-only pass: the port's
own ``dsc_block`` spans inside that pass's ``mbv2.forward_batch`` spans
(see ``step_host_ms.py``). A port without spans gives nothing."""

from statistics import median

from bench.metrics.step_host_ms import device_pass
from bench.readers import DSC

SPANS = (DSC,)


def read(v):
    steps = device_pass(v, DSC, "dsc_block", "mbv2.forward_batch")
    if not steps:
        return None
    from repro_torch.runtime import trace
    t0, t1 = steps[0].start_ns, steps[-1].end_ns
    calls = [r.end_ns - r.start_ns for r in trace.records("dsc_block")
             if t0 <= r.start_ns and r.end_ns <= t1]
    return median(calls) * 1e-3 if calls else None
