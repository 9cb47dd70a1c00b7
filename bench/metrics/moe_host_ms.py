"""Host milliseconds of one MoE layer, the median over the traced run's
device-only pass: the port's own ``moe.layer`` spans inside that pass's
``lm.prefill`` spans (see ``step_host_ms.py``). A synchronisation inside
the layer, where the host waits on the device, shows here. A port without
spans gives nothing."""

from statistics import median

from bench.metrics.step_host_ms import device_pass
from bench.metrics.moe_roofline import EXPERTS

SPANS = (EXPERTS,)


def read(v):
    steps = device_pass(v, EXPERTS, "moe.dispatch", "lm.prefill")
    if not steps:
        return None
    from repro_torch.runtime import trace
    t0, t1 = steps[0].start_ns, steps[-1].end_ns
    layers = [r.end_ns - r.start_ns for r in trace.records("moe.layer")
              if t0 <= r.start_ns and r.end_ns <= t1]
    return median(layers) * 1e-6 if layers else None
