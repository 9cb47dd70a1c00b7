"""Host milliseconds of one decode step, the median over the traced run's
device-only pass: the port's own ``lm.decode_step`` spans, one for each
step of that pass (see ``step_host_ms.py``). A port without spans gives
nothing."""

from bench.metrics.step_host_ms import device_pass, host_ms

STEP = "repro_torch.models.lm:decode_step"
SPANS = (STEP,)


def read(v):
    steps = device_pass(v, STEP, "lm.decode_step", "lm.decode_step")
    return host_ms(steps) if steps else None
