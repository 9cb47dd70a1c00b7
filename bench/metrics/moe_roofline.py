"""The routed experts' share of their roofline (%): the least time of the
window's ``moe.experts`` calls (the dropless entry: dispatch, grouped
products, combine) over the device time of their kernels. Each call's
work and bytes from ``cost_afmoe.experts_call``: the bytes are the fewest
any routing reads, so the share cannot pass 100%. A port without the
entry gives nothing."""

from bench import cost_afmoe
from bench.readers import roofline

EXPERTS = "repro_torch.models.moe:experts"
SPANS = (EXPERTS,)


def read(v):
    return roofline(v, EXPERTS, cost_afmoe.experts_call, "bf16_flops")
