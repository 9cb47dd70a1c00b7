"""The fused FFN kernel's share of its roofline (%): the least time of the
window's ``ops.ffn`` calls over the device time of their kernels."""

from bench.readers import FFN
from bench.readers import ffn_roofline as read  # noqa: F401

SPANS = (FFN,)
