"""The fused DSC kernel's share of its roofline (%): the least time of the
window's ``ops.dsc_block`` calls over the device time of their kernels."""

from bench.readers import DSC
from bench.readers import dsc_roofline as read  # noqa: F401

SPANS = (DSC,)
