"""B3b (``kernels.pa_apply.pa_apply_element``, the curved-element apply)
against its roofline: each call's least time from its element count, order,
Gauss points and dtype (``costs.roofline.b3b_cost``), over B3b's device
time in the trace."""

from benchmark.costs.roofline import b3b_cost, least_seconds
from benchmark.costs.share import roofline_percent

# the kernel's names in a profile (csrc/pa_apply.cu)
PATTERNS = ("pa_element_kernel",)
DTYPE = {4: "float32", 8: "float64"}


def _least(key):
    p, ne, q, itemsize = key
    return least_seconds(*b3b_cost(ne, p, q, itemsize), DTYPE[itemsize])


def read(ctx):
    return roofline_percent(ctx, "pa_apply_element", PATTERNS, _least)
