"""B1 (``kernels.sep_apply``, the banded Kronecker apply) against its
roofline: each call's least time from its lattice, order and dtype
(``costs.roofline.b1_cost``), over B1's device time in the trace."""

from benchmark.costs.roofline import b1_cost, least_seconds
from benchmark.costs.share import roofline_percent

# the kernel's names in a profile (csrc/sep_apply.cu)
PATTERNS = ("sep_tile_kernel",)
DTYPE = {4: "float32", 8: "float64"}


def _least(key):
    p, dims, itemsize = key
    return least_seconds(*b1_cost(dims, p, itemsize), DTYPE[itemsize])


def read(ctx):
    return roofline_percent(ctx, "sep_apply", PATTERNS, _least)
