"""B1 (``kernels.sep_apply``) at order 8 against its roofline: each p = 8
call's least time from its lattice and dtype (``costs.roofline.b1_cost``)
over the device time of p = 8's own instantiation (``costs.order_share``);
the cell's applies at the lower orders of its p-multigrid are left out."""

from benchmark.costs.order_share import b1_order_percent


def read(ctx):
    return b1_order_percent(ctx, 8)
