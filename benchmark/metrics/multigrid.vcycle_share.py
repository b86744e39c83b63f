"""Percent of the device pass's steps' stream time inside the p-multigrid
V-cycle (the span ``multigrid.vcycle``, inclusive: its levels' smoothers,
residuals, transfers and the coarse solve), from the program's record
(``benchmark.record``)."""

from benchmark.record import share


def read(ctx):
    return share(ctx, lambda rec: rec.totals("multigrid.vcycle").stream)
