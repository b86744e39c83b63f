"""Percent of the device pass's steps' stream time in the CG's own work
(the self time of the span ``solvers.cg_iteration``): the vector updates,
dots, zero-denominator guards, the exit test's read and the Python between
them, without the operator apply (``solvers.apply``) and the
preconditioner (``multigrid.vcycle``). From the program's record
(``benchmark.record``)."""

from benchmark.record import share


def read(ctx):
    return share(ctx,
                 lambda rec: rec.totals("solvers.cg_iteration").stream_self)
