"""Percent of the device pass's steps' stream time outside the Laplace
solves (the span ``timestep.step`` less its ``surface.solve`` spans): the
RK4 updates, each stage's surface trace and relaxation forcing, and the
finiteness guard. From the program's record (``benchmark.record``)."""

from benchmark.record import share


def read(ctx):
    return share(ctx, lambda rec: rec.totals("timestep.step").stream
                 - rec.totals("surface.solve").stream)
