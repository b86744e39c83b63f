"""Percent of the device pass's steps' host time in the element path's
E-vector gather and fold (the details ``operators.gather`` and
``operators.fold``: every apply's and the p-multigrid's element
transfers'), from the program's record (``benchmark.record``). Host
seconds, since the details take no stream markers in a benchmark run (two
CUDA events on each of ~13.5k calls a step would cost more than the
gathers and folds); in this host-bound cell the host's time is what they
cost the wall."""

from benchmark.record import share


def read(ctx):
    return share(ctx, lambda rec: rec.totals("operators.gather").host
                 + rec.totals("operators.fold").host, clock="host")
