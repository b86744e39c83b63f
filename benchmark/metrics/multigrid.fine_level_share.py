"""Percent of the device pass's steps' stream time in the p-multigrid's top
level alone: the self time of the span ``multigrid.vcycle``, which leaves
out its descent to the levels below (the span ``multigrid.lower``), so it
holds the top level's smoothers, residual, restriction and prolongation.
From the program's record (``benchmark.record``); ``None`` where the
program records no ``multigrid.lower`` (its V-cycle's self time would then
hold the lower levels too)."""

from benchmark.record import program_record, share


def read(ctx):
    rec = program_record(ctx)
    if rec is None or rec.totals("multigrid.lower").calls == 0:
        return None
    return share(ctx,
                 lambda rec: rec.totals("multigrid.vcycle").stream_self)
