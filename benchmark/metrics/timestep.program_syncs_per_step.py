"""Host reads of the device per RK4 step, as the program counts them in its
record of the device pass (``benchmark.record``): every site that reads a
value back (the CG's exit tests, the outer passes' tests, each solve's
verdict, the step's finiteness guard, ``Problem.check_state``'s two reads
after each completed trajectory), over the record's steps."""

from benchmark.record import program_record


def read(ctx):
    rec = program_record(ctx)
    if rec is None:
        return None
    return sum(rec.syncs.values()) / rec.steps
