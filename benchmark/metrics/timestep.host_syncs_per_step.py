"""Host reads of the device per RK4 step: the solver's exit tests
(``SolveInfo.syncs``, summed over the step's solves) and the time loop's
finiteness guard (one a step)."""


def read(ctx):
    if ctx["steps"] == 0:
        return None
    return (ctx["solver_syncs"] + ctx["guard_syncs"]) / ctx["steps"]
