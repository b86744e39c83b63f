"""Inner CG iterations per Laplace solve (``SolveInfo.iters``: all of a
mixed solve's inner passes), over the traced window's solves."""


def read(ctx):
    if ctx["solves"] == 0:
        return None
    return ctx["inner_iters"] / ctx["solves"]
