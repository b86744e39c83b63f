"""Dofs times Laplace solves completed in the window, over the window's
seconds on the host clock (the window ends at the first step boundary after
its length, so every solve counted is complete)."""


def read(ctx):
    if ctx["elapsed_s"] <= 0 or ctx["solves"] == 0:
        return None
    return ctx["n_dofs"] * ctx["solves"] / ctx["elapsed_s"]
