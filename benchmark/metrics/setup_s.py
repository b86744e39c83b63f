"""Seconds from the start of the process to the end of the warm-up step:
imports, the kernels' build where the checkout has none, the mesh, the
numbering, the host tables, the smoothers' lambda_max and the first step."""


def read(ctx):
    return ctx["setup_s"]
