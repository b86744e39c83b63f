"""Run one cell of the benchmark of ``lpfem_torch`` once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. Builds the cell's problem on the card, warms
up one step, measures trajectories of RK4 steps for ``--seconds`` (with
``--trace 1``: a bounded number of steps under torch.profiler), checks the
window's sampled answers against the plain reference, and prints one JSON
line last on standard output; the numbers compared, each with its limit,
are also the last lines of standard error. Exits with a code other than 0,
and prints no result, where there is no CUDA card or fewer cards than the
cell asks for, where the program cannot be imported, or where a module of
the JAX package (``jax``, ``jaxlib``, ``flax``, ``lpfem``) is loaded once
the window has closed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _plain(v):
    """``v`` with every non-finite float as a string: strict JSON."""
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # a library the port may pull in must not load the JAX stack
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")

    from benchmark.harness import forbidden_modules, load_cell, run_cell

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
            f"{cell.chips}")
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rec = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   log=log)
    found = forbidden_modules()
    if found:
        log(f"modules of the JAX stack are loaded: {found}")
        return 4
    for name, c in rec["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(_plain(rec), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    # the checkout's root, not this directory, heads the module path
    sys.path[0] = str(ROOT)
    sys.exit(main())
