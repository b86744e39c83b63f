"""The readings a cell's limits are set from: the program as the
configuration states it, and its control, on many seeds in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 ... \\
        [--control-seeds 1 2 3] [--out readings.json]

For each seed: the seeded initial state, one trajectory of the cell's K
steps through ``Problem.run``, every step of it against the plain
reference (``compare.check``: the early and the late steps' numbers). First the program as configured (the lower
readings: the largest gaps of sound runs), then the program with the
configuration's ``control`` switched on: its own path one precision below
the one the configuration states (the upper readings). One program is built
for each, at the cell's own size, so set-up is paid twice, not per seed.
Needs a CUDA card (``--device cpu`` runs the same at whatever size the
cell's files give, for the tests).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)


GAPS = ("y_gap.early", "y_gap.late", "phi_gap.early", "phi_gap.late")


def readings(cell, seeds, device, control: bool = False, log=print) -> list:
    """[{seed, <each of GAPS>, unconverged, ...}] of one trajectory a
    seed."""
    import torch

    from benchmark import compare
    from benchmark.harness import (Window, build_program, initial_state,
                                   program_params, program_layout)

    params, guar = program_params(cell)
    if control:
        ctl = cell.config["control"]
        params.update(ctl["params"])
        guar = {k: v for k, v in guar.items() if k not in ctl["departs"]}
    prob = build_program(cell, device, params, guar)
    layout = program_layout(prob, 0)
    K = int(cell.traffic["steps_per_trajectory"])
    E = cell.early_steps
    runs = []
    for seed in seeds:
        y0, phi0, _ = initial_state(prob, cell, seed)
        win = Window(prob, y0, phi0, K, seed, E, E, K - E,
                     max_steps=K).run()
        detail = []
        checks, _ = compare.check(cell, params, layout, win.samples,
                                  {"failed": win.failed}, device, log=log,
                                  detail=detail)
        runs.append({"seed": seed, "control": control,
                     **{g: checks[g]["value"] for g in GAPS},
                     "unconverged": win.failed, "solves": win.solves,
                     "inner_iters": win.inner_iters,
                     "per_step": sorted(detail, key=lambda d: d["step"])})
        log(json.dumps(runs[-1]))
    del prob
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import load_cell

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    runs = readings(cell, args.seeds, device)
    if args.control_seeds:
        runs += readings(cell, args.control_seeds, device, control=True)
    out = {"workload": args.workload, "runs": runs}
    for kind in (False, True):
        sel = [r for r in runs if r["control"] is kind]
        if sel:
            key = "control" if kind else "program"
            out[key] = {g: (max if not kind else min)(r[g] for r in sel)
                        for g in GAPS}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "runs"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
