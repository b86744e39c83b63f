"""The benchmark's cells cut to a size a CPU test can hold: the ss tank at
refs 0 and order 2 on 8 x 2 x 2 hexes, the diffraction study on its
``--quick`` mesh (order 2, 12 x 6 polar cells). Limits are set between the
program's and the control's readings at these sizes."""

import json
from pathlib import Path

from benchmark.harness import load_cell

ROOT = Path(__file__).resolve().parents[2]
LIMITS = {"y_gap.early": 1e-8, "y_gap.late": 1e-8,
          "phi_gap.early": 1e-8, "phi_gap.late": 1e-8}

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def tiny_cell(name: str):
    cell = load_cell(name)
    p = cell.config["params"]
    if cell.config["program"] == "preset":
        p.update(order=2, nx=8, nz=2)
        cell.traffic["scale"] = {"ref_levels": 0}
    else:
        p.update(order=2, n_theta=12, n_r=6, dr_max=0.0, nsteps=60,
                 periods=3.0)
        cell.config["guarantees"]["steps_per_period"] = 20.0
    cell.config["guarantees"]["order"] = 2
    cell.limits = dict(LIMITS)
    return cell
