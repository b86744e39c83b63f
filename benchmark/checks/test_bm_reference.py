"""The plain reference against the program run far past its configured
tolerance (float64, r.z <= rz0 * 1e-28): one RK4 step from the same state
agrees to round-off, so the reference computes the discretisation the
program does, and a gap it reads at the configured tolerance is the
program's."""


import numpy as np
import pytest
import torch

from benchmark import reference
from benchmark.checks.tiny import CELLS, tiny_cell
from benchmark.harness import (build_program, initial_state, program_layout,
                               program_params)

TIGHT = {"preset": {"dtype": "float64", "cg_rtol_sq": 1e-28,
                    "cg_max_iter": 2000},
         "diffraction": {"dtype": "float64", "rtol_sq": 1e-28}}


@pytest.mark.parametrize("name", CELLS)
def test_reference_step_matches_the_tight_program(name):
    cell = tiny_cell(name)
    params, _ = program_params(cell)
    params.update(TIGHT[cell.config["program"]])
    prob = build_program(cell, torch.device("cpu"), params, {})
    layout = program_layout(prob, 0)
    ref = reference.make(cell.config, params, "cpu")
    assert ref.n_dofs == layout["n_dofs"]
    s_idx, s_dist = ref.surface_index(layout["surf_xy"])
    v_idx, v_dist = ref.volume_index(layout["vol_xyz"])
    assert max(s_dist, v_dist) < 1e-12
    assert len(np.unique(v_idx)) == ref.n_dofs
    assert abs(ref.dt - prob.dt) <= 1e-15 * prob.dt

    y0, phi0, _ = initial_state(prob, cell, 5)
    ns = ref.n_surf
    s_t = torch.as_tensor(s_idx)
    y, phi, t = y0, phi0, 0.0
    for _ in range(2):
        t1, y1, phi1 = prob.run(n_steps=1, t0=t, state=(y, phi))
        y_ref = torch.empty_like(y)
        y_ref[s_t], y_ref[ns + s_t] = y[:ns], y[ns:]
        yr, phir = ref.step(t, y_ref)
        yr = torch.cat([yr[s_t], yr[ns + s_t]])
        assert float((y1 - yr).abs().max() / yr.abs().max()) < 1e-12
        phir = phir[torch.as_tensor(v_idx)]
        assert float((phi1 - phir).abs().max() / phir.abs().max()) < 1e-12
        y, phi, t = y1, phi1, t1
