"""Relaxation zones, the wave by wavelength / period, and the eta error
metrics of lpfem_torch.Problem against lpfem on the CPU.

- The flagship finite tank ``pf_linear_par_partial`` (relaxation zones,
  lambda = 1 with kh pinned to 1, Jacobi CG to r.z <= rz0*1e-24) cut from
  36 to 12 elements in x: 3 RK4 steps, state to 1e-12 absolute (values
  O(1e-2); ``tests/test_mixed.py:124``), equal iteration counts in float64.
- ``Problem.eta_error_inf`` at its default (quadrature-point max, MFEM's
  ``ComputeMaxError``) and nodal, against lpfem's, to 1e-12 on a small
  ``scaling_base`` tank.
- The wave by period (``pf_linear_serial``) and by wavelength without the
  kh pin (``pf_linear_par``): the same Airy wave as lpfem's ``build_wave``.
"""

import numpy as np
import pytest
import torch

from lpfem.configs import preset as lp_preset
from lpfem.problem import Problem as LProblem
from lpfem.problem import build_mesh, build_wave

import lpfem_torch
from lpfem_torch import convert
from lpfem_torch.problem import Problem
from lpfem_torch.space import LatticeSpace

FLAGSHIP = dict(nx=12)
N_STEPS = 3


def test_flagship_finite_tank_matches_lpfem():
    lp = LProblem(lp_preset("pf_linear_par_partial", **FLAGSHIP))
    (t_l, y_l, phi_l), _ = lp.run(n_steps=N_STEPS)
    prob = Problem(lpfem_torch.preset("pf_linear_par_partial", **FLAGSHIP),
                   device="cpu")
    assert prob.relax is not None
    s2v = np.asarray(lp.surf.surf_to_vol)
    perm = convert.surface_permutation(s2v, prob.space.dof_dims)
    for name in ("cgen", "cabs", "cos_kx", "sin_kx"):
        # node coordinates agree to 1e-14 (tests/test_torch_space.py)
        assert np.max(np.abs(getattr(prob.relax, name).numpy()[perm]
                             - np.asarray(getattr(lp.relax, name)))) < 1e-13
    assert prob.relax.omega == lp.relax.omega and prob.dt == lp.dt
    t_t, y_t, phi_t = prob.run(n_steps=N_STEPS)
    prob.check_state(y_t, phi_t)
    assert not prob.last_solver_stats.unconverged
    assert prob.last_solver_stats.n_solves == 4 * N_STEPS
    assert abs(t_t - float(t_l)) < 1e-15
    y_c, phi_c = convert.state_from_lpfem(np.asarray(y_l), np.asarray(phi_l),
                                          s2v, prob.space.dof_dims)
    assert np.max(np.abs(y_t.numpy() - y_c)) < 1e-12
    assert np.max(np.abs(phi_t.numpy() - phi_c)) < 1e-12
    assert prob.last_solver_stats.max_iters == int(
        lp.last_solver_stats.max_iters)


@pytest.mark.parametrize("quad", [True, False])
def test_eta_error_metrics_match_lpfem(quad):
    kw = dict(nx=4, ny=2, nz=2, order=3, precond="jacobi")
    lp = LProblem(lp_preset("scaling_base", **kw))
    prob = Problem(lpfem_torch.preset("scaling_base", **kw), device="cpu")
    y0, _ = lp.initial_state(0.05)
    y = np.asarray(y0) + 1e-4 * np.random.default_rng(7).standard_normal(
        y0.shape)
    s2v = np.asarray(lp.surf.surf_to_vol)
    y_t, _ = convert.state_from_lpfem(y, np.zeros(prob.space.n_dofs), s2v,
                                      prob.space.dof_dims)
    t = 0.31 * lp.wave.T
    e_l = lp.eta_error_inf(y, t, quad=quad)
    e_t = (prob.eta_error_inf(torch.tensor(y_t), t) if quad
           else prob.eta_error_inf(torch.tensor(y_t), t, quad=False))
    assert e_l > 1e-5
    assert abs(e_t - e_l) < 1e-12, (e_t, e_l)


@pytest.mark.parametrize("name", ["pf_linear_serial", "pf_linear_par",
                                  "pf_linear_par_partial", "scaling_base"])
def test_wave_matches_lpfem(name):
    kw = dict(nx=12, ref_levels=0) if name != "scaling_base" else {}
    cfg = lp_preset(name, **kw)
    wl = build_wave(cfg, build_mesh(cfg))
    space = LatticeSpace.from_config(lpfem_torch.preset(name, **kw))
    from lpfem_torch.problem import build_wave as t_build_wave
    wt = t_build_wave(lpfem_torch.preset(name, **kw), *space.bounding_box())
    for f in ("k", "h", "kh", "omega", "T", "c", "wavelength", "z_top"):
        assert getattr(wt, f) == getattr(wl, f), f
