"""lpfem_torch.Problem against lpfem.Problem: the scaling-run path at a
small size (CPU; the port's operators take their plain-PyTorch versions).

Configuration: ``scaling_base`` cut to nx=4, ny=2, nz=8 elements at order 4
(16 x 9 x 33 dofs), p-multigrid, ``cg_rtol_sq=1e-20``, 5 RK4 steps = 20
Laplace solves. Both packages get the same smoother lambda_max (read from
lpfem's hierarchy), so the solves run the same arithmetic.

Tolerances: y and phi agree to 1e-12 absolute (the mixed-vs-f64 bound of
``tests/test_mixed.py:124``; values are O(1e-3)). Per-solve CG iteration
counts are equal in float64. In mixed mode XLA and PyTorch sum the inner
float32 dots and the float32 diagonal / coarse inverse in another order,
which can move each inner CG exit by one; a mixed solve is up to
``ir_max_outer`` inner CG passes, so its total may move by one per pass.
"""

import subprocess
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lpfem.configs import preset as lp_preset
from lpfem.problem import Problem as LProblem

import lpfem_torch
import lpfem_torch.solvers
from lpfem_torch import convert
from lpfem_torch.problem import Problem
from lpfem_torch.surface import SolveCarry, SolveStats
from lpfem_torch.timestep import rk4_run

KW = dict(nx=4, ny=2, nz=8, order=4, precond="pmg", cg_rtol_sq=1e-20)
N_STEPS = 5


def _lpfem_run(dtype):
    """lpfem's own jitted run, with each solve's iteration count recorded
    in execution order through an ordered debug callback."""
    lp = LProblem(lp_preset("scaling_base", dtype=dtype, **KW))
    iters = []
    info_fn = lp.fso._info

    def _info(res):
        jax.debug.callback(lambda it: iters.append(int(it)), res.iters,
                           ordered=True)
        return info_fn(res)

    lp.fso._info = _info
    (t, y, phi), _ = lp.run(n_steps=N_STEPS)
    return lp, float(t), np.asarray(y), np.asarray(phi), iters


@pytest.mark.parametrize("dtype", ["float64", "mixed"])
def test_problem_matches_lpfem(dtype, monkeypatch):
    lp, t_l, y_l, phi_l, iters_l = _lpfem_run(dtype)
    assert len(iters_l) == 4 * N_STEPS

    prob = Problem(lpfem_torch.preset("scaling_base", dtype=dtype, **KW),
                   device="cpu", lmax=convert.smoother_lmax(lp.fso._precond))
    assert prob.space.dof_dims == lp.space.struct.dof_dims
    iters_p, passes = [], []
    inner_pcg = lpfem_torch.solvers.pcg

    def counting_pcg(*args, **kwargs):
        passes[-1] += 1
        return inner_pcg(*args, **kwargs)

    monkeypatch.setattr(lpfem_torch.solvers, "pcg", counting_pcg)
    solve = prob.fso.solve_laplace

    def counting_solve(phi_fs, phi):
        passes.append(0)
        x, info = solve(phi_fs, phi)
        iters_p.append(info.iters)
        return x, info

    prob.fso.solve_laplace = counting_solve
    t_p, y_p, phi_p = prob.run(n_steps=N_STEPS)
    prob.check_state(y_p, phi_p)
    assert y_p.dtype == torch.float64 and phi_p.dtype == torch.float64
    assert prob.last_solver_stats.n_solves == 4 * N_STEPS
    assert not prob.last_solver_stats.unconverged
    assert abs(t_p - t_l) < 1e-15

    y_c, phi_c = convert.state_from_lpfem(
        y_l, phi_l, np.asarray(lp.surf.surf_to_vol), prob.space.dof_dims)
    assert np.max(np.abs(y_p.numpy() - y_c)) < 1e-12
    assert np.max(np.abs(phi_p.numpy() - phi_c)) < 1e-12
    diffs = np.abs(np.array(iters_p) - np.array(iters_l))
    if dtype == "float64":
        assert diffs.max() == 0, (iters_p, iters_l)
    else:
        assert min(passes) >= 2          # the outer loop really refined
        assert np.all(diffs <= np.array(passes)), (iters_p, iters_l, passes)

    e_l = lp.eta_error_inf(y_l, t_l, quad=False)
    e_p = prob.eta_error_inf(y_p, t_p, quad=False)
    assert abs(e_p - e_l) < 1e-12, (e_p, e_l)
    # the round trip back to lpfem's surface order is exact
    y_back, _ = convert.state_to_lpfem(y_c, phi_c,
                                       np.asarray(lp.surf.surf_to_vol),
                                       prob.space.dof_dims)
    np.testing.assert_array_equal(y_back, y_l)


@pytest.mark.parametrize("override,error,reason", [
    (dict(mesh_kind="gmsh"), ValueError, "needs mesh_file"),
    (dict(hi_apply="ds", dtype="float64"), ValueError, "hi_apply='ds' needs"),
    (dict(apply_mode="assembled", dtype="mixed"), ValueError,
     "'assembled' \\+ dtype='mixed'"),
    (dict(mesh_kind="mfem"), ValueError, "mesh_file"),
    (dict(mesh_kind="tetra"), ValueError, "unknown mesh_kind"),
])
def test_problem_rejects_unported_configs(override, error, reason):
    cfg = lpfem_torch.preset("scaling_base", **override)
    with pytest.raises(error, match=reason):
        Problem(cfg, device="cpu")


def test_problem_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Problem(lpfem_torch.preset("scaling_base", nx=4, nz=2), device="cuda")


def test_rk4_guard_freezes_at_last_finite_step():
    """A right-hand side that turns non-finite at its 5th call (step 2):
    the run stops with step 1's state and ok=False."""
    calls = []

    def f(t, y, aux):
        calls.append(t)
        k = -y if len(calls) < 5 else torch.full_like(y, float("nan"))
        return k, aux

    y0 = torch.ones(3, dtype=torch.float64)
    (t, y, aux), ok = rk4_run(f, y0, y0.clone(), 0.0, 0.1, n_steps=4)
    assert not ok
    assert t == pytest.approx(0.1)
    # one classic RK4 step of y' = -y
    h = 0.1
    want = 1 - h + h ** 2 / 2 - h ** 3 / 6 + h ** 4 / 24
    assert torch.allclose(y, torch.full_like(y, want), rtol=0, atol=1e-15)


def test_problem_warns_and_flags_unconverged_solves():
    """A max_iter cut leaves the threshold unmet: telemetry says so and the
    run warns (MFEM's "No convergence!"); check_state passes (finite)."""
    prob = Problem(lpfem_torch.preset("scaling_base", nx=4, nz=2, order=2,
                                      precond="jacobi", cg_max_iter=3),
                   device="cpu")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        t, y, phi = prob.run(n_steps=1)
    assert any(issubclass(w.category, RuntimeWarning) for w in rec)
    stats = prob.last_solver_stats
    assert isinstance(stats, SolveStats) and stats.unconverged
    assert stats.max_iters == 3 and stats.n_solves == 4
    prob.check_state(y, phi)
    assert isinstance(SolveCarry(phi, stats).stats, SolveStats)


def test_preconditioners_reach_the_same_trajectory():
    """Jacobi, Chebyshev and p-multigrid solve the same systems to
    r.z <= rz0*1e-24, each in its own preconditioned norm, so the solutions
    differ by up to cond(A) x 1e-12 relative, not by round-off: two steps
    agree to 1e-10 absolute (values O(1e-3)), and the stronger
    preconditioners need fewer iterations."""
    runs = {}
    for pc in ("jacobi", "chebyshev", "pmg"):
        prob = Problem(lpfem_torch.preset("scaling_base", nx=4, nz=2, order=3,
                                          precond=pc, cheb_degree=3),
                       device="cpu")
        _, y, _ = prob.run(n_steps=2)
        assert not prob.last_solver_stats.unconverged
        runs[pc] = (y, prob.last_solver_stats.total_iters)
    for pc in ("chebyshev", "pmg"):
        assert float((runs[pc][0] - runs["jacobi"][0]).abs().max()) < 1e-10
        assert runs[pc][1] < runs["jacobi"][1]


def test_import_pulls_in_no_jax():
    code = ("import sys, lpfem_torch, lpfem_torch.convert, "
            "lpfem_torch.kernels._build, lpfem_torch.kernels.sep_apply, "
            "lpfem_torch.ds, lpfem_torch.kernels.sep_apply_ds, "
            "lpfem_torch.experiments.solve_profile; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'lpfem' "
            "or m.startswith('lpfem.')]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stdout + proc.stderr
