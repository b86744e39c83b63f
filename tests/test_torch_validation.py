"""The stationary Laplace validation path against lpfem on the CPU.

The port's pieces of ``experiments/laplace_conv.py`` held against lpfem's on
the study's x-periodic box tank (``make_wave_tank(8, 1, 2)``), where the
port's operator is the Kronecker lattice (kernel B1's plain version here):

- ``AiryWave.phi`` within 1e-15 relative at seeded points;
- ``constrained_apply`` on an essential list that is not the free surface
  (the boundary-attribute-1 dofs) within 1e-13 of max|y| of lpfem's, on the
  Kronecker and the element-form operator; on the free-surface list it
  takes the top-plane route and gives the same result as the general one;
- ``l2_norm_sq`` / ``l2_error`` (MFEM ``ComputeL2Error``) within 1e-12
  relative, on ``H1Space`` and ``LatticeSpace``;
- ``pcg_refined``: the same total inner iterations as lpfem's, x within
  1e-12 of max|x|;
- ``laplace_conv.run_case`` at p = 1, 2, 3 in float64 and mixed, with
  lpfem's smoother lambda_max injected (``convert.smoother_lmax``): the
  same dofs and iterations, err_inf and err_l2 within 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from experiments.laplace_conv import run_case as lp_run_case
from lpfem.analytic import AiryWave as LAiryWave
from lpfem.mesh import make_wave_tank as lp_tank
from lpfem.multigrid import PMultigrid as LPMultigrid
from lpfem.operators import LaplacePA
from lpfem.solvers import pcg_refined as lp_pcg_refined
from lpfem.space import H1Space as LH1Space
from lpfem.space import SurfaceSpace as LSurfaceSpace

from lpfem_torch import convert
from lpfem_torch.analytic import AiryWave
from lpfem_torch.experiments.laplace_conv import run_case
from lpfem_torch.mesh import make_wave_tank
from lpfem_torch.multigrid import PMultigrid
from lpfem_torch.operators import (ElementLaplace, SeparableLattice,
                                   laplace_operator)
from lpfem_torch.solvers import pcg_refined
from lpfem_torch.space import H1Space, LatticeSpace, SurfaceSpace, grid_lines

NX, NZ = 8, 2


def _waves():
    lm = lp_tank(NX, 1, NZ)
    bb0, bb1 = lm.bounding_box()
    kw = dict(H=0.005, m=2.0, Lx=1.0, h=bb1[2] - bb0[2], z_top=bb1[2])
    return lm, LAiryWave.from_modes(**kw), AiryWave.from_modes(**kw)


def _lpfem_lmax(lm, p, dtype):
    sp = LH1Space(lm, p)
    op = LaplacePA(sp, dtype=jnp.float32 if dtype == "mixed" else jnp.float64)
    surf = LSurfaceSpace(sp, attr=2)
    return convert.smoother_lmax(
        LPMultigrid(op, ess_dofs=np.asarray(surf.surf_to_vol)))


def test_airy_phi_matches_lpfem():
    _, lw, w = _waves()
    rng = np.random.default_rng(0)
    x, y = rng.uniform(0, 1, 500), rng.uniform(0, 0.1, 500)
    z = rng.uniform(-0.1, 1 / (2 * np.pi), 500)
    for t in (0.0, 0.37):
        a, b = lw.phi(x, y, z, t), w.phi(x, y, z, t)
        assert np.max(np.abs(a - b)) <= 1e-15 * np.max(np.abs(a))


@pytest.mark.parametrize("p", [1, 2, 3])
def test_constrained_apply_on_a_general_essential_list(p):
    lm = lp_tank(NX, 1, NZ)
    ls, ps = LH1Space(lm, p), H1Space(make_wave_tank(NX, 1, NZ), p)
    ess_np = ls.boundary_dofs(1)
    np.testing.assert_array_equal(ess_np, ps.boundary_dofs(1))
    assert 0 < len(ess_np) < ps.n_dofs
    x_np = np.random.default_rng(p).standard_normal(ps.n_dofs)
    ref = np.asarray(LaplacePA(ls, dtype=jnp.float64).constrained_apply(
        jnp.asarray(x_np), jnp.asarray(ess_np)))
    x, ess = torch.tensor(x_np), torch.as_tensor(ess_np)
    sep = laplace_operator(ps, torch.float64, "cpu")
    assert isinstance(sep, SeparableLattice)
    for op in (sep, ElementLaplace(ps, torch.float64, "cpu")):
        y = op.constrained_apply(x, ess).numpy()
        assert np.max(np.abs(y - ref)) <= 1e-13 * np.max(np.abs(ref))
        np.testing.assert_array_equal(y[ess_np], x_np[ess_np])
        # the free surface, in surface order: the top-plane route
        top = torch.as_tensor(SurfaceSpace(ps, attr=2).surf_to_vol)
        y_top = op.constrained_apply(x, top)
        x0 = x.clone()
        x0[top] = 0.0
        y_gen = op.apply(x0)
        y_gen[top] = x[top]
        assert torch.allclose(y_top, y_gen, rtol=0, atol=1e-13
                              * float(y_gen.abs().max()))


@pytest.mark.parametrize("p", [1, 2, 3])
def test_l2_error_matches_lpfem(p):
    lm, lw, w = _waves()
    ls = LH1Space(lm, p)
    ps = H1Space(make_wave_tank(NX, 1, NZ), p)
    lat = LatticeSpace((grid_lines(NX, 1.0), grid_lines(1, 0.1),
                        grid_lines(NZ, 1.0 / (2 * np.pi))), p,
                       (True, False, False))
    x_np = ps.project(lambda x, y, z: w.phi(x, y, z)) * (
        1.0 + 1e-3 * np.random.default_rng(p).standard_normal(ps.n_dofs))
    lop = LaplacePA(ls, dtype=jnp.float64)
    ref_err = float(lop.l2_error(jnp.asarray(x_np),
                                 lambda x, y, z: lw.phi(x, y, z)))
    ref_nsq = float(lop.l2_norm_sq(jnp.asarray(x_np)))
    x = torch.tensor(x_np)
    for sp in (ps, lat):
        for op in (laplace_operator(sp, torch.float64, "cpu"),
                   ElementLaplace(sp, torch.float64, "cpu")):
            err = float(op.l2_error(x, lambda x, y, z: w.phi(x, y, z)))
            nsq = float(op.l2_norm_sq(x))
            assert abs(err - ref_err) <= 1e-12 * ref_err
            assert abs(nsq - ref_nsq) <= 1e-12 * ref_nsq


def test_pcg_refined_matches_lpfem():
    lm, lw, w = _waves()
    p = 2
    ls, ps = LH1Space(lm, p), H1Space(make_wave_tank(NX, 1, NZ), p)
    lsurf, psurf = LSurfaceSpace(ls, attr=2), SurfaceSpace(ps, attr=2)
    l_ess = jnp.asarray(lsurf.surf_to_vol.astype(np.int32))
    lop32, lop64 = (LaplacePA(ls, dtype=jnp.float32),
                    LaplacePA(ls, dtype=jnp.float64))
    lpre = LPMultigrid(lop32, ess_dofs=np.asarray(lsurf.surf_to_vol))
    lphi = jnp.asarray(lsurf.project(lambda x, y, z: lw.phi(x, y, z)))
    lB, lx0 = lop64.constrained_rhs(jnp.zeros(ls.n_dofs), l_ess, lphi)
    ref = lp_pcg_refined(lambda v: lop64.constrained_apply(v, l_ess),
                         lambda v: lop32.constrained_apply(v, l_ess), lB, lx0,
                         precond_lo=lpre, rtol_sq=1e-24, max_outer=8)

    ess = torch.as_tensor(psurf.surf_to_vol)
    op32 = laplace_operator(ps, torch.float32, "cpu")
    op64 = laplace_operator(ps, torch.float64, "cpu")
    pre = PMultigrid(op32, lmax=convert.smoother_lmax(lpre))
    phi = torch.tensor(psurf.project(lambda x, y, z: w.phi(x, y, z)))
    B, x0 = op64.constrained_rhs(torch.zeros(ps.n_dofs, dtype=torch.float64),
                                 phi, ess)
    res = pcg_refined(lambda v: op64.constrained_apply(v, ess),
                      lambda v: op32.constrained_apply(v, ess), B, x0,
                      precond_lo=pre, rtol_sq=1e-24, max_outer=8)
    assert res.iters == int(ref.iters) > 0
    xr = np.asarray(ref.x)
    assert np.max(np.abs(res.x.numpy() - xr)) <= 1e-12 * np.max(np.abs(xr))
    assert float(res.rz) <= 1e-24 * float(res.rz0)


@pytest.mark.parametrize("dtype", ["float64", "mixed"])
@pytest.mark.parametrize("p", [1, 2, 3])
def test_run_case_matches_lpfem(p, dtype):
    lm, lw, w = _waves()
    ref = lp_run_case(lm, p, lw, 1e-24, 2000, "pmg", dtype=dtype)
    lmax = _lpfem_lmax(lm, p, dtype) if p > 1 else None
    got = run_case(make_wave_tank(NX, 1, NZ), p, w, 1e-24, 2000, "pmg",
                   dtype=dtype, device="cpu", lmax=lmax)
    assert got["dofs"] == ref["dofs"]
    assert got["iters"] == ref["iters"]
    for k in ("err_inf", "err_l2"):
        assert abs(got[k] - ref[k]) <= 1e-6 * ref[k], (k, got[k], ref[k])


def test_run_case_takes_only_full_float32_products():
    _, _, w = _waves()
    with pytest.raises(ValueError, match="exact float32"):
        run_case(make_wave_tank(NX, 1, NZ), 2, w, 1e-24, 10,
                 dtype="mixed", inner_precision="default", device="cpu")
