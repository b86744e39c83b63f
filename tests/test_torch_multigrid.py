"""lpfem_torch.multigrid.PMultigrid against lpfem.multigrid.PMultigrid.

A small periodic tank at order 2 with the dense / h-coarsening limits
lowered so that lpfem builds a p=2 -> p=1 level and one h-coarsened p=1
level below it; the coarse solve is the dense inverse or (with a tiny dense
limit) Chebyshev-16. Both hierarchies get lpfem's per-level lambda_max, so
one V-cycle is the same float64 arithmetic up to summation order: 1e-12
relative to max|z|.

The fused coarse solve (``kernels.coarse_cheb``) on the small cylinder's
p = 1 level: its plain mirror (the kernel's partition, per-block E-vectors,
fold in holder order and update) against the eager Chebyshev-16 from zero,
1e-13 relative to max|z| in float64 and 1e-5 in float32 (other summation
orders over 16 steps); its tables exactly.

The smoother's steps (``kernels.cheb_step``): on CPU tensors the wrapper's
plain path equals, bit for bit (``torch.equal``), a frozen copy of the
eager expressions the smoother ran before the steps became one launch each,
from zero and from a start vector, in float32 and float64, at degrees 1,
3, 4 and 16; the smoother's coefficients are
``coarse_cheb.chebyshev_coefficients``' (the fused coarse solve takes the
same list); the wrapper raises on what the kernel does not take.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpfem.mesh import make_wave_tank
from lpfem.multigrid import PMultigrid as LPMultigrid
from lpfem.operators import LaplacePA
from lpfem.space import H1Space, SurfaceSpace as LSurfaceSpace

from lpfem_torch import convert
from lpfem_torch.cylmesh import make_half_cylinder_tank
from lpfem_torch.kernels import cheb_step as kcs
from lpfem_torch.kernels import coarse_cheb as kcc
from lpfem_torch.multigrid import (ChebyshevSmoother, PMultigrid, _Level,
                                   estimate_lmax)
from lpfem_torch.operators import ElementLaplace, SeparableLattice, _fold_table
from lpfem_torch.space import CurvedLatticeSpace, LatticeSpace, grid_lines

NX, NY, NZ, P = 8, 2, 4, 2
# the small cylinder tank of tests/test_torch_cylinder.py (SMALL): 72 curved
# hexes, 182 dofs at p = 1
CYL = dict(Lx=12.0, Ly=6.0, h=1.0 / (2.0 * np.pi), cx=4.0, a=0.5, n_theta=12,
           n_r=6, nz=1, geom_order=2, grading=1.25, dr_max=None)


@functools.lru_cache(maxsize=None)
def _lpfem(dense_limit):
    sp = H1Space(make_wave_tank(NX, NY, NZ), P)
    s2v = np.asarray(LSurfaceSpace(sp, attr=2).surf_to_vol)
    op = LaplacePA(sp, dtype=jnp.float64, mode="fused")
    return LPMultigrid(op, ess_dofs=s2v, coarse_dense_limit=dense_limit,
                       h_coarsen_min_dofs=100, smooth_degree=4)


def _port(dense_limit, lmax):
    ls = LatticeSpace((grid_lines(NX, 1.0), grid_lines(NY, 0.1),
                       grid_lines(NZ, 1 / (2 * np.pi))), P,
                      (True, False, False))
    op = SeparableLattice(ls, torch.float64, "cpu")
    return PMultigrid(op, coarse_dense_limit=dense_limit,
                      h_coarsen_min_dofs=100, smooth_degree=4, lmax=lmax)


@pytest.mark.parametrize("dense_limit,coarse", [(100, "dense"),
                                                (10, "chebyshev")])
def test_vcycle_matches_lpfem(dense_limit, coarse):
    lpm = _lpfem(dense_limit)
    pm = _port(dense_limit, convert.smoother_lmax(lpm))
    dims = [lv.op.space.dof_dims for lv in pm.levels]
    assert dims == [lv.op.space.struct.dof_dims for lv in lpm.levels]
    assert pm.orders == lpm.orders == [2, 1, 1]       # one h-coarsened level
    assert (pm._coarse_inv is not None) == (coarse == "dense")
    assert isinstance(pm.coarse_solve, ChebyshevSmoother) == \
        (coarse == "chebyshev")

    n = lpm.levels[0].op.n_dofs
    r = np.random.default_rng(11).standard_normal(n)
    r[np.asarray(lpm.levels[0].ess)] = 0.0      # CG residuals vanish there
    z_ref = np.asarray(lpm(jnp.asarray(r)))
    z = pm(torch.tensor(r)).numpy()
    rel = np.max(np.abs(z - z_ref)) / np.max(np.abs(z_ref))
    assert rel < 1e-12, rel


def test_lmax_estimates_bracket_the_true_value():
    """The port's power iteration (seeded torch start vector) and lpfem's
    (jax PRNGKey(0) start) both approach lambda_max(D^-1 A_c) from below in
    20 iterations: each lies in [0.85, 1] x 1.1 x the true value, taken from
    the dense symmetric form D^-1/2 A_c D^-1/2 of every level."""
    lpm = _lpfem(100)
    pm = _port(100, None)
    for lv, got, want in zip(pm.levels, pm.lmax, convert.smoother_lmax(lpm)):
        A = lv.op.assemble_scipy().toarray()
        top = lv.op.space.top_plane_dofs()
        A[top, :] = 0.0
        A[:, top] = 0.0
        A[top, top] = 1.0
        s = np.sqrt(lv.inv_diag.numpy())
        lam = np.linalg.eigvalsh(s[:, None] * A * s[None, :])[-1]
        for est in (got, want):
            assert 0.85 * 1.1 * lam <= est <= 1.1 * lam * (1 + 1e-12), \
                (est, lam)


def test_estimate_lmax_of_a_diagonal_operator():
    d = torch.linspace(1.0, 4.0, 50, dtype=torch.float64)
    lam = estimate_lmax(lambda v: d * v, torch.ones_like(d), iters=200,
                        safety=1.0)
    assert lam == pytest.approx(4.0, rel=1e-3)


@functools.lru_cache(maxsize=None)
def _cylinder_pmg(dtype):
    """The small cylinder at p = 2 on the CPU with the Chebyshev coarse solve
    forced on its p = 1 level."""
    st = CurvedLatticeSpace(make_half_cylinder_tank(**CYL), 2)
    return PMultigrid(ElementLaplace(st, dtype, "cpu"), coarse_dense_limit=10)


@pytest.mark.parametrize("clusters", [1, 8, 16])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
def test_coarse_cheb_mirror_matches_chebyshev(dtype, tol, clusters):
    pm = _cylinder_pmg(dtype)
    assert pm.orders == [2, 1] and pm.coarse_route == "chebyshev"
    cl, cheb = pm.levels[-1], pm.coarse_solve
    assert isinstance(cheb, ChebyshevSmoother) and cheb.degree == 16
    cc = kcc.CoarseChebyshev(cl.op, cl.inv_diag, cheb, clusters)
    rng = np.random.default_rng(clusters)
    for r in (torch.tensor(rng.standard_normal(cl.op.n_dofs), dtype=dtype),
              torch.tensor(rng.standard_normal(cl.op.n_dofs),
                           dtype=dtype) * cl.free):
        z_ref = cheb(r)
        before = dict(kcc.LAUNCHES)
        assert cc.coefs is cheb.coefs           # one list, derived once
        z = cc(r)                                 # CPU tensors: the mirror
        assert kcc.LAUNCHES == before             # and no kernel launch
        rel = float((z - z_ref).abs().max() / z_ref.abs().max())
        assert rel < tol, rel


@pytest.mark.parametrize("clusters", [1, 8, 16])
def test_coarse_cheb_partition_tables(clusters):
    op = _cylinder_pmg(torch.float64).levels[-1].op
    ed, n = op.space.elem_dofs, op.n_dofs
    fold = _fold_table(ed, n)
    top = op.space.top_plane_dofs()
    t = kcc.partition(ed, fold, top, clusters)
    C, L, ne_max = t.eaddr.shape
    m, nd_max = t.ftab.shape[1:]
    assert (C, L, m) == (clusters, 8, fold.shape[1]) and nd_max % 4 == 0
    mask = (1 << kcc.RANK_SHIFT) - 1
    # every element in one block, in order: contiguous ranges
    assert t.elem_start[0] == 0 and t.elem_start[-1] == ed.shape[0]
    assert np.all(np.diff(t.elem_start) >= 0)
    np.testing.assert_array_equal(t.counts[:, 0], np.diff(t.elem_start))
    # every dof owned once
    own = t.gdof >= 0
    np.testing.assert_array_equal(np.sort(t.gdof[own]), np.arange(n))
    np.testing.assert_array_equal(t.counts[:, 1], own.sum(axis=1))
    # the node addresses name each node's owner and slot, -1 on the surface
    e = np.arange(ed.shape[0])
    blk = np.searchsorted(t.elem_start, e, side="right") - 1
    a = t.eaddr[blk, :, e - t.elem_start[blk]]                  # [ne, 8]
    is_top = np.isin(ed, top)
    np.testing.assert_array_equal(a < 0, is_top)
    np.testing.assert_array_equal(
        t.gdof[a[~is_top] >> kcc.RANK_SHIFT, a[~is_top] & mask], ed[~is_top])
    # each free dof's copies: its holders in ascending element order, the
    # positions of operators._fold_table; a free-surface dof is marked
    rank, slot = np.nonzero(own)
    dof = t.gdof[rank, slot]
    f = t.ftab[rank, :, slot]                                   # [n, m]
    ess = np.isin(dof, top)
    assert np.all(f[ess, 0] == kcc.ESS) and np.all(f[ess, 1:] == -1)
    ok = f[~ess] >= 0
    r_, s_ = f[~ess] >> kcc.RANK_SHIFT, f[~ess] & mask
    pos = ((t.elem_start[r_] + s_ % ne_max) * L + s_ // ne_max)
    want = fold[dof[~ess]]
    np.testing.assert_array_equal(ok, want < ed.size)
    np.testing.assert_array_equal(np.where(ok, pos, -1),
                                  np.where(want < ed.size, want, -1))


@pytest.mark.parametrize("case", ["tank", "cylinder_cpu"])
def test_coarse_route(case):
    if case == "tank":
        pm = _port(100, None)
        assert pm.coarse_route == "dense" and pm._coarse_inv is not None
    else:
        pm = _cylinder_pmg(torch.float64)
        # a full-metric p = 1 level the kernel would take, on CPU tensors
        op = pm.levels[-1].op
        assert kcc.fits(op.space.elem_dofs.shape[0], op.n_dofs, 1, 2,
                        torch.float64, op.fold.shape[1])
        assert pm.coarse_route == "chebyshev"
        assert isinstance(pm.coarse_solve, ChebyshevSmoother)


@pytest.mark.parametrize("ne,n_dofs,p,q,dtype,mult,want", [
    (4224, 8730, 1, 2, torch.float64, 4, True),     # the study's coarse level
    (4224, 8730, 1, 2, torch.float32, 4, True),
    (4224, 8730, 2, 3, torch.float64, 4, False),    # not p = 1
    (35328, 45355, 1, 2, torch.float64, 8, False),  # past the budget
])
def test_coarse_cheb_fits(ne, n_dofs, p, q, dtype, mult, want):
    assert kcc.fits(ne, n_dofs, p, q, dtype, mult) == want


def _eager_chebyshev(sm, r, z0=None):
    """The smoother's eager expressions as they were before each step
    became one launch (frozen)."""
    A, invD = sm.apply_fn, sm.inv_diag
    theta, delta = sm.theta, sm.delta
    if z0 is None:
        res = r
        z = torch.zeros_like(r)
    else:
        z = z0
        res = r - A(z)
    sigma = theta / delta
    rho = 1.0 / sigma
    d = invD * res / theta
    z = z + d
    for _ in range(sm.degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * (invD * (r - A(z)))
        z = z + d
        rho = rho_new
    return z


@functools.lru_cache(maxsize=None)
def _tank_level(dtype):
    """The top level of the small tank at order 2, constrained."""
    ls = LatticeSpace((grid_lines(NX, 1.0), grid_lines(NY, 0.1),
                       grid_lines(NZ, 1 / (2 * np.pi))), P,
                      (True, False, False))
    return _Level(SeparableLattice(ls, dtype, "cpu"))


@pytest.mark.parametrize("start", ["zero", "z0"])
@pytest.mark.parametrize("degree", [1, 3, 4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_smoother_steps_equal_the_frozen_eager_chain(dtype, degree, start):
    lv = _tank_level(dtype)
    sm = ChebyshevSmoother(lv.apply_c, lv.inv_diag, 2.7, degree=degree)
    gen = torch.Generator().manual_seed(degree)
    r = torch.randn(lv.op.n_dofs, generator=gen, dtype=torch.float64)
    r = r.to(dtype) * lv.free
    z0 = None if start == "zero" else torch.randn(
        lv.op.n_dofs, generator=gen, dtype=torch.float64).to(dtype) * lv.free
    r_in = r.clone()
    z0_in = None if z0 is None else z0.clone()
    before = (kcs.LAUNCHES, dict(kcs.LAUNCHES_BY_DTYPE))
    z = sm(r, z0=z0)
    assert (kcs.LAUNCHES, kcs.LAUNCHES_BY_DTYPE) == before   # plain path
    z_ref = _eager_chebyshev(sm, r, z0)
    assert z.dtype == dtype and torch.equal(z, z_ref)
    # neither r nor the start vector is written
    assert torch.equal(r, r_in)
    assert z0 is None or torch.equal(z0, z0_in)


@pytest.mark.parametrize("degree", [1, 3, 4, 16])
def test_smoother_coefficients_are_chebyshev_coefficients(degree):
    sm = ChebyshevSmoother(lambda v: v, torch.ones(4), 3.3, degree=degree)
    assert sm.coefs == kcc.chebyshev_coefficients(sm.theta, sm.delta, degree)
    sigma = sm.theta / sm.delta
    rho = 1.0 / sigma
    want = []
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        want.append((rho_new * rho, 2.0 * rho_new / sm.delta))
        rho = rho_new
    assert sm.coefs == want


def _bad_operands(case):
    """(function, args, kwargs, exception) of one operand the wrapper must
    refuse."""
    r = torch.randn(12, dtype=torch.float64)
    ok = dict(inv_diag=torch.rand(12, dtype=torch.float64),
              d=torch.empty(12, dtype=torch.float64),
              z=torch.empty(12, dtype=torch.float64))
    az = torch.randn(12, dtype=torch.float64)
    if case == "strided r":
        r = torch.randn(24, dtype=torch.float64)[::2]
    elif case == "strided z":
        ok["z"] = torch.empty(24, dtype=torch.float64)[::2]
    elif case == "shape":
        ok["d"] = torch.empty(13, dtype=torch.float64)
    elif case == "2-d shape":
        ok["inv_diag"] = ok["inv_diag"].reshape(3, 4)
    elif case == "dtype":
        az = az.float()
    elif case == "float16":
        r = r.half()
        az = az.half()
        ok = {k: v.half() for k, v in ok.items()}
    if case == "z0 without Az0":
        return (kcs.cheb_first, (r, ok["inv_diag"], 1.5, ok["d"], ok["z"]),
                dict(z0=torch.zeros(12, dtype=torch.float64)), ValueError)
    exc = TypeError if case == "float16" else ValueError
    return (kcs.cheb_step, (r, az, ok["inv_diag"], ok["d"], ok["z"], 0.5,
                            0.25), {}, exc)


@pytest.mark.parametrize("case", ["strided r", "strided z", "shape",
                                  "2-d shape", "dtype", "float16",
                                  "z0 without Az0"])
def test_cheb_step_wrapper_raises(case):
    fn, args, kwargs, exc = _bad_operands(case)
    with pytest.raises(exc):
        fn(*args, **kwargs)
