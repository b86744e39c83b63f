"""The wave-cylinder diffraction path of lpfem_torch against lpfem on the CPU.

The small tank of the study's quick setup: the polar half-cylinder block with
``n_theta=12, n_r=6, nz=1``, geometric grading 1.25 (no ``dr_max``), exact
order-2 geometry, order 2 — 72 curved hexes, 975 dofs. Inputs are made from
numpy seeds and handed to both packages.

Tolerances: mesh, numbering and node coordinates are the same computation in
both packages, so equal; ``G6q`` 1e-13 relative (float64 host geometry,
another summation order); operator applies, diagonal and assembled matrix
1e-13 relative to their max (float64 round-off); float32 element apply 1e-5
relative (the float tolerance of ``tests/test_lattice_kernel.py:62``); the
V-cycle 1e-12 relative with lpfem's lambda_max injected; 5 RK4 steps 1e-12
absolute on values of O(1e-2) (``tests/test_mixed.py:124``), iteration
counts equal in float64 and within one per inner pass in mixed (XLA and
PyTorch sum the float32 dots in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpfem.analytic import mccamy_fuchs_envelope as lp_mf
from lpfem.configs import Config as LConfig
from lpfem.cylmesh import make_half_cylinder_tank as lp_cyl
from lpfem.multigrid import PMultigrid as LPMultigrid
from lpfem.multigrid import _coarsen_structured_mesh
from lpfem.operators import LaplacePA
from lpfem.operators import NodalZDerivative as LNodalZ
from lpfem.problem import Problem as LProblem
from lpfem.space import H1Space
from lpfem.space import SurfaceSpace as LSurfaceSpace
from lpfem.surface import RelaxationZones as LZones
from lpfem.surface import cabs_weight as lp_cabs
from lpfem.surface import cgen_weight as lp_cgen
from experiments.diffraction import extract_rim as lp_extract_rim

import lpfem_torch.solvers
from lpfem_torch import convert
from lpfem_torch.analytic import mccamy_fuchs_envelope
from lpfem_torch.cylmesh import make_half_cylinder_tank
from lpfem_torch.experiments.diffraction import build_problem, extract_rim
from lpfem_torch.geometry import top_trace_geometry
from lpfem_torch.mesh import Mesh
from lpfem_torch.multigrid import PMultigrid
from lpfem_torch.operators import ElementLaplace, NodalZDerivative
from lpfem_torch.space import CurvedLatticeSpace, SurfaceSpace
from lpfem_torch.surface import SolveCarry, SolveStats

H = 1.0 / (2.0 * np.pi)
SMALL = dict(Lx=12.0, Ly=6.0, h=H, cx=4.0, a=0.5, n_theta=12, n_r=6, nz=1,
             geom_order=2, grading=1.25, dr_max=None)
MESH_CASES = [SMALL, dict(SMALL, n_theta=24, nz=2, geom_order=4,
                          grading=1.4, dr_max=0.5)]
N_STEPS = 5


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def small():
    """(lpfem space, port space, lpfem surface, top-plane permutation)."""
    sl = H1Space(lp_cyl(**SMALL), 2)
    st = CurvedLatticeSpace(make_half_cylinder_tank(**SMALL), 2)
    surl = LSurfaceSpace(sl, attr=2)
    s2v = np.asarray(surl.surf_to_vol)
    return sl, st, surl, convert.surface_permutation(s2v, st.dof_dims)


@pytest.mark.parametrize("kw", MESH_CASES)
def test_cylinder_mesh_matches_lpfem(kw):
    ml, mt = lp_cyl(**kw), make_half_cylinder_tank(**kw)
    for f in ("verts", "elems", "corner_coords", "bdr_quads", "bdr_attrs",
              "elem_lattice", "geom_nodes"):
        np.testing.assert_array_equal(getattr(mt, f), getattr(ml, f))
    assert mt.lattice_dims == ml.lattice_dims
    assert mt.geom_order == ml.geom_order
    for a, b in zip(mt.bounding_box(), ml.bounding_box()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_curved_space_matches_h1space(p, small):
    sl = H1Space(lp_cyl(**SMALL), p)
    st = CurvedLatticeSpace(make_half_cylinder_tank(**SMALL), p)
    assert sl.struct is not None
    assert st.dof_dims == sl.struct.dof_dims
    assert st.elem_dims == sl.struct.elem_dims
    assert st.n_dofs == sl.n_dofs
    np.testing.assert_array_equal(st.elem_dofs, sl.elem_dofs)
    np.testing.assert_array_equal(st.mesh.geom_nodes, sl.mesh.geom_nodes)
    np.testing.assert_array_equal(st.node_coords, sl.node_coords)
    np.testing.assert_array_equal(st.node_mult, sl.node_mult)
    assert st.with_order(1).dof_dims == H1Space(sl.mesh, 1).struct.dof_dims
    # the surface: lpfem's SurfaceSpace(attr=2) is a permutation of the top
    # plane; convert maps states between the two orders exactly
    surl = LSurfaceSpace(sl, attr=2)
    surt = SurfaceSpace(st)
    s2v = np.asarray(surl.surf_to_vol)
    perm = convert.surface_permutation(s2v, st.dof_dims)
    np.testing.assert_array_equal(surt.node_coords[perm], surl.node_coords)
    y = np.random.default_rng(p).standard_normal(2 * surl.n_dofs)
    y_t, _ = convert.state_from_lpfem(y, np.zeros(st.n_dofs), s2v,
                                      st.dof_dims)
    y_b, _ = convert.state_to_lpfem(y_t, np.zeros(st.n_dofs), s2v,
                                    st.dof_dims)
    np.testing.assert_array_equal(y_b, y)


@pytest.mark.parametrize("p", [1, 2])
def test_metric_matches_lpfem(p):
    sl = H1Space(lp_cyl(**SMALL), p)
    st = CurvedLatticeSpace(make_half_cylinder_tank(**SMALL), p)
    G = np.asarray(LaplacePA(sl, dtype=jnp.float64, mode="fused").G)
    op = ElementLaplace(st, torch.float64, "cpu")
    G6q = G.transpose(0, 2, 1).reshape(G.shape[0], -1)
    assert _rel(op.G6q.numpy(), G6q) < 1e-13
    np.testing.assert_array_equal(
        op.Jr2.numpy(), np.asarray(LaplacePA(sl, dtype=jnp.float64,
                                             mode="fused").Jr).reshape(
                                                 op.Jr2.shape))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
def test_plain_element_apply_matches_fused(dtype, tol, small):
    sl, st, _, _ = small
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    opl = LaplacePA(sl, dtype=jdt, mode="fused",
                    precision=None if dtype == torch.float64 else "highest")
    opt = ElementLaplace(st, dtype, "cpu")
    x = np.random.default_rng(1).standard_normal(sl.n_dofs)
    ye_l = np.asarray(opl.apply_local(jnp.asarray(x, dtype=jdt)))
    ye_t = opt.apply_local(torch.tensor(x, dtype=dtype)).numpy()
    assert _rel(ye_t, ye_l) < tol
    y_l = np.asarray(opl.apply(jnp.asarray(x, dtype=jdt)))
    y_t = opt.apply(torch.tensor(x, dtype=dtype)).numpy()
    assert _rel(y_t, y_l) < tol


@pytest.mark.parametrize("form", ["apply", "constrained", "diag",
                                  "assembled"])
def test_operator_forms_match_lpfem(form, small):
    sl, st, surl, _ = small
    opl = LaplacePA(sl, dtype=jnp.float64, mode="fused")
    opt = ElementLaplace(st, torch.float64, "cpu")
    ess = np.asarray(surl.surf_to_vol)
    x = np.random.default_rng(2).standard_normal(sl.n_dofs)
    if form == "apply":
        got, want = opt.apply(torch.tensor(x)), opl.apply(jnp.asarray(x))
    elif form == "constrained":
        got = opt.constrained_apply_top(torch.tensor(x))
        want = opl.constrained_apply(jnp.asarray(x), jnp.asarray(ess))
    elif form == "diag":
        got, want = opt.diag(), opl.diag
    else:
        A_t, A_l = opt.assemble_scipy(), opl.assemble_scipy()
        got, want = A_t.toarray(), A_l.toarray()
        assert _rel(A_t @ x, opt.apply(torch.tensor(x)).numpy()) < 1e-13
    assert _rel(np.asarray(got), np.asarray(want)) < 1e-13


def test_top_trace_matches_lpfem(small):
    sl, st, surl, perm = small
    opl = LaplacePA(sl, dtype=jnp.float64, mode="fused")
    zl = LNodalZ(opl)
    assert zl.enable_top_trace(np.asarray(surl.surf_to_vol))
    zt = NodalZDerivative(st, torch.float64, "cpu")
    assert zt.jz == zl._top[0]
    x = np.random.default_rng(3).standard_normal(sl.n_dofs)
    w_t = zt.top_trace(torch.tensor(x)).numpy()
    w_l = np.asarray(zl.top_trace(jnp.asarray(x)))
    assert _rel(w_t[perm], w_l) < 1e-13


def test_top_trace_off_extrusion_matches_lpfem_full_derivative():
    """Where lpfem's extrusion check fails (here: z bent along x; on the
    full-size study tank: round-off), lpfem takes its full nodal-derivative
    path; the port's top-layer restriction of it gives the same values."""
    def bent(m):
        g = m.geom_nodes.copy()
        g[..., 2] += 0.01 * np.sin(g[..., 0]) * g[..., 2]
        m.geom_nodes = g
        return m

    sl = H1Space(bent(lp_cyl(**SMALL)), 2)
    st = CurvedLatticeSpace(bent(make_half_cylinder_tank(**SMALL)), 2)
    zl = LNodalZ(LaplacePA(sl, dtype=jnp.float64, mode="fused"))
    ess = np.asarray(LSurfaceSpace(sl, attr=2).surf_to_vol)
    assert not zl.enable_top_trace(ess)
    zt = NodalZDerivative(st, torch.float64, "cpu")
    assert zt.jz is None and top_trace_geometry(st)[0] is None
    x = np.random.default_rng(8).standard_normal(sl.n_dofs)
    w_l = np.asarray(zl(jnp.asarray(x)))[ess]
    w_t = zt.top_trace(torch.tensor(x)).numpy()
    perm = convert.surface_permutation(ess, st.dof_dims)
    assert _rel(w_t[perm], w_l) < 1e-13


def test_curved_space_guards():
    m = make_half_cylinder_tank(**SMALL)
    with pytest.raises(ValueError, match="H1Space"):
        CurvedLatticeSpace(Mesh(m.verts, m.elems, m.corner_coords,
                                m.bdr_quads, m.bdr_attrs), 2)
    assert CurvedLatticeSpace(m, 1).coarsen() is None       # nez = 1 is odd
    # even dimensions: the merged polar mesh declares no lattice and is no
    # Cartesian product, so lpfem's h-coarsening stops, and so does this
    even = make_half_cylinder_tank(**dict(SMALL, nz=2))
    sp_even = CurvedLatticeSpace(even, 1)
    assert sp_even.coarsen() is None
    assert H1Space(_coarsen_structured_mesh(H1Space(lp_cyl(
        **dict(SMALL, nz=2)), 1)), 1).struct is None
    bad = make_half_cylinder_tank(**SMALL)
    bad.elems = bad.elems[:, [1, 0, 3, 2, 5, 4, 7, 6]]      # mirrored in x
    with pytest.raises(ValueError, match="lattice"):
        CurvedLatticeSpace(bad, 2)
    inv = make_half_cylinder_tank(**SMALL)
    g = inv.geom_nodes.reshape(-1, 3, 3, 3, 3).copy()
    g[0] = g[0, :, :, ::-1]                                  # inverted element
    inv.geom_nodes = g.reshape(inv.geom_nodes.shape)
    with pytest.raises(ValueError, match="Jacobian"):
        ElementLaplace(CurvedLatticeSpace(inv, 2), torch.float64, "cpu")


def test_vcycle_matches_lpfem(small):
    sl, st, surl, _ = small
    opl = LaplacePA(sl, dtype=jnp.float64, mode="fused")
    pl = LPMultigrid(opl, smooth_degree=3,
                     ess_dofs=np.asarray(surl.surf_to_vol))
    pt = PMultigrid(ElementLaplace(st, torch.float64, "cpu"),
                    smooth_degree=3, lmax=convert.smoother_lmax(pl))
    assert pt.orders == pl.orders == [2, 1]
    assert pt._coarse_inv is not None            # the dense coarse inverse
    r = np.random.default_rng(4).standard_normal(sl.n_dofs)
    r[st.top_plane_dofs()] = 0.0
    assert _rel(pt(torch.tensor(r)).numpy(), pl(jnp.asarray(r))) < 1e-12


def _lpfem_problem(dtype):
    """lpfem's study setup (``experiments/diffraction.py:147-189``) on the
    small tank, dt = T/35 as the study."""
    cfg = LConfig(name="cylinder_diffraction", order=2, H=0.01,
                  wave_by="wavelength", wave_lambda=1.0, kh_override=1.0,
                  nsteps=525, t_final_periods=15.0,
                  cg_rtol_sq=1e-24 if dtype == "float64" else 1e-10,
                  cg_atol_sq=0.0 if dtype == "float64" else 1e-20,
                  cg_max_iter=600, dtype=dtype, precond="pmg", cheb_degree=3)
    mesh = lp_cyl(**SMALL)
    lp = LProblem(cfg, mesh=mesh)
    lam = lp.wave.wavelength
    bbmin, bbmax = mesh.bounding_box()
    X = lp.surf.node_coords
    cgen = lp_cgen(X[:, 0], float(bbmin[0]), float(bbmin[0]) + 2.5 * lam)
    cabs = lp_cabs(X[:, 0], float(bbmax[0]) - 4.0 * lam, float(bbmax[0]))
    cabsy = lp_cabs(X[:, 1], float(bbmax[1]) - 3.0 * lam, float(bbmax[1]))
    lp.relax = LZones.build(lp.surf, lp.wave, tau=lp.dt, cgen=cgen + cabsy,
                            cabs=cabs, n_ramp=3.0, dtype=lp.dtype)
    lp.fso.relax = lp.relax
    return lp


def _port_problem(dtype, lp):
    return build_problem("cpu", order=2, n_theta=12, n_r=6, dr_max=0.0,
                         nz=1, dtype=dtype,
                         lmax=convert.smoother_lmax(lp.fso._precond))


def test_relaxation_zones_and_rhs_match_lpfem(small):
    _, st, _, perm = small
    lp = _lpfem_problem("float64")
    pt = _port_problem("float64", lp)
    s2v = np.asarray(lp.surf.surf_to_vol)
    for name in ("cgen", "cabs", "cos_kx", "sin_kx"):
        assert _rel(getattr(pt.relax, name).numpy()[perm],
                    getattr(lp.relax, name)) < 1e-15
    for t in (0.0, 0.37, 1.91):
        for a, b in zip(pt.relax.targets(t), lp.relax.targets(t)):
            assert np.max(np.abs(a.numpy()[perm] - np.asarray(b))) < 1e-15
    # one right-hand side with all three zones active, from a perturbed state
    y0, phi0 = lp.initial_state(0.2)
    rng = np.random.default_rng(5)
    y = np.asarray(y0) + 1e-3 * rng.standard_normal(y0.shape)
    t = 0.8 * lp.wave.T
    dy_l, phi_l = lp.fso(t, jnp.asarray(y), phi0)
    y_t, phi_t = convert.state_from_lpfem(y, np.asarray(phi0), s2v,
                                          st.dof_dims)
    dy_t, carry = pt.fso(t, torch.tensor(y_t),
                         SolveCarry(torch.tensor(phi_t), SolveStats()))
    dy_c, phi_c = convert.state_from_lpfem(np.asarray(dy_l),
                                           np.asarray(phi_l), s2v,
                                           st.dof_dims)
    assert np.max(np.abs(dy_t.numpy() - dy_c)) < 1e-12
    assert np.max(np.abs(carry.phi.numpy() - phi_c)) < 1e-12
    assert carry.stats.n_solves == 1 and not carry.stats.unconverged


@pytest.mark.parametrize("dtype", ["float64", "mixed"])
def test_diffraction_trajectory_matches_lpfem(dtype, small, monkeypatch):
    _, st, _, _ = small
    lp = _lpfem_problem(dtype)
    iters_l = []
    info_fn = lp.fso._info

    def _info(res):
        jax.debug.callback(lambda it: iters_l.append(int(it)), res.iters,
                           ordered=True)
        return info_fn(res)

    lp.fso._info = _info
    (t_l, y_l, phi_l), _ = lp.run(n_steps=N_STEPS)
    pt = _port_problem(dtype, lp)
    iters_t, passes = [], []
    inner_pcg = lpfem_torch.solvers.pcg

    def counting_pcg(*args, **kwargs):
        passes[-1] += 1
        return inner_pcg(*args, **kwargs)

    monkeypatch.setattr(lpfem_torch.solvers, "pcg", counting_pcg)
    solve = pt.fso.solve_laplace

    def counting_solve(phi_fs, phi):
        passes.append(0)
        x, info = solve(phi_fs, phi)
        iters_t.append(info.iters)
        return x, info

    pt.fso.solve_laplace = counting_solve
    recs = []
    t_t, y_t, phi_t = pt.run(n_steps=N_STEPS,
                             record=lambda t, y, aux: recs.append(t))
    pt.check_state(y_t, phi_t)
    assert len(recs) == N_STEPS and recs[-1] == t_t
    assert abs(t_t - float(t_l)) < 1e-15
    assert not pt.last_solver_stats.unconverged
    y_c, phi_c = convert.state_from_lpfem(
        np.asarray(y_l), np.asarray(phi_l), np.asarray(lp.surf.surf_to_vol),
        st.dof_dims)
    assert np.max(np.abs(y_t.numpy() - y_c)) < 1e-12
    assert np.max(np.abs(phi_t.numpy() - phi_c)) < 1e-12
    assert len(iters_l) == len(iters_t) == 4 * N_STEPS
    diffs = np.abs(np.array(iters_t) - np.array(iters_l))
    if dtype == "float64":
        assert diffs.max() == 0, (iters_t, iters_l)
    else:
        assert np.all(diffs <= np.array(passes)), (iters_t, iters_l, passes)
    for quad in (True, False):
        e_l = lp.eta_error_inf(y_l, t_l, quad=quad)
        e_t = pt.eta_error_inf(y_t, t_t, quad=quad)
        assert abs(e_t - e_l) < 1e-12, (quad, e_t, e_l)


def test_mccamy_fuchs_and_rim_extraction_match_lpfem(small):
    th = np.linspace(0.0, np.pi, 181)
    for ka in (np.pi, 0.5 * np.pi):
        np.testing.assert_array_equal(mccamy_fuchs_envelope(th, ka),
                                      lp_mf(th, ka))
    _, st, surl, perm = small
    vals = np.random.default_rng(6).standard_normal(surl.n_dofs)
    vals_t = np.empty_like(vals)
    vals_t[perm] = vals
    th_l, v_l = lp_extract_rim(surl.node_coords, 4.0, 0.0, 0.5, 1e-9, vals)
    th_t, v_t = extract_rim(SurfaceSpace(st).node_coords, 4.0, 0.0, 0.5,
                            1e-9, vals_t)
    assert len(th_t) == 2 * 12 + 1                  # the rim ring at p = 2
    np.testing.assert_array_equal(th_t, th_l)
    np.testing.assert_array_equal(v_t, v_l)
