"""The affine operators of lpfem_torch against lpfem on the CPU: the compact
metric, the plain versions of kernels B3a (``pa_apply_affine``) and B2
(``lattice_affine_apply``), the operators built on them, the element-path
multigrid transfer, the free-surface traces off the fast path, and 5-step
trajectories of the two general-mesh paths.

Meshes: the x-periodic tank with leaning elements (``x += a z``, lattice
declared: B2's mesh; ``x += a y`` through a mesh file: B3a's mesh), a finite
leaning tank, and a tank with one rotated element. Inputs come from numpy
seeds and go to both packages.

Tolerances: float64 host geometry and applies 1e-13 relative to their max
(another summation order); float32 applies 1e-5 relative (the float tolerance
of ``tests/test_lattice_kernel.py``, where lpfem's B2 runs in Pallas
interpret mode as here); diagonal, V-cycle (lpfem's lambda_max injected) and
traces 1e-12 relative; 5 RK4 steps 1e-12 absolute on values of O(1e-3)
(``tests/test_mixed.py:124``), iteration counts equal in float64.
``pa_apply_affine_kernel`` has no interpret switch, so lpfem runs its plain
``fused`` mode, which computes the same function.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpfem.configs import preset as lp_preset
from lpfem.multigrid import PMultigrid as LPMultigrid
from lpfem.operators import LaplacePA
from lpfem.operators import NodalZDerivative as LNodalZ
from lpfem.operators import affine_c6 as lp_affine_c6
from lpfem.problem import Problem as LProblem
from lpfem.space import H1Space as LH1Space
from lpfem.space import SurfaceSpace as LSurfaceSpace

import lpfem_torch
from lpfem_torch import convert
from lpfem_torch.cylmesh import make_half_cylinder_tank
from lpfem_torch.experiments.leaning_tank import (declare_lattice,
                                                  leaning_tank, shear_x)
from lpfem_torch.geometry import affine_c6
from lpfem_torch.kernels import lattice_apply as klat
from lpfem_torch.kernels import pa_apply as kpa
from lpfem_torch.mesh import (load_mfem, make_wave_tank,
                              make_wave_tank_finite, save_mfem)
from lpfem_torch.multigrid import PMultigrid, _ElementTransfer, _Transfer
from lpfem_torch.operators import (AffineLatticeLaplace, ElementLaplace,
                                   NodalZDerivative, SeparableLattice,
                                   laplace_operator)
from lpfem_torch.space import CurvedLatticeSpace, H1Space, SurfaceSpace

from test_torch_meshspace import LZ, TANK, _rotated_tank, to_lpfem

N_STEPS = 5


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _lean_y_loaded(tmp_path, nx=4):
    path = tmp_path / "lean-y.mesh"
    save_mfem(leaning_tank(nx, 2, 2, **TANK, lean="y", declare=False),
              str(path))
    return path


def _finite_lean():
    m = declare_lattice(make_wave_tank_finite(5, 2, 2, 12.0, 1.0, LZ))
    return shear_x(m, 2, 0.5 * (12.0 / 5) / (LZ / 2))


def _spaces(name, p, tmp_path):
    """(port space, lpfem space) of the named mesh at order p."""
    if name == "lean-z":
        mesh = leaning_tank(6, 2, 3, **TANK, lean="z")
    elif name == "lean-z odd":
        mesh = leaning_tank(5, 2, 3, **TANK, lean="z")
    elif name == "lean-z finite":
        mesh = _finite_lean()
    elif name == "lean-z undeclared":
        mesh = leaning_tank(6, 2, 2, **TANK, lean="z", declare=False)
    elif name == "lean-y loaded":
        mesh = load_mfem(str(_lean_y_loaded(tmp_path)))
    elif name == "plain loaded":
        path = tmp_path / "plain.mesh"
        save_mfem(make_wave_tank(4, 2, 2, **TANK), str(path))
        mesh = load_mfem(str(path))
    elif name == "rotated element":
        mesh = _rotated_tank()
    else:
        raise KeyError(name)
    cls = CurvedLatticeSpace if mesh.elem_lattice is not None else H1Space
    return cls(mesh, p), LH1Space(to_lpfem(mesh), p)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["lean-z", "lean-z finite", "lean-y loaded",
                                  "rotated element"])
def test_affine_c6_matches_lpfem(name, dtype, tmp_path):
    st, sl = _spaces(name, 2, tmp_path)
    C_t, C_l = affine_c6(st, 3, dtype), lp_affine_c6(sl, 3, dtype)
    assert C_t.shape == (st.mesh.n_elems, 6)
    assert _rel(C_t, C_l) < 1e-13
    if name.startswith("lean-z"):
        assert np.max(np.abs(C_t[:, 2])) > 0.1 * np.max(np.abs(C_t))  # xz


def test_affine_test_is_tied_to_the_dtype():
    """A corner moved by 1e-8 of the element is affine to float32's 1e-6
    and not to float64's 1e-12, in both packages; curved elements never."""
    mesh = leaning_tank(4, 2, 2, **TANK, lean="z")
    mesh.corner_coords[3, 6, 2] += 1e-8 * LZ
    st, sl = CurvedLatticeSpace(mesh, 2), LH1Space(to_lpfem(mesh), 2)
    assert affine_c6(st, 3, np.float64) is None
    assert lp_affine_c6(sl, 3, np.float64) is None
    assert _rel(affine_c6(st, 3, np.float32),
                lp_affine_c6(sl, 3, np.float32)) < 1e-13
    assert isinstance(laplace_operator(st, torch.float32, "cpu"),
                      AffineLatticeLaplace)
    op64 = laplace_operator(st, torch.float64, "cpu")
    assert type(op64) is ElementLaplace and op64.C64 is None
    cyl = CurvedLatticeSpace(make_half_cylinder_tank(
        n_theta=12, n_r=6, nz=1, geom_order=2), 2)
    assert affine_c6(cyl, 3, np.float32) is None
    with pytest.raises(ValueError, match="not affine"):
        AffineLatticeLaplace(cyl, torch.float32, "cpu")


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_plain_affine_element_apply_matches_fused(p, dtype, tol, tmp_path):
    """B3a's plain version (and the operator around it) against lpfem's
    ``fused`` mode with the compact metric ``C6``."""
    st, sl = _spaces("lean-y loaded", p, tmp_path)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    opl = LaplacePA(sl, dtype=jdt, mode="fused",
                    precision=None if dtype == torch.float64 else "highest")
    assert opl.C6 is not None and opl.lattice is None
    assert opl.column is not None
    opt = laplace_operator(st, dtype, "cpu")
    assert type(opt) is ElementLaplace and opt.C64 is not None
    x = np.random.default_rng(p).standard_normal(sl.n_dofs)
    xl, xt = jnp.asarray(x, dtype=jdt), torch.tensor(x, dtype=dtype)
    u_t = opt.gather(xt)
    assert np.array_equal(u_t.numpy(), np.asarray(opl.gather_E(xl)))
    ye_t = kpa.pa_apply_affine_reference(u_t, opt.C6, opt.w3, opt.B, opt.D)
    assert _rel(ye_t.numpy(), opl.apply_local(xl)) < tol
    assert torch.equal(ye_t, opt.apply_local(xt))
    assert _rel(opt.apply(xt).numpy(), opl.apply(xl)) < tol
    # the full-metric kernel's plain version computes the same function
    full = ElementLaplace(st, dtype, "cpu")
    assert _rel(full.apply(xt).numpy(), opt.apply(xt).numpy()) < tol


@pytest.mark.parametrize("name,p", [("lean-z", 4), ("lean-z finite", 3),
                                    ("lean-z", 2), ("lean-z", 1),
                                    ("lean-z odd", 3)])
def test_plain_lattice_apply_matches_lpfem_kernel(name, p, tmp_path):
    """B2's plain version, and the plain mirror of the kernel's two
    launches, against lpfem's B2 in Pallas interpret mode (float32, 1e-5)
    and against lpfem's float64 apply (1e-13), without and with the
    top-plane constraint."""
    st, sl = _spaces(name, p, tmp_path)
    op64 = LaplacePA(sl, dtype=jnp.float64, mode="fused")
    op32 = LaplacePA(sl, dtype=jnp.float32, mode="fused")
    op32._init_fused_lattice(force=True)          # interpret-mode pallas
    assert op32.C6r is not None and op32.sepk is None and op64.sep is None
    ess = np.asarray(LSurfaceSpace(sl, attr=2).surf_to_vol)
    assert op32.enable_top_plane_ess(ess)
    x = np.random.default_rng(10 + p).standard_normal(sl.n_dofs)
    t64 = AffineLatticeLaplace(st, torch.float64, "cpu")
    t32 = AffineLatticeLaplace(st, torch.float32, "cpu")
    x64, x32 = torch.tensor(x), torch.tensor(x, dtype=torch.float32)
    for ess_top in (False, True):
        if ess_top:
            y_l64 = op64.constrained_apply(jnp.asarray(x), jnp.asarray(ess))
            y_l32 = op32.constrained_apply(
                jnp.asarray(x, dtype=jnp.float32),
                jnp.asarray(ess.astype(np.int32)))
        else:
            op32._ess_top = False
            y_l64 = op64.apply(jnp.asarray(x))
            y_l32 = op32.apply(jnp.asarray(x, dtype=jnp.float32))
            op32._ess_top = True
        y64 = klat.lattice_affine_apply_reference(
            x64, t64.C6, t64.w3, t64.B, t64.D, st.elem_dims, st.periodic,
            ess_top)
        y32 = klat.lattice_affine_apply_reference(
            x32, t32.C6, t32.w3, t32.B, t32.D, st.elem_dims, st.periodic,
            ess_top)
        assert _rel(y64.numpy(), y_l64) < 1e-13
        assert _rel(y32.numpy(), np.asarray(y_l32)) < 1e-5
        assert _rel(y32.numpy(), y_l64) < 1e-5
        for t, y_ref, tol in ((t64, y_l64, 1e-13), (t32, y_l32, 1e-5)):
            y_m = klat.lattice_affine_apply_mirror(
                x64.to(t.dtype), t.C6, t.w3, t.B, t.D, st.elem_dims,
                st.periodic, ess_top)
            assert _rel(y_m.numpy(), np.asarray(y_ref)) < tol
        via_op = t64.constrained_apply_top(x64) if ess_top else t64.apply(x64)
        assert torch.equal(via_op, y64)
    np.testing.assert_array_equal(
        klat.lattice_elem_dofs(p, st.elem_dims, st.periodic, "cpu").numpy(),
        st.elem_dofs)


@pytest.mark.parametrize("name,p,dq", [
    *((n, p, 1) for n in ("lean-z", "lean-z odd", "lean-z finite")
      for p in (1, 2, 3, 4)),
    ("lean-z odd", 2, 2)])
def test_fold_mirror_matches_index_add_fold(name, p, dq, tmp_path):
    """The plain mirror of B2's two launches (windows, element apply, the
    fold kernel's closed-form dof -> (element, local node) map summed in
    ascending element index) against the index_add_ fold of
    ``lattice_affine_apply_reference``: float64, 1e-15 relative, with and
    without the top-plane constraint, q = p + dq. The map holds every
    E-vector value exactly once, the dofs of the top plane included."""
    st, _ = _spaces(name, p, tmp_path)
    op = AffineLatticeLaplace(st, torch.float64, "cpu", q=p + dq)
    assert op.B.shape == (p + dq, p + 1)
    args = (op.C6, op.w3, op.B, op.D, st.elem_dims, st.periodic)
    x = torch.tensor(np.random.default_rng(20 + p).standard_normal(
        op.n_dofs))
    for ess_top in (False, True):
        y_ref = klat.lattice_affine_apply_reference(x, *args, ess_top)
        y_m = klat.lattice_affine_apply_mirror(x, *args, ess_top)
        assert _rel(y_m.numpy(), y_ref.numpy()) <= 1e-15
    table = klat.fold_table(p, st.elem_dims, st.periodic, "cpu")
    assert table.shape == (op.n_dofs, 8)
    held = table[table >= 0]
    assert torch.equal(torch.sort(held).values,
                       torch.arange(st.mesh.n_elems * (p + 1) ** 3))
    counts = (table >= 0).sum(dim=1)
    ed = torch.as_tensor(st.elem_dofs)
    assert torch.equal(counts, torch.bincount(ed.reshape(-1),
                                              minlength=op.n_dofs))
    # each dof's holders in ascending element index
    elem = torch.where(table >= 0, table // (p + 1) ** 3, -1)
    for k in range(7):
        later = elem[:, k + 1:]
        assert bool(((later < 0) | (later > elem[:, k:k + 1])).all())


@pytest.mark.parametrize("form", ["apply", "constrained", "diag",
                                  "assembled", "rhs"])
@pytest.mark.parametrize("name", ["lean-z", "lean-z finite", "lean-y loaded",
                                  "rotated element"])
def test_affine_operator_forms_match_lpfem(name, form, tmp_path):
    st, sl = _spaces(name, 2, tmp_path)
    opl = LaplacePA(sl, dtype=jnp.float64, mode="fused")
    opt = laplace_operator(st, torch.float64, "cpu")
    assert opt.C64 is not None
    assert isinstance(opt, AffineLatticeLaplace) == name.startswith("lean-z")
    surl = LSurfaceSpace(sl, attr=2)
    ess = np.asarray(surl.surf_to_vol)
    x = np.random.default_rng(2).standard_normal(sl.n_dofs)
    if form == "apply":
        got, want = opt.apply(torch.tensor(x)), opl.apply(jnp.asarray(x))
    elif form == "constrained":
        got = opt.constrained_apply_top(torch.tensor(x))
        want = opl.constrained_apply(jnp.asarray(x), jnp.asarray(ess))
    elif form == "diag":
        got, want = opt.diag(), opl.diag
    elif form == "assembled":
        A_t, A_l = opt.assemble_scipy(), opl.assemble_scipy()
        got, want = A_t.toarray(), A_l.toarray()
        assert _rel(A_t @ x, opt.apply(torch.tensor(x)).numpy()) < 1e-13
    else:
        vals = np.random.default_rng(3).standard_normal(len(ess))
        b = np.random.default_rng(4).standard_normal(sl.n_dofs)
        want, xbc_l = opl.constrained_rhs(jnp.asarray(b), jnp.asarray(ess),
                                          jnp.asarray(vals))
        got, xbc_t = opt.constrained_rhs(torch.tensor(b), torch.tensor(vals),
                                         torch.tensor(ess))
        np.testing.assert_array_equal(xbc_t.numpy(), np.asarray(xbc_l))
    assert _rel(np.asarray(got), np.asarray(want)) < 1e-13


@pytest.mark.parametrize("name", ["lean-z", "lean-y loaded",
                                  "rotated element", "plain loaded"])
def test_vcycle_matches_lpfem(name, tmp_path):
    """Lattice levels take the per-axis transfer, the others the element
    path; both against lpfem's V-cycle with its lambda_max."""
    st, sl = _spaces(name, 4, tmp_path)
    opl = LaplacePA(sl, dtype=jnp.float64, mode="fused")
    ess = np.asarray(LSurfaceSpace(sl, attr=2).surf_to_vol)
    pl = LPMultigrid(opl, smooth_degree=3, ess_dofs=ess)
    pt = PMultigrid(laplace_operator(st, torch.float64, "cpu"),
                    smooth_degree=3, lmax=convert.smoother_lmax(pl))
    assert pt.orders == pl.orders == [4, 2, 1]
    want = {"lean-z": (AffineLatticeLaplace, _Transfer),
            "lean-y loaded": (ElementLaplace, _ElementTransfer),
            "rotated element": (ElementLaplace, _ElementTransfer),
            "plain loaded": (SeparableLattice, _Transfer)}[name]
    assert all(type(lv.op) is want[0] for lv in pt.levels)
    assert all(type(tr) is want[1] for tr in pt.transfers)
    for lv_t, lv_l in zip(pt.levels, pl.levels):
        np.testing.assert_array_equal(lv_t.op.space.top_plane_dofs(),
                                      np.sort(np.asarray(lv_l.ess)))
        assert _rel(lv_t.inv_diag.numpy(), lv_l.inv_diag) < 1e-12
    r = np.random.default_rng(4).standard_normal(sl.n_dofs)
    r[ess] = 0.0
    assert _rel(pt(torch.tensor(r)).numpy(), pl(jnp.asarray(r))) < 1e-12
    # the transfers alone: prolongation and its transpose
    xc = np.random.default_rng(5).standard_normal(pl.levels[1].op.n_dofs)
    assert _rel(pt.transfers[0].prolong(torch.tensor(xc)).numpy(),
                pl.prolong(0, jnp.asarray(xc))) < 1e-12
    assert _rel(pt.transfers[0].restrict(torch.tensor(r)).numpy(),
                pl.restrict(0, jnp.asarray(r))) < 1e-12


@pytest.mark.parametrize("name,fast", [
    ("lean-z", None), ("lean-z finite", None), ("lean-z undeclared", None),
    ("rotated element", None), ("lean-y loaded", "ext"),
    ("plain loaded", "struct")])
def test_traces_match_lpfem(name, fast, tmp_path):
    """The free-surface trace in lpfem's surface order: the fast layouts
    where lpfem arms them (z-columns of an extruded mesh, the planes of a
    loaded lattice), else the nodal derivative of the surface elements with
    per-element constants (lpfem's ``Jz3``) against lpfem's full path."""
    st, sl = _spaces(name, 4, tmp_path)
    zl = LNodalZ(LaplacePA(sl, dtype=jnp.float64, mode="fused"))
    surl = LSurfaceSpace(sl, attr=2)
    ess = np.asarray(surl.surf_to_vol)
    armed = zl.enable_top_trace(ess)
    assert armed == (fast is not None) and zl.Jz3 is not None
    surt = SurfaceSpace(st)
    zt = NodalZDerivative(st, torch.float64, "cpu", ess=surt.surf_to_vol)
    x = np.random.default_rng(6).standard_normal(sl.n_dofs)
    w_l = np.asarray(zl.top_trace(jnp.asarray(x)) if armed
                     else zl(jnp.asarray(x))[ess])
    w_t = zt.top_trace(torch.tensor(x)).numpy()
    perm = convert.surface_map(ess, surt.surf_to_vol)
    assert _rel(w_t[perm], w_l) < 1e-12
    if armed:
        assert zt.jz == zl._top[0] and zt.layout[0] == fast
    else:
        assert zt.jz is None and zt.Jz.shape[1:] == (1, 3)
        # only the elements under the surface are read
        assert zt.elem_dofs.shape[0] == len(surl.elem_dofs)


def _problems(path, dtype, tmp_path):
    """(lpfem problem, port problem) of path A (leaning along z, lattice
    declared, mesh passed in) or B (leaning along y, through a mesh file)."""
    kw = dict(order=4, dtype=dtype, precond="pmg", cheb_degree=4,
              cg_rtol_sq=1e-16 if dtype == "mixed" else 1e-24,
              cg_max_iter=300, nsteps=40, wave_by="wavelength",
              wave_lambda=0.5)
    if path == "A":
        mesh = leaning_tank(6, 2, 2, **TANK, lean="z")
        lp = LProblem(lp_preset("scaling_base", **kw), mesh=to_lpfem(mesh))
        lmax = convert.smoother_lmax(lp.fso._precond)
        pt = lpfem_torch.Problem(lpfem_torch.preset("scaling_base", **kw),
                                 device="cpu", lmax=lmax, mesh=mesh)
    else:
        kw.update(mesh_kind="mfem", mesh_file=str(_lean_y_loaded(tmp_path)),
                  ref_levels=1 if dtype == "float64" else 0)
        lp = LProblem(lp_preset("scaling_base", **kw))
        lmax = convert.smoother_lmax(lp.fso._precond)
        pt = lpfem_torch.Problem(lpfem_torch.preset("scaling_base", **kw),
                                 device="cpu", lmax=lmax)
    return lp, pt


@pytest.mark.parametrize("dtype", ["float64", "mixed"])
@pytest.mark.parametrize("path", ["A", "B"])
def test_general_mesh_trajectory_matches_lpfem(path, dtype, tmp_path):
    lp, pt = _problems(path, dtype, tmp_path)
    s2v = np.asarray(lp.surf.surf_to_vol)
    if path == "A":
        assert isinstance(pt.space, CurvedLatticeSpace)
        assert isinstance(pt.op, AffineLatticeLaplace)
        assert lp.op.C6 is not None and lp.op.sep is None
        assert lp.space.struct is not None and not lp.fso._zd_top
        assert pt.fso.zderiv.jz is None

        def from_l(y, phi):
            return convert.state_from_lpfem(y, phi, s2v, pt.space.dof_dims)
    else:
        assert isinstance(pt.space, H1Space) and pt.space.struct is None
        assert pt.space.extruded is not None
        assert type(pt.op) is ElementLaplace and pt.op.C64 is not None
        assert lp.op.column is not None and lp.fso._zd_top
        assert pt.fso.zderiv.layout[0] == "ext"
        convert.assert_same_numbering(lp.space, lp.surf, pt.space, pt.surf)

        def from_l(y, phi):
            return np.asarray(y), np.asarray(phi)
    assert abs(pt.wave.T - float(lp.wave.T)) < 1e-15
    y0_l, phi0_l = lp.initial_state()
    y0_t, phi0_t = pt.initial_state()
    y0_c, phi0_c = from_l(np.asarray(y0_l), np.asarray(phi0_l))
    np.testing.assert_array_equal(y0_t.numpy(), y0_c)
    np.testing.assert_array_equal(phi0_t.numpy(), phi0_c)

    (t_l, y_l, phi_l), _ = lp.run(n_steps=N_STEPS)
    t_t, y_t, phi_t = pt.run(n_steps=N_STEPS)
    pt.check_state(y_t, phi_t)
    assert abs(t_t - float(t_l)) < 1e-15
    assert not pt.last_solver_stats.unconverged
    assert not bool(lp.last_solver_stats.unconverged)
    y_c, phi_c = from_l(np.asarray(y_l), np.asarray(phi_l))
    assert np.max(np.abs(y_t.numpy() - y_c)) < 1e-12
    assert np.max(np.abs(phi_t.numpy() - phi_c)) < 1e-12
    assert pt.last_solver_stats.n_solves == 4 * N_STEPS
    if dtype == "float64":
        assert (pt.last_solver_stats.max_iters
                == int(lp.last_solver_stats.max_iters))
    for quad in (True, False):
        assert abs(pt.eta_error_inf(y_t, t_t, quad=quad)
                   - lp.eta_error_inf(y_l, t_l, quad=quad)) < 1e-12


def test_wrappers_take_plain_path_on_cpu_without_counting(tmp_path):
    st, _ = _spaces("lean-z", 2, tmp_path)
    op = AffineLatticeLaplace(st, torch.float64, "cpu")
    before = (klat.LAUNCHES, kpa.LAUNCHES_AFFINE, kpa.LAUNCHES)
    x = torch.tensor(np.random.default_rng(0).standard_normal(op.n_dofs))
    y = klat.lattice_affine_apply(x, op.C6, op.w3, op.B, op.D, st.elem_dims,
                                  st.periodic, True)
    assert torch.equal(y, klat.lattice_affine_apply_reference(
        x, op.C6, op.w3, op.B, op.D, st.elem_dims, st.periodic, True))
    u = op.gather(x)
    assert torch.equal(kpa.pa_apply_affine(u, op.C6, op.w3, op.B, op.D),
                       kpa.pa_apply_affine_reference(u, op.C6, op.w3, op.B,
                                                     op.D))
    assert (klat.LAUNCHES, kpa.LAUNCHES_AFFINE, kpa.LAUNCHES) == before
    assert before == (0, 0, 0)
    # the three-step route and the fused form are one function
    three = ElementLaplace(st, torch.float64, "cpu", C6=op.C64)
    assert _rel(three.constrained_apply_top(x).numpy(), y.numpy()) < 1e-13


def test_wrappers_reject_what_the_kernels_do_not_take(tmp_path):
    st, _ = _spaces("lean-z", 2, tmp_path)
    op = AffineLatticeLaplace(st, torch.float64, "cpu")
    x = torch.zeros(op.n_dofs, dtype=torch.float64)
    args = (op.C6, op.w3, op.B, op.D, st.elem_dims, st.periodic)
    with pytest.raises(ValueError, match="device"):
        klat.lattice_affine_apply(x.to("meta"), *args)
    with pytest.raises(ValueError, match="dofs, expected"):
        klat._check(x[:-1].contiguous(), *args)
    with pytest.raises(ValueError, match="dtype and device"):
        klat._check(x.float(), *args)
    with pytest.raises(ValueError, match="C6 of shape"):
        klat._check(x, op.C6[:-1].contiguous(), *args[1:])
    with pytest.raises(ValueError, match="w3 of shape"):
        klat._check(x, op.C6, op.w3[:-1].contiguous(), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        klat._check(x.repeat(2)[::2], *args)
    with pytest.raises(TypeError):
        klat._check(x.half(), *args)
    with pytest.raises(ValueError, match="periodic"):
        klat._check(x, *args[:5], (False, True, False))
    with pytest.raises(ValueError, match="at least 2 elements"):
        klat._check(torch.zeros(2 * 5 * 7, dtype=torch.float64),
                    op.C6[:6].contiguous(), op.w3, op.B, op.D, (1, 2, 3),
                    (True, False, False))
    u = torch.zeros(st.mesh.n_elems, 27, dtype=torch.float64)
    with pytest.raises(ValueError, match="device"):
        kpa.pa_apply_affine(u.to("meta"), op.C6, op.w3, op.B, op.D)
    with pytest.raises(ValueError, match="do not fit"):
        kpa._check("pa_apply_affine", u[:, :8].contiguous(), op.C6, op.B,
                   op.D)
    with pytest.raises(ValueError, match="w3 of shape"):
        kpa._check("pa_apply_affine", u, op.C6, op.B, op.D,
                   extra=[("w3", op.w3[:5].contiguous(), (27,))])
    with pytest.raises(ValueError, match="2 <= p\\+1"):
        kpa.check_tables("k", u, [("B", torch.zeros(12, 12, dtype=u.dtype),
                                   None),
                                  ("D", torch.zeros(12, 12, dtype=u.dtype),
                                   None)])
    with pytest.raises(ValueError, match="lattice"):
        AffineLatticeLaplace(H1Space(_rotated_tank(), 1), torch.float64,
                             "cpu")
