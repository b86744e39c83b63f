"""lpfem_torch's double-single outer loop (``hi_apply="ds"``) against lpfem's.

Double-single (DS) values are pairs of float32 arrays, value = hi + lo
(``lpfem.ds``). The same inputs, made from numpy seeds, go through lpfem
(JAX on the CPU) and the port (PyTorch on the CPU, where kernel B4's wrapper
takes its plain version). Tolerances, with their reasons:

- the error-free primitives run as separate eager float32 operations in
  both packages: bitwise equal. ``ds_dot_hi`` is a float32 dot, which XLA
  and PyTorch's BLAS sum in different orders: 1e-5 relative, lpfem's own
  bound (``tests/test_ds.py:113-119``);
- the DS apply against lpfem's eager XLA form: 1e-14 relative (2-norm);
  against the float64 operator: 1e-13, lpfem's contract
  (``tests/test_ds.py:59-93``); against lpfem's Pallas B4 in interpret mode
  at float64 (its structural test, ``tests/test_ds.py:156-186``; at float32
  XLA:CPU contracts it): 1e-13;
- the kernel's plain version against ``SeparableDS``'s plain path: bitwise;
- ``pcg_ir_ds``: inner iterations equal up to one per outer pass (float32
  dots summed in another order, ROADMAP C6), solutions 1e-11 relative;
- trajectories: lpfem's own tolerances (``tests/test_ds.py:104-126``), y
  within 1e-10 and phi within 1e-9, every solve converged; a chunked
  resume reproduces the unchunked y exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpfem import ds as L
from lpfem.configs import preset as lp_preset
from lpfem.kernels.sep_apply_ds import lattice_sep_apply_ds
from lpfem.operators import SeparableLattice as LSeparableLattice
from lpfem.problem import Problem as LProblem
from lpfem.problem import build_mesh as lp_build_mesh
from lpfem.solvers import pcg_ir_ds as lp_pcg_ir_ds
from lpfem.space import H1Space as LH1Space

import lpfem_torch
from lpfem_torch import convert
from lpfem_torch import ds as P
from lpfem_torch.experiments.leaning_tank import leaning_tank
from lpfem_torch.kernels.sep_apply_ds import (sep_apply_ds,
                                              sep_apply_ds_reference)
from lpfem_torch.mesh import make_wave_tank, save_mfem
from lpfem_torch.operators import SeparableLattice
from lpfem_torch.problem import Problem
from lpfem_torch.solvers import pcg_ir_ds
from lpfem_torch.space import LatticeSpace, grid_lines


def _t(a):
    return torch.tensor(np.asarray(a))


def _eq(j, t):
    return np.array_equal(np.asarray(j), t.numpy())


# ------------------------------------------------------------- primitives
def test_two_sum_bitwise_and_exact():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(1000).astype(np.float32)
    b = (rng.standard_normal(1000) * 1e-5).astype(np.float32)
    sj, ej = L.two_sum(jnp.asarray(a), jnp.asarray(b))
    s, e = P.two_sum(_t(a), _t(b))
    assert _eq(sj, s) and _eq(ej, e)
    assert np.array_equal(a.astype(np.float64) + b.astype(np.float64),
                          s.double().numpy() + e.double().numpy())


def test_two_prod_bitwise_and_exact():
    rng = np.random.default_rng(1)
    a = rng.standard_normal(1000).astype(np.float32)
    b = (rng.standard_normal(1000) * 10.0 ** rng.uniform(-8, 8, 1000)
         ).astype(np.float32)
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    pj, ej = L.two_prod_presplit(aj, bj, *L.split(aj), *L.split(bj))
    at, bt = _t(a), _t(b)
    for hj, ht in zip(L.split(aj), P.split(at)):
        assert _eq(hj, ht)
    p, e = P.two_prod_presplit(at, bt, *P.split(at), *P.split(bt))
    assert _eq(pj, p) and _eq(ej, e)
    assert np.array_equal(a.astype(np.float64) * b.astype(np.float64),
                          p.double().numpy() + e.double().numpy())


def test_fast_two_sum_bitwise():
    rng = np.random.default_rng(2)
    a = rng.standard_normal(1000).astype(np.float32)
    b = (a * rng.uniform(-1e-3, 1e-3, 1000)).astype(np.float32)
    sj, ej = L.fast_two_sum(jnp.asarray(a), jnp.asarray(b))
    s, e = P.fast_two_sum(_t(a), _t(b))
    assert _eq(sj, s) and _eq(ej, e)


def test_ds_vector_ops_bitwise():
    rng = np.random.default_rng(3)
    x64 = rng.standard_normal(4096)
    y64 = rng.standard_normal(4096) * 1e-3
    e32 = rng.standard_normal(4096).astype(np.float32)
    xj, yj = L.ds_from_f64(jnp.asarray(x64)), L.ds_from_f64(jnp.asarray(y64))
    xt, yt = P.ds_from_f64(_t(x64)), P.ds_from_f64(_t(y64))
    assert _eq(xj.hi, xt.hi) and _eq(xj.lo, xt.lo)
    assert _eq(L.ds_to_f64(xj), P.ds_to_f64(xt))
    assert np.max(np.abs(P.ds_to_f64(xt).numpy() - x64)) <= 2.0 ** -48
    for fj, ft in ((L.ds_sub(xj, yj), P.ds_sub(xt, yt)),
                   (L.ds_add_f32(xj, jnp.asarray(e32)),
                    P.ds_add_f32(xt, _t(e32))),
                   (L.ds_neg(xj), P.ds_neg(xt))):
        assert _eq(fj.hi, ft.hi) and _eq(fj.lo, ft.lo)
    d = P.ds_to_f64(P.ds_sub(xt, yt)).numpy()
    assert np.max(np.abs(d - (x64 - y64))) < 1e-13
    f = P.ds_from_f32(_t(e32))
    assert _eq(L.ds_from_f32(jnp.asarray(e32)).lo, f.lo)


def test_ds_dot_hi_and_where():
    rng = np.random.default_rng(4)
    x64 = rng.standard_normal(10000)
    xt = P.ds_from_f64(_t(x64))
    got = float(P.ds_dot_hi(xt, xt))
    want = float(np.dot(x64, x64))
    lp = float(L.ds_dot_hi(L.ds_from_f64(jnp.asarray(x64)),
                           L.ds_from_f64(jnp.asarray(x64))))
    assert abs(got - want) / want < 1e-5 and abs(got - lp) / lp < 1e-5
    c = _t(x64 > 0)
    w = P.ds_where(c, xt, P.ds_neg(xt))
    assert torch.equal(w.hi, xt.hi.abs()) and torch.equal(w.lo.abs(),
                                                          xt.lo.abs())


# ----------------------------------------------------------- the DS apply
def _spaces(periodic, p, nx=4, ny=2, nz=3):
    """(lpfem's float64 SeparableLattice, the port's LatticeSpace) of one
    small tank (periodic or finite x); the lattice numbering is the same in
    both."""
    name = "pf_linear_periodic" if periodic else "pf_linear_serial"
    kw = dict(nx=nx, ny=ny, nz=nz, order=p, ref_levels=0)
    sep = LSeparableLattice.build(
        LH1Space(lp_build_mesh(lp_preset(name, **kw)), p), p + 1,
        jnp.float64)
    return sep, LatticeSpace.from_config(lpfem_torch.preset(name, **kw))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("periodic", [True, False])
def test_separable_ds_matches_lpfem_and_f64(periodic, p):
    sep_l, space = _spaces(periodic, p)
    ds_l = L.SeparableDS(sep_l)
    op = SeparableLattice(space, torch.float64, "cpu")
    ds_p = P.SeparableDS(op)
    x64 = np.random.default_rng(5 + p).standard_normal(space.n_dofs)
    xj, xt = L.ds_from_f64(jnp.asarray(x64)), P.ds_from_f64(_t(x64))
    for ess in (False, True):
        yl = np.asarray(L.ds_to_f64(ds_l.constrained_apply_top(xj) if ess
                                    else ds_l.apply(xj)))
        yp = P.ds_to_f64(ds_p.constrained_apply_top(xt) if ess
                         else ds_p.apply(xt)).numpy()
        y64 = (op.constrained_apply_top(_t(x64)) if ess
               else op.apply(_t(x64))).numpy()
        assert _rel(yp, yl) <= 1e-14, (ess, _rel(yp, yl))
        assert _rel(yp, y64) <= 1e-13 and _rel(yl, y64) <= 1e-13


@pytest.mark.parametrize("ess_top", [False, True])
@pytest.mark.parametrize("periodic", [True, False])
def test_separable_ds_matches_lpfem_pallas_kernel(periodic, ess_top):
    """lpfem's B4 in interpret mode at float64 (its structural test)."""
    sep_l, space = _spaces(periodic, 2, ny=1, nz=2)
    kds = L.SeparableDS(sep_l, q=3, use_kernel="interpret")
    k = kds._kern
    x64 = np.random.default_rng(7).standard_normal(space.n_dofs)
    xj = L.ds_from_f64(jnp.asarray(x64))
    yh, yl = lattice_sep_apply_ds(
        xj.hi, xj.lo, kds._kcx, kds._kcy, kds._kzt, p=sep_l.p,
        dims=k["dims"], periodic=k["periodic"], ess_top=ess_top,
        interpret=True, dtype=jnp.float64)
    y_pallas = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    ds_p = P.SeparableDS(SeparableLattice(space, torch.float64, "cpu"))
    xt = P.ds_from_f64(_t(x64))
    yp = P.ds_to_f64(ds_p.constrained_apply_top(xt) if ess_top
                     else ds_p.apply(xt)).numpy()
    assert _rel(yp, y_pallas) <= 1e-13


@pytest.mark.parametrize("ess_top", [False, True])
@pytest.mark.parametrize("periodic,nx,p", [(True, 6, 1), (True, 5, 1),
                                           (True, 4, 2), (False, 5, 2),
                                           (False, 3, 3)])
def test_kernel_plain_version_is_separable_ds_bitwise(periodic, nx, p,
                                                      ess_top):
    """``sep_apply_ds_reference`` (the kernel's form) against
    ``SeparableDS``'s plain path (lpfem's form), odd Dx included; and the
    wrapper takes the plain version on a CPU tensor."""
    space = LatticeSpace((grid_lines(nx, 1.0), grid_lines(2, 0.1),
                          grid_lines(3, 0.2)), p, (periodic, False, False))
    ds_p = P.SeparableDS(SeparableLattice(space, torch.float64, "cpu"))
    x64 = np.random.default_rng(nx + p).standard_normal(space.n_dofs)
    x64 *= 10.0 ** np.random.default_rng(1).uniform(-4, 4, space.n_dofs)
    x = P.ds_from_f64(_t(x64))
    y = (ds_p.constrained_apply_top(x) if ess_top else ds_p.apply(x))
    sh = space.dof_dims[::-1]
    for fn in (sep_apply_ds_reference, sep_apply_ds):
        r = fn(x.hi.view(sh), x.lo.view(sh), ds_p.bands, space.periodic,
               ess_top)
        assert torch.equal(r.hi.reshape(-1), y.hi)
        assert torch.equal(r.lo.reshape(-1), y.lo)


# ------------------------------------------------------------- pcg_ir_ds
def test_pcg_ir_ds_matches_lpfem(monkeypatch):
    """To r.z <= rz0*1e-20: at the protocol's 1e-16 the residual is 1e-8
    of the first, and two valid solutions of this random system differ by
    ~3e-10."""
    kw = dict(nx=4, nz=2, order=3, dtype="mixed", hi_apply="ds")
    lp = LProblem(lp_preset("pf_linear_periodic", **kw))
    prob = Problem(lpfem_torch.preset("pf_linear_periodic", **kw), "cpu")
    ess = np.asarray(lp.surf.surf_to_vol)
    rng = np.random.default_rng(9)
    b64 = rng.standard_normal(prob.space.n_dofs)
    x64 = 0.1 * rng.standard_normal(prob.space.n_dofs)
    x64[ess] = b64[ess]
    res_l = lp_pcg_ir_ds(
        lp.fso._ds_op.constrained_apply_top,
        lambda v: lp.op.constrained_apply(v, lp.fso.ess),
        L.ds_from_f64(jnp.asarray(b64)), L.ds_from_f64(jnp.asarray(x64)),
        precond_lo=lp.fso._precond, rtol_sq=1e-20, max_outer=6,
        inner_rtol_sq=1e-8, inner_max_iter=400)
    passes = []
    inner_pcg = lpfem_torch.solvers.pcg

    def counting_pcg(*args, **kwargs):
        passes.append(1)
        return inner_pcg(*args, **kwargs)

    monkeypatch.setattr(lpfem_torch.solvers, "pcg", counting_pcg)
    fso = prob.fso
    res_p = pcg_ir_ds(fso._ds_op.constrained_apply_top,
                      fso.op.constrained_apply_top,
                      P.ds_from_f64(_t(b64)), P.ds_from_f64(_t(x64)),
                      precond_lo=fso._precond, rtol_sq=1e-20, max_outer=6,
                      inner_rtol_sq=1e-8, inner_max_iter=400)
    assert isinstance(res_p.x, P.DS) and len(passes) >= 3
    assert abs(res_p.iters - int(res_l.iters)) <= len(passes)
    assert float(res_p.rz) <= float(res_p.rz0) * np.float32(1e-20)
    xl = np.asarray(L.ds_to_f64(res_l.x))
    assert _rel(P.ds_to_f64(res_p.x).numpy(), xl) <= 1e-11


# ---------------------------------------------------------- trajectories
@pytest.mark.parametrize("name,kw", [
    ("pf_linear_periodic", dict(nx=4, nz=2, order=3)),
    ("pf_linear_serial", dict(nx=8, ref_levels=0, order=2,
                              t_final_periods=1.0 / 200, cg_rtol_sq=1e-20)),
])
def test_ds_trajectory_matches_lpfem_and_f64_outer(name, kw):
    """The finite tank with relaxation zones is held at r.z <= rz0*1e-20:
    at its preset's 1e-24 the DS residual floor stalls a solve just above
    the threshold (``lpfem/surface.py:210-216``), in lpfem as here."""
    kw = dict(kw, nsteps=4, dtype="mixed")
    lp = LProblem(lp_preset(name, hi_apply="ds", **kw))
    (t_l, y_l, phi_l), _ = lp.run(jit=False)
    p64 = Problem(lpfem_torch.preset(name, hi_apply="f64", **kw), "cpu")
    pds = Problem(lpfem_torch.preset(name, hi_apply="ds", **kw), "cpu")
    assert pds.fso._ds_op is not None and p64.fso._ds_op is None
    t1, y1, phi1 = p64.run()
    t2, y2, phi2 = pds.run()
    pds.check_state(y2, phi2)
    assert isinstance(phi2, P.DS) and phi2.hi.dtype == torch.float32
    assert not pds.last_solver_stats.unconverged
    assert not bool(lp.last_solver_stats.unconverged)
    y_c, phi_c = convert.state_from_lpfem(
        y_l, (phi_l.hi, phi_l.lo), np.asarray(lp.surf.surf_to_vol),
        pds.space.dof_dims)
    assert np.max(np.abs(y2.numpy() - y_c)) < 1e-10
    assert float((y2 - y1).abs().max()) < 1e-10
    phi_ds = P.ds_to_f64(phi2).numpy()
    assert np.max(np.abs(phi_ds - (phi_c[0].astype(np.float64)
                                   + phi_c[1]))) < 1e-9
    assert np.max(np.abs(phi_ds - phi1.numpy())) < 1e-9
    # a chunked resume threads the DS carry through unchanged
    ta, ya, pa = pds.run(n_steps=2)
    tb, yb, pb = pds.run(n_steps=2, t0=ta, state=(ya, pa))
    assert torch.equal(yb, y2)


# ------------------------------------------------------- the hi_apply rule
def test_hi_apply_rule():
    kw = dict(nx=4, nz=2, order=2, nsteps=2, dtype="mixed")
    for rtol in (1e-24, 1e-16):
        auto = Problem(lpfem_torch.preset("pf_linear_periodic",
                                          cg_rtol_sq=rtol, **kw), "cpu")
        assert auto.fso._ds_op is None          # float64 outer off a TPU
        ds = Problem(lpfem_torch.preset("pf_linear_periodic", hi_apply="ds",
                                        cg_rtol_sq=rtol, **kw), "cpu")
        assert ds.fso._ds_op is not None
    with pytest.raises(ValueError, match="hi_apply='ds' needs"):
        Problem(lpfem_torch.preset("pf_linear_periodic", hi_apply="ds",
                                   **dict(kw, dtype="float64")), "cpu")


def test_hi_apply_ds_refuses_the_leaning_tank():
    """The leaning tank's operator is the affine lattice form (B2), not the
    Kronecker one."""
    cfg = lpfem_torch.preset("scaling_base", nx=6, ny=2, nz=2, order=2,
                             dtype="mixed", hi_apply="ds",
                             wave_by="wavelength", wave_lambda=0.5)
    mesh = leaning_tank(6, 2, 2, 1.0, 0.1, 1 / (2 * np.pi))
    with pytest.raises(ValueError, match="hi_apply='ds' needs"):
        Problem(cfg, "cpu", mesh=mesh)


def test_hi_apply_ds_engages_on_a_mesh_file(tmp_path):
    """The plain tank through an MFEM mesh file runs B1, so DS engages, in
    lpfem as here."""
    path = tmp_path / "tank.mesh"
    save_mfem(make_wave_tank(4, 1, 2, 1.0, 0.1, 1 / (2 * np.pi)), str(path))
    kw = dict(mesh_kind="mfem", mesh_file=str(path), order=2, nsteps=2,
              dtype="mixed", hi_apply="ds")
    assert LProblem(lp_preset("pf_linear_periodic", **kw)).fso._ds_op \
        is not None
    prob = Problem(lpfem_torch.preset("pf_linear_periodic", **kw), "cpu")
    assert prob.fso._ds_op is not None
    _, y, phi = prob.run(n_steps=1)
    prob.check_state(y, phi)
    assert isinstance(phi, P.DS) and not prob.last_solver_stats.unconverged


# ------------------------------------ step_fn, zero_state, w_error_inf
def test_step_fn_zero_state_w_error_match_lpfem():
    kw = dict(nx=4, nz=2, order=3, nsteps=8, dtype="mixed", hi_apply="ds")
    lp = LProblem(lp_preset("pf_linear_periodic", **kw))
    prob = Problem(lpfem_torch.preset("pf_linear_periodic", **kw), "cpu")
    s2v = np.asarray(lp.surf.surf_to_vol)
    dims = prob.space.dof_dims
    for a, b in zip(lp.zero_state(), prob.zero_state()):
        assert a.shape == tuple(b.shape) and not bool(b.any())
        assert b.dtype == torch.float64
    y0_l, phi0_l = lp.initial_state()
    # lpfem's step keeps its scan carry's type: give it the DS pair
    y_l, phi_l = lp.step_fn()(0.0, y0_l, L.ds_from_f64(phi0_l))
    assert isinstance(phi_l, L.DS)
    y0, phi0 = prob.initial_state()
    y_p, phi_p = prob.step_fn()(0.0, y0, phi0)
    assert isinstance(phi_p, P.DS)
    y_c, phi_c = convert.state_from_lpfem(y_l, (phi_l.hi, phi_l.lo), s2v,
                                          dims)
    assert np.max(np.abs(y_p.numpy() - y_c)) < 1e-10
    phi_lf = phi_c[0].astype(np.float64) + phi_c[1]
    assert np.max(np.abs(P.ds_to_f64(phi_p).numpy() - phi_lf)) < 1e-9
    # the metric on the same DS state (lpfem's pair) and on float64
    t = prob.dt
    phi_same = P.DS(_t(phi_c[0]), _t(phi_c[1]))
    for pl, pp in ((phi_l, phi_same),
                   (L.ds_to_f64(phi_l), P.ds_to_f64(phi_same))):
        e_l = lp.w_error_inf(pl, t)
        e_p = prob.w_error_inf(pp, t)
        assert e_l > 0 and abs(e_p - e_l) <= 1e-12 * max(1.0, e_l), (e_p,
                                                                     e_l)
    # the state round trip back to lpfem's order keeps the pair
    y_b, phi_b = convert.state_to_lpfem(y_c, phi_c, s2v, dims)
    assert np.array_equal(y_b, np.asarray(y_l))
    assert np.array_equal(phi_b[0], np.asarray(phi_l.hi))


def test_w_error_inf_general_space_matches_lpfem(tmp_path):
    """The nodal z-derivative's general path (a mesh file: the
    topological space, every element's derivative folded)."""
    path = tmp_path / "tank.mesh"
    save_mfem(leaning_tank(4, 1, 2, 1.0, 0.1, 1 / (2 * np.pi), lean="y",
                           declare=False), str(path))
    kw = dict(mesh_kind="mfem", mesh_file=str(path), order=2, nsteps=2,
              wave_by="wavelength", wave_lambda=0.5)
    lp = LProblem(lp_preset("pf_linear_periodic", **kw))
    prob = Problem(lpfem_torch.preset("pf_linear_periodic", **kw), "cpu")
    phi = np.random.default_rng(11).standard_normal(prob.space.n_dofs)
    e_l = lp.w_error_inf(jnp.asarray(phi), 0.3)
    e_p = prob.w_error_inf(_t(phi), 0.3)
    assert abs(e_p - e_l) <= 1e-12 * e_l, (e_p, e_l)
