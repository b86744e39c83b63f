"""The port's apply modes and the assembled operator against lpfem on the
CPU.

- ``apply_mode`` ``"fused"`` and ``"sumfact"``: the element-local apply of
  :class:`ElementLaplace` against ``lpfem.operators.LaplacePA(mode=...)`` at
  p = 1..3, on affine elements (a tank leaning along y, no lattice) and on
  curved ones (the half-cylinder tank), float64, 1e-12 relative to max|y|;
  the assembled vectors too, and the class ``laplace_operator`` picks per
  mode (lpfem's rule).
- :class:`AssembledLaplace`: ``apply`` against lpfem's at 1e-11 (the bound
  of lpfem's own ``tests/test_precond.py:70-75``), on the Kronecker lattice
  (assembled through a float64 element operator), the curved tank and the
  leaning tank; the diagonal and the constrained apply as well;
  ``gauss_seidel_host`` sweeps at 1e-12.
- One float64 step of ``pf_linear_par`` (nx = 12, order 3, Jacobi-CG on the
  assembled matrix) against lpfem's at 1e-10 of max|y|; ``assembled`` with
  ``mixed`` raises as lpfem's.
- The sharded ELL level over 2 and 4 shards against the single-device
  assembled operator (1e-12 relative), and one sharded step of the
  assembled problem against the single-device step (1e-10 of max|y|):
  lpfem's ``tests/test_shard.py:262-300``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpfem.configs import preset as lp_preset
from lpfem.operators import AssembledLaplace as LAssembled
from lpfem.operators import LaplacePA
from lpfem.problem import Problem as LProblem
from lpfem.space import H1Space as LH1Space

import lpfem_torch
from lpfem_torch import convert
from lpfem_torch.cylmesh import make_half_cylinder_tank
from lpfem_torch.experiments.leaning_tank import leaning_tank
from lpfem_torch.mesh import Mesh
from lpfem_torch.operators import (AssembledLaplace, ElementLaplace,
                                   SeparableLattice, laplace_operator)
from lpfem_torch.shard import (Partition, ShardComm, ShardedLevel,
                               ShardedProblem)
from lpfem_torch.space import H1Space

from test_torch_meshspace import TANK, to_lpfem


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _strip(m: Mesh) -> Mesh:
    return Mesh(m.verts, m.elems, m.corner_coords, m.bdr_quads, m.bdr_attrs,
                m.periodic, m.geom_nodes, m.geom_order,
                periodic_axes=m.periodic_axes)


def _mesh(geom, p):
    if geom == "affine":
        return _strip(leaning_tank(4, 2, 2, **TANK, lean="y"))
    return make_half_cylinder_tank(n_theta=8, n_r=3, nz=1, geom_order=p)


@pytest.mark.parametrize("geom", ["affine", "curved"])
@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("mode", ["fused", "sumfact"])
def test_apply_modes_match_lpfem(mode, p, geom):
    """Element-local applies on the raw numbering (lpfem's gather is then
    ``x[elem_dofs]``, in the element order of both packages), and the
    assembled vectors on the numbering each package picks."""
    m = _mesh(geom, p)
    sp, sl = (H1Space(m, p, structured=False),
              LH1Space(to_lpfem(m), p, structured=False))
    np.testing.assert_array_equal(sp.elem_dofs, sl.elem_dofs)
    op = ElementLaplace(sp, torch.float64, "cpu", mode=mode) \
        if geom == "curved" else laplace_operator(sp, torch.float64, "cpu",
                                                  mode=mode)
    assert type(op) is ElementLaplace and op.mode == mode
    assert (op.C64 is not None) == (geom == "affine")
    lop = LaplacePA(sl, dtype=jnp.float64, mode=mode)
    x = np.random.default_rng(10 * p).standard_normal(sp.n_dofs)
    xt = torch.tensor(x)
    assert _rel(op.apply_local(xt).numpy(),
                lop.apply_local(jnp.asarray(x))) < 1e-12
    assert _rel(op.apply(xt).numpy(), lop.apply(jnp.asarray(x))) < 1e-12

    sp2 = H1Space(m, p)
    op2 = laplace_operator(sp2, torch.float64, "cpu", mode=mode)
    lop2 = LaplacePA(LH1Space(to_lpfem(m), p), dtype=jnp.float64, mode=mode)
    x2 = np.random.default_rng(10 * p + 1).standard_normal(sp2.n_dofs)
    assert _rel(op2.apply(torch.tensor(x2)).numpy(),
                lop2.apply(jnp.asarray(x2))) < 1e-12


def test_operator_rule_per_mode():
    """On a separable tank ``fused`` keeps the Kronecker form (B1 on the
    card) and ``sumfact`` takes the element form; the levels of a
    p-multigrid take the fine operator's mode."""
    cfg = lpfem_torch.preset("pf_linear_par", nx=4, order=2)
    sp = lpfem_torch.Problem(cfg, device="cpu").space
    for mode, cls in (("pallas", SeparableLattice),
                      ("fused", SeparableLattice),
                      ("sumfact", ElementLaplace)):
        op = laplace_operator(sp, torch.float64, "cpu", mode=mode)
        assert type(op) is cls and op.mode == mode
    with pytest.raises(ValueError, match="unknown apply mode"):
        laplace_operator(sp, torch.float64, "cpu", mode="assembled")
    prob = lpfem_torch.Problem(lpfem_torch.preset(
        "pf_linear_par", nx=4, order=2, apply_mode="sumfact",
        precond="pmg"), device="cpu")
    assert all(lv.op.mode == "sumfact" for lv in prob.precond.levels)


def _assembled_cases(case):
    if case == "lattice":
        cfg = lpfem_torch.preset("pf_linear_par", nx=4, order=3)
        sp = lpfem_torch.Problem(cfg, device="cpu").space
        lp = LProblem(lp_preset("pf_linear_par", nx=4, order=3))
        return (laplace_operator(sp, torch.float64, "cpu"),
                LaplacePA(lp.space, dtype=jnp.float64, mode="fused"), True)
    m = (make_half_cylinder_tank(n_theta=8, n_r=3, nz=1, geom_order=3)
         if case == "curved" else leaning_tank(4, 2, 2, **TANK, lean="y"))
    sp = H1Space(m, 3)
    return (laplace_operator(sp, torch.float64, "cpu"),
            LaplacePA(LH1Space(to_lpfem(m), 3), dtype=jnp.float64,
                      mode="fused"), False)


def _lattice_perm(op, lop):
    """Port lattice index -> lpfem dof id, through the node coordinates
    (the port's LatticeSpace numbers the tank on its lattice, lpfem's
    H1Space topologically)."""
    from scipy.spatial import cKDTree
    xp = op.space.node_coords
    xl = lop.space.node_coords
    d, idx = cKDTree(xl).query(xp)
    assert d.max() < 1e-12
    return idx


@pytest.mark.parametrize("case", ["lattice", "curved", "affine"])
def test_assembled_apply_matches_lpfem(case):
    op, lop, lattice = _assembled_cases(case)
    A, Al = AssembledLaplace(op), LAssembled(lop)
    idx = _lattice_perm(op, lop) if lattice else np.arange(op.n_dofs)
    x_l = np.random.default_rng(5).standard_normal(op.n_dofs)
    x = torch.tensor(x_l[idx])
    y_l = np.asarray(Al.apply(jnp.asarray(x_l)))[idx]
    assert _rel(A.apply(x).numpy(), y_l) < 1e-11
    assert _rel(A.diag().numpy(), np.asarray(Al.diag)[idx]) < 1e-11
    assert _rel(A.apply(x).numpy(), op.apply(x).numpy()) < 1e-11
    ess = torch.as_tensor(op.space.top_plane_dofs())
    y_c = A.constrained_apply(x, ess)
    assert torch.equal(y_c, A.constrained_apply_top(x))
    assert _rel(y_c.numpy(), op.constrained_apply(x, ess).numpy()) < 1e-11
    assert A.nnz == Al._csr.nnz


def test_gauss_seidel_host_matches_lpfem():
    op, lop, _ = _assembled_cases("curved")
    A, Al = AssembledLaplace(op), LAssembled(lop)
    rng = np.random.default_rng(6)
    b, x0 = rng.standard_normal(op.n_dofs), rng.standard_normal(op.n_dofs)
    x = A.gauss_seidel_host(b, x0, sweeps=2)
    x_l = Al.gauss_seidel_host(b, x0, sweeps=2)
    assert _rel(x, x_l) < 1e-12


KW = dict(nx=12, order=3, apply_mode="assembled", precond="jacobi")


def test_pf_linear_par_assembled_step_matches_lpfem():
    lp = LProblem(lp_preset("pf_linear_par", **KW))
    pt = lpfem_torch.Problem(lpfem_torch.preset("pf_linear_par", **KW),
                             device="cpu")
    assert isinstance(pt.op_solve, AssembledLaplace)
    assert pt.fso.op_solve is pt.op_solve and pt.op.mode == "fused"
    (t_l, y_l, phi_l), _ = lp.run(n_steps=1)
    t_p, y_p, phi_p = pt.run(n_steps=1)
    pt.check_state(y_p, phi_p)
    y_c, _ = convert.state_from_lpfem(np.asarray(y_l), np.asarray(phi_l),
                                      np.asarray(lp.surf.surf_to_vol),
                                      pt.space.dof_dims)
    assert abs(t_p - float(t_l)) < 1e-15
    assert np.max(np.abs(y_p.numpy() - y_c)) < 1e-10 * np.max(np.abs(y_c))
    assert not pt.last_solver_stats.unconverged


def test_assembled_mixed_raises_like_lpfem():
    kw = dict(KW, dtype="mixed")
    with pytest.raises(ValueError, match="assembled") as e_l:
        LProblem(lp_preset("pf_linear_par", **kw))
    with pytest.raises(ValueError) as e_p:
        lpfem_torch.Problem(lpfem_torch.preset("pf_linear_par", **kw),
                            device="cpu")
    assert str(e_p.value) == str(e_l.value)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_ell_level_and_step(n):
    prob = lpfem_torch.Problem(lpfem_torch.preset("pf_linear_par", **KW),
                               device="cpu")
    sp = prob.space
    ess = np.asarray(prob.surf.surf_to_vol)
    pt = Partition(sp, n)
    lv = ShardedLevel(prob.op, pt, ess, ShardComm(n), "cpu", ell=True)
    assert lv.mode == "ell"
    x = np.random.default_rng(n).standard_normal(sp.n_dofs)
    y_ref = prob.op_solve.apply(torch.tensor(x)).numpy()
    xs = torch.tensor(pt.stack_dof(x))
    y = pt.unstack_dof(lv.apply_own(xs).numpy())
    assert _rel(y, y_ref) < 1e-12
    yc = pt.unstack_dof(lv.apply_c(xs).numpy())
    ess_t = torch.as_tensor(ess)
    assert _rel(yc, prob.op_solve.constrained_apply(torch.tensor(x),
                                                    ess_t).numpy()) < 1e-12

    sprob = ShardedProblem(prob, n)
    assert sprob.fine.mode == "ell"
    _, y1, _ = prob.run(n_steps=1)
    _, y2, phi2 = sprob.run(n_steps=1)
    sprob.check_state(y2, phi2)
    assert float((y1 - y2).abs().max()) < 1e-10 * float(y1.abs().max())
