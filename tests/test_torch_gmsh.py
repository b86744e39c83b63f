"""Gmsh meshes with curved rims in the port against lpfem on the CPU.

The reference's ``Meshes/mesh_cylinder_half.msh`` is not in the repository,
so every test writes its own Gmsh v2.2 file (``lpfem_torch.mesh.save_gmsh``)
from a generated tank: a finite 4 x 2 x 2 tank and the half-cylinder tank at
``n_theta = 12``, ``n_r = 4`` (48 hexes, attributes 1 bottom, 2 free
surface, 3 rim).

- The native scanner and the Python parser of the port, integer for integer
  equal to each other and to ``lpfem.mesh.load_gmsh``.
- ``set_curvature`` with the rim snapped by ``cylinder_projector``: the
  geometry nodes within 1e-14 of lpfem's, the rim nodes on the circle to
  1e-12.
- One float64 RK4 step of a ``mesh_kind="gmsh"`` Problem (order 2, Jacobi)
  within 1e-10 of max|y| of lpfem's (the same numbering: the topological
  ids with the extruded renumbering, equal to lpfem's).
- ``diffraction --gmsh`` on the CPU (order 2, two steps): the envelope
  snapshot written as a binary VTU; ``apply_bench --cylinder`` (the three
  numberings an imported mesh lands on) and ``plots`` of the rim tables.
"""

import numpy as np
import pytest

from lpfem.configs import Config as LConfig
from lpfem.mesh import cylinder_projector as lp_projector
from lpfem.mesh import load_gmsh as lp_load_gmsh
from lpfem.mesh import set_curvature as lp_set_curvature
from lpfem.problem import Problem as LProblem

import lpfem_torch
from lpfem_torch import native
from lpfem_torch.cylmesh import make_half_cylinder_tank
from lpfem_torch.experiments import apply_bench, diffraction, plots
from lpfem_torch.mesh import (cylinder_projector, load_gmsh,
                              make_wave_tank_finite, parse_gmsh_python,
                              save_gmsh, set_curvature)

H = 1.0 / (2.0 * np.pi)
CX, RADIUS = 4.0, 0.5


def _cylinder(tmp_path):
    path = tmp_path / "cyl.msh"
    save_gmsh(make_half_cylinder_tank(n_theta=12, n_r=4, nz=1, h=H, cx=CX,
                                      a=RADIUS), str(path))
    return str(path)


def _tank(tmp_path):
    path = tmp_path / "tank.msh"
    save_gmsh(make_wave_tank_finite(4, 2, 2, 12.0, 1.0, H), str(path))
    return str(path)


@pytest.mark.parametrize("make", [_tank, _cylinder])
def test_parsers_match_each_other_and_lpfem(make, tmp_path):
    path = make(tmp_path)
    nat, py = native.parse_gmsh(path), parse_gmsh_python(path)
    for a, b in zip(nat, py):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    m, ml = load_gmsh(path), lp_load_gmsh(path)
    for f in ("verts", "elems", "corner_coords", "bdr_quads", "bdr_attrs"):
        np.testing.assert_array_equal(getattr(m, f), getattr(ml, f), f)
    assert set(m.bdr_attrs.tolist()) >= {1, 2}


@pytest.mark.parametrize("pg", [2, 3])
def test_set_curvature_matches_lpfem(pg, tmp_path):
    path = _cylinder(tmp_path)
    m, ml = load_gmsh(path), lp_load_gmsh(path)
    set_curvature(m, pg, {3: cylinder_projector(CX, 0.0, RADIUS)})
    lp_set_curvature(ml, pg, {3: lp_projector(CX, 0.0, RADIUS)})
    assert m.geom_order == ml.geom_order == pg
    assert np.max(np.abs(m.geom_nodes - ml.geom_nodes)) <= 1e-14
    # the rim's geometry nodes lie on the circle (the faceted import is
    # snapped), the other boundary nodes stay where the corners put them
    r = np.hypot(m.geom_nodes[..., 0] - CX, m.geom_nodes[..., 1])
    near = np.abs(r - RADIUS) < 0.05
    assert near.any()
    assert np.max(np.abs(r[near] - RADIUS)) < 1e-12


def test_gmsh_problem_step_matches_lpfem(tmp_path):
    kw = dict(name="gmsh_tank", mesh_kind="gmsh", mesh_file=_cylinder(
        tmp_path), order=2, H=0.01, wave_by="wavelength", wave_lambda=1.0,
        kh_override=1.0, nsteps=35, t_final_periods=1.0, cg_rtol_sq=1e-24,
        cg_max_iter=600, dtype="float64", precond="jacobi")
    lp = LProblem(LConfig(**kw))
    pt = lpfem_torch.Problem(lpfem_torch.Config(**kw), device="cpu")
    np.testing.assert_array_equal(pt.space.elem_dofs, lp.space.elem_dofs)
    np.testing.assert_array_equal(pt.surf.surf_to_vol,
                                  np.asarray(lp.surf.surf_to_vol))
    (t_l, y_l, phi_l), _ = lp.run(n_steps=1)
    t_p, y_p, phi_p = pt.run(n_steps=1)
    pt.check_state(y_p, phi_p)
    y_l = np.asarray(y_l)
    assert abs(t_p - float(t_l)) < 1e-15
    assert np.max(np.abs(y_p.numpy() - y_l)) < 1e-10 * np.max(np.abs(y_l))
    assert not pt.last_solver_stats.unconverged


def test_diffraction_driver_runs_a_gmsh_mesh(tmp_path):
    out = diffraction.main([
        "--device", "cpu", "--gmsh", _cylinder(tmp_path), "--order", "2",
        "--nsteps", "2", "--periods", "0.1", "--cy", "0",
        "--out", str(tmp_path / "rim.txt"),
        "--out-exact", str(tmp_path / "exact.txt"), "--compare", ""])
    assert out["gmsh"] and out["hexes"] == 48 and out["steps"] == 2
    vtu = (tmp_path / "ParaView" / "cylinder_envelope.vtu").read_bytes()
    assert b'format="appended"' in vtu and b"eta_env" in vtu
    assert out["rim_points"] > 0 and out["pa_apply_launches"] == 0  # CPU


def test_apply_bench_cylinder_tiers():
    """The three numberings an imported mesh lands on, each timed."""
    r = apply_bench.main(["--cylinder", "--n-theta", "8", "--n-r", "3",
                          "--order", "2", "--iters", "2", "--repeats", "1",
                          "--device", "cpu"])
    for tier in ("lattice", "column", "gather"):
        assert r[f"{tier}_ms"] > 0 and r[f"{tier}_ns_per_dof"] > 0


def test_plots_of_the_diffraction_tables(tmp_path):
    pytest.importorskip("matplotlib")
    out = tmp_path / "polar.png"
    plots.main(["diffraction", "data/cylinder-diffraction.txt",
                "data/cylinder_boundary.txt", "--out", str(out)])
    assert out.stat().st_size > 0
