"""The general-mesh layer of lpfem_torch against lpfem on the CPU: mesh
generators, refinement, MFEM mesh files, the topological ``H1Space`` with its
lattice / column renumberings, the trace ``SurfaceSpace``, h-coarsening, and
the rule that picks the Laplace operator.

Small tanks (4-6 x 2 x 2-3 hexes, p = 1, 2, 4), all host NumPy, so every
comparison is exact (``assert_array_equal``) unless stated: the two packages
run the same integer and float64 computations in the same order.

The meshes (``CASES``): the x-periodic and the finite tank, a refined tank,
the tank leaning along z with and without its element lattice declared, the
tank leaning along y after a trip through a mesh file, and a tank whose top
layer holds one element with rotated connectivity (no lattice, no
extrusion: the plain topological numbering).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpfem.cylmesh import make_half_cylinder_tank as lp_cyl
from lpfem.mesh import Mesh as LMesh
from lpfem.mesh import load_mfem as lp_load
from lpfem.mesh import make_cartesian3d as lp_cart
from lpfem.mesh import make_wave_tank as lp_tank
from lpfem.mesh import make_wave_tank_finite as lp_finite
from lpfem.mesh import save_mfem as lp_save
from lpfem.multigrid import _coarsen_structured_mesh
from lpfem.operators import LaplacePA
from lpfem.space import H1Space as LH1Space
from lpfem.space import SurfaceSpace as LSurfaceSpace

from lpfem_torch import convert
from lpfem_torch.cylmesh import make_half_cylinder_tank
from lpfem_torch.experiments.leaning_tank import (declare_lattice,
                                                  leaning_tank, shear_x)
from lpfem_torch.mesh import (Mesh, load_mfem, make_cartesian3d,
                              make_wave_tank, make_wave_tank_finite,
                              save_mfem)
from lpfem_torch.operators import (AffineLatticeLaplace, ElementLaplace,
                                   SeparableLattice, laplace_operator)
from lpfem_torch.space import (CurvedLatticeSpace, H1Space, LatticeSpace,
                               SurfaceSpace, grid_lines)

LZ = 1.0 / (2.0 * np.pi)
TANK = dict(Lx=1.0, Ly=0.1, Lz=LZ)
FIELDS = ("verts", "elems", "corner_coords", "bdr_quads", "bdr_attrs",
          "periodic", "periodic_axes", "geom_order")


def to_lpfem(m: Mesh) -> LMesh:
    return LMesh(m.verts, m.elems, m.corner_coords, m.bdr_quads, m.bdr_attrs,
                 m.periodic, m.geom_nodes, m.geom_order,
                 periodic_axes=m.periodic_axes, elem_lattice=m.elem_lattice,
                 lattice_dims=m.lattice_dims)


def assert_mesh_equal(mt, ml):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(mt, f), getattr(ml, f), f)
    assert (mt.geom_nodes is None) == (ml.geom_nodes is None)


def _rotated_tank() -> Mesh:
    """The finite 4 x 2 x 2 tank with the connectivity of one top-layer
    element rotated a quarter turn about z: still conforming, but its local
    axes no longer follow the lattice, and its column no longer repeats its
    footprint, so no renumbering applies."""
    m = make_wave_tank_finite(4, 2, 2, 12.0, 1.0, LZ)
    e = m.n_elems - 3
    rot = [1, 2, 3, 0, 5, 6, 7, 4]
    elems, cc = m.elems.copy(), m.corner_coords.copy()
    elems[e], cc[e] = elems[e][rot], cc[e][rot]
    return Mesh(m.verts, elems, cc, m.bdr_quads, m.bdr_attrs)


def _loaded(mesh: Mesh, tmp_path, name: str) -> Mesh:
    path = tmp_path / name
    save_mfem(mesh, str(path))
    return load_mfem(str(path))


def _case(name: str, tmp_path) -> Mesh:
    if name == "periodic":
        return make_wave_tank(6, 2, 3, **TANK)
    if name == "finite":
        return make_wave_tank_finite(5, 2, 2, 12.0, 1.0, LZ)
    if name == "refined":
        return make_wave_tank(4, 2, 2, **TANK).uniform_refine()
    if name == "lean-z declared":
        return leaning_tank(6, 2, 2, **TANK, lean="z")
    if name == "lean-z undeclared":
        return leaning_tank(6, 2, 2, **TANK, lean="z", declare=False)
    if name == "lean-y loaded":
        return _loaded(leaning_tank(4, 2, 2, **TANK, lean="y",
                                    declare=False), tmp_path, "y.mesh")
    if name == "plain loaded":
        return _loaded(make_wave_tank(4, 2, 2, **TANK), tmp_path, "p.mesh")
    if name == "rotated element":
        return _rotated_tank()
    raise KeyError(name)


CASES = ["periodic", "finite", "refined", "lean-z declared",
         "lean-z undeclared", "lean-y loaded", "plain loaded",
         "rotated element"]
# (struct set, extruded set) that lpfem finds, and so must the port
LAYOUT = {"periodic": (True, False), "finite": (True, False),
          "refined": (True, False), "lean-z declared": (True, False),
          "lean-z undeclared": (False, True), "lean-y loaded": (False, True),
          "plain loaded": (True, False), "rotated element": (False, False)}


@pytest.mark.parametrize("gen", ["periodic", "finite", "graded"])
def test_generators_match_lpfem(gen):
    if gen == "periodic":
        mt, ml = make_wave_tank(5, 2, 3, **TANK), lp_tank(5, 2, 3, **TANK)
    elif gen == "finite":
        mt = make_wave_tank_finite(5, 2, 2, 12.0, 1.0, LZ)
        ml = lp_finite(5, 2, 2, 12.0, 1.0, LZ)
    else:
        zs = LZ * (1.0 - np.linspace(1.0, 0.0, 4) ** 2)
        mt = make_cartesian3d(4, 2, 3, 1.0, 0.1, LZ, zs=zs)
        ml = lp_cart(4, 2, 3, 1.0, 0.1, LZ, zs=zs)
        with pytest.raises(ValueError, match="strictly increasing"):
            make_cartesian3d(4, 2, 3, 1.0, 0.1, LZ, zs=zs[::-1])
    assert_mesh_equal(mt, ml)
    for a, b in zip(mt.bounding_box(), ml.bounding_box()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["periodic", "finite"])
def test_uniform_refine_matches_lpfem(kind):
    if kind == "periodic":
        mt, ml = make_wave_tank(4, 2, 2, **TANK), lp_tank(4, 2, 2, **TANK)
    else:
        mt = make_wave_tank_finite(3, 1, 2, 12.0, 1.0, LZ)
        ml = lp_finite(3, 1, 2, 12.0, 1.0, LZ)
    for _ in range(2):
        mt, ml = mt.uniform_refine(), ml.uniform_refine()
        assert_mesh_equal(mt, ml)
    assert mt.n_elems == 64 * (16 if kind == "periodic" else 6)


@pytest.mark.parametrize("kind", ["periodic", "finite", "lean-y"])
def test_mfem_file_round_trip(kind, tmp_path):
    """The file the port writes is byte for byte the file lpfem writes;
    either parser reads it into the same mesh; a periodic mesh comes back
    with its geometry and periodic axis, a plain one exactly."""
    if kind == "periodic":
        m = make_wave_tank(4, 2, 2, **TANK)
    elif kind == "finite":
        m = make_wave_tank_finite(3, 2, 2, 12.0, 1.0, LZ)
    else:
        m = leaning_tank(4, 2, 2, **TANK, lean="y", declare=False)
    pt, pl = tmp_path / "t.mesh", tmp_path / "l.mesh"
    save_mfem(m, str(pt))
    lp_save(to_lpfem(m), str(pl))
    assert pt.read_text() == pl.read_text()
    back, back_l = load_mfem(str(pt)), lp_load(str(pt))
    assert_mesh_equal(back, back_l)
    np.testing.assert_array_equal(back.elems, m.elems)
    np.testing.assert_array_equal(back.bdr_quads, m.bdr_quads)
    np.testing.assert_array_equal(back.bdr_attrs, m.bdr_attrs)
    # coordinates go through "%.16g"
    np.testing.assert_allclose(back.corner_coords, m.corner_coords,
                               rtol=0, atol=1e-15)
    assert back.periodic_axes == m.periodic_axes
    assert back.elem_lattice is None


def test_mfem_parser_rejects_what_it_does_not_read(tmp_path):
    text = "MFEM mesh v1.0\n\ndimension\n2\n"
    (tmp_path / "2d.mesh").write_text(text)
    with pytest.raises(NotImplementedError, match="3D"):
        load_mfem(str(tmp_path / "2d.mesh"))
    tet = ("MFEM mesh v1.0\n\ndimension\n3\n\nelements\n1\n1 4 0 1 2 3\n")
    (tmp_path / "tet.mesh").write_text(tet)
    with pytest.raises(NotImplementedError, match="hexes"):
        load_mfem(str(tmp_path / "tet.mesh"))


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("case", CASES)
def test_h1space_numbering_matches_lpfem(case, p, tmp_path):
    mesh = _case(case, tmp_path)
    st, sl = H1Space(mesh, p), LH1Space(to_lpfem(mesh), p)
    assert (st.struct is not None, st.extruded is not None) == LAYOUT[case]
    assert st.n_dofs == sl.n_dofs
    np.testing.assert_array_equal(st.elem_dofs, sl.elem_dofs)
    assert_mesh_equal(st.mesh, sl.mesh)             # the same element order
    if sl.struct is None:
        assert st.struct is None and st.dof_dims is None
    else:
        assert st.struct.dof_dims == sl.struct.dof_dims == st.dof_dims
        assert st.struct.elem_dims == sl.struct.elem_dims == st.elem_dims
        assert st.struct.periodic == sl.struct.periodic == st.periodic
    if sl.extruded is None:
        assert st.extruded is None
    else:
        np.testing.assert_array_equal(st.extruded.ed2d, sl.extruded.ed2d)
        assert ((st.extruded.n2d, st.extruded.Dz, st.extruded.nz)
                == (sl.extruded.n2d, sl.extruded.Dz, sl.extruded.nz))
    np.testing.assert_array_equal(st.boundary_dofs(2), sl.boundary_dofs(2))
    np.testing.assert_array_equal(st.top_plane_dofs(), sl.boundary_dofs(2))
    np.testing.assert_array_equal(st.boundary_dofs([1, 3]),
                                  sl.boundary_dofs([1, 3]))
    np.testing.assert_array_equal(st.node_mult, sl.node_mult)
    np.testing.assert_array_equal(st.node_coords, sl.node_coords)
    np.testing.assert_array_equal(st.elem_node_coords, sl.elem_node_coords)
    # the free surface, and the identity maps of lpfem_torch.convert
    ut, ul = SurfaceSpace(st), LSurfaceSpace(sl, attr=2)
    assert ut.n_dofs == ul.n_dofs
    np.testing.assert_array_equal(ut.elem_dofs, ul.elem_dofs)
    np.testing.assert_array_equal(ut.surf_to_vol, ul.surf_to_vol)
    np.testing.assert_array_equal(ut.node_coords, ul.node_coords)
    convert.assert_same_numbering(sl, ul, st, ut)
    np.testing.assert_array_equal(
        convert.surface_map(ul.surf_to_vol, ut.surf_to_vol),
        np.arange(ul.n_dofs))
    vals = np.random.default_rng(p).standard_normal(ul.n_dofs)
    fn = lambda x, y, z: np.cos(2 * np.pi * x) + y     # noqa: E731
    assert ut.max_error_quad(vals, fn) == ul.max_error_quad(vals, fn)
    np.testing.assert_array_equal(ut.project(fn), ul.project(fn))


@pytest.mark.parametrize("p", [1, 2])
def test_declared_lattice_spaces_agree(p):
    """A declared lattice through the topological space (lpfem's
    ``_renumber_from_lattice``) and through ``CurvedLatticeSpace`` gives one
    numbering; the surfaces differ by the map ``convert.surface_map``
    returns."""
    mesh = leaning_tank(6, 2, 2, **TANK, lean="z")
    sh, sc = H1Space(mesh, p), CurvedLatticeSpace(mesh, p)
    np.testing.assert_array_equal(sh.elem_dofs, sc.elem_dofs)
    assert sh.dof_dims == sc.dof_dims and sh.periodic == sc.periodic
    np.testing.assert_array_equal(sh.top_plane_dofs(), sc.top_plane_dofs())
    np.testing.assert_array_equal(sh.node_coords, sc.node_coords)
    uh, uc = SurfaceSpace(sh), SurfaceSpace(sc)
    perm = convert.surface_map(uh.surf_to_vol, uc.surf_to_vol)
    np.testing.assert_array_equal(
        perm, convert.surface_permutation(uh.surf_to_vol, sc.dof_dims))
    np.testing.assert_array_equal(uc.node_coords[perm], uh.node_coords)
    with pytest.raises(ValueError, match="same volume dofs"):
        convert.surface_map(uh.surf_to_vol - 1, uc.surf_to_vol)


def test_space_guards():
    m = make_wave_tank(1, 1, 1, **TANK)      # its x faces are one face
    with pytest.raises(ValueError, match="multiply-adjacent"):
        H1Space(m, 2)
    plain = make_wave_tank(4, 2, 2, **TANK)
    with pytest.raises(ValueError, match="no boundary faces"):
        SurfaceSpace(H1Space(plain, 1), attr=7)
    # attribute 2 elsewhere than on the top plane of a detected lattice
    moved = Mesh(plain.verts, plain.elems, plain.corner_coords,
                 plain.bdr_quads, np.where(plain.bdr_attrs == 2, 1,
                                           np.where(plain.bdr_attrs == 1, 2,
                                                    plain.bdr_attrs)),
                 plain.periodic, periodic_axes=plain.periodic_axes)
    with pytest.raises(NotImplementedError, match="top z-plane"):
        H1Space(moved, 1).top_plane_dofs()
    with pytest.raises(ValueError, match="tensor product"):
        declare_lattice(leaning_tank(4, 2, 2, **TANK, declare=False))
    with pytest.raises(ValueError, match="lean"):
        leaning_tank(4, 2, 2, **TANK, lean="x")


def test_h_coarsening_follows_lpfem(tmp_path):
    """On a Cartesian tank from a file the chain continues through merged
    meshes exactly as lpfem's; on the leaning tank lpfem's merged mesh has
    no lattice (``H1Space(mesh_c, 1).struct`` is None) and the chain stops,
    though every element dimension is even."""
    mesh = _loaded(make_wave_tank(12, 4, 4, **TANK), tmp_path, "t.mesh")
    st, sl = H1Space(mesh, 1), LH1Space(to_lpfem(mesh), 1)
    assert H1Space(mesh, 2).coarsen() is None          # only below p = 1
    for _ in range(3):
        mesh_c = _coarsen_structured_mesh(sl)
        st_c = st.coarsen()
        if mesh_c is None:
            assert st_c is None
            break
        sl = LH1Space(mesh_c, 1)
        st = st_c
        np.testing.assert_array_equal(st.elem_dofs, sl.elem_dofs)
        np.testing.assert_array_equal(st.mesh.corner_coords,
                                      sl.mesh.corner_coords)
        np.testing.assert_array_equal(
            st.top_plane_dofs(), st.n_dofs - np.arange(
                st.dof_dims[0] * st.dof_dims[1])[::-1] - 1)
    assert st.elem_dims == (3, 1, 1)

    lean = leaning_tank(8, 2, 2, **TANK, lean="z")
    sl = LH1Space(to_lpfem(lean), 1)
    assert sl.struct is not None
    assert LH1Space(_coarsen_structured_mesh(sl), 1).struct is None
    assert CurvedLatticeSpace(lean, 1).coarsen() is None
    assert H1Space(lean, 1).coarsen() is None
    # unsheared, a declared lattice coarsens like the detected one
    flat = declare_lattice(make_wave_tank(8, 2, 2, **TANK))
    c = CurvedLatticeSpace(flat, 1).coarsen()
    assert isinstance(c, H1Space) and c.elem_dims == (4, 1, 1)


def _lpfem_rule(op) -> str:
    """Which of its four applies lpfem's ``LaplacePA`` takes, with the
    fused lattice kernel enabled as on the TPU (``force=True``)."""
    op._init_fused_lattice(force=True)
    if op.sep is not None:
        return "B1"
    if op.C6r is not None:
        return "B2"
    return "B3a" if op.C6 is not None else "B3b"


def _port_rule(op) -> str:
    if isinstance(op, SeparableLattice):
        return "B1"
    if isinstance(op, AffineLatticeLaplace):
        return "B2"
    assert isinstance(op, ElementLaplace)
    return "B3a" if op.C64 is not None else "B3b"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case,rule", [
    ("periodic", "B1"), ("plain loaded", "B1"), ("refined", "B1"),
    ("lean-z declared", "B2"), ("lean-z undeclared", "B3a"),
    ("lean-y loaded", "B3a"), ("rotated element", "B3a"),
    ("cylinder", "B3b")])
def test_operator_dispatch_matches_lpfem(case, rule, dtype, tmp_path):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    if case == "cylinder":
        kw = dict(n_theta=12, n_r=6, nz=1, geom_order=2)
        st = CurvedLatticeSpace(make_half_cylinder_tank(**kw), 2)
        sl = LH1Space(lp_cyl(**kw), 2)
    else:
        mesh = _case(case, tmp_path)
        st = (CurvedLatticeSpace if mesh.elem_lattice is not None
              else H1Space)(mesh, 2)
        sl = LH1Space(to_lpfem(mesh), 2)
    assert _lpfem_rule(LaplacePA(sl, dtype=jdt, mode="fused")) == rule
    assert _port_rule(laplace_operator(st, dtype, "cpu")) == rule


def test_generated_tank_dispatch_and_spacings():
    """The generated tank needs no mesh: its ``LatticeSpace`` is rule 1, and
    the same tank as a mesh gives the same 1D bands."""
    ls = LatticeSpace((grid_lines(4, 1.0), grid_lines(2, 0.1),
                       grid_lines(2, LZ)), 2, (True, False, False))
    a = laplace_operator(ls, torch.float64, "cpu")
    b = laplace_operator(H1Space(make_wave_tank(4, 2, 2, **TANK), 2),
                         torch.float64, "cpu")
    assert isinstance(a, SeparableLattice) and isinstance(b, SeparableLattice)
    for x, y in zip(a.bands64, b.bands64):
        np.testing.assert_allclose(x, y, rtol=1e-13, atol=0)
    # a graded box lattice is separable; one sheared element is not
    zs = LZ * (1.0 - np.linspace(1.0, 0.0, 4) ** 2)
    graded = make_cartesian3d(4, 2, 3, 1.0, 0.1, LZ, zs=zs)
    assert isinstance(laplace_operator(H1Space(graded, 2), torch.float64,
                                       "cpu"), SeparableLattice)
    skew = shear_x(declare_lattice(graded), 2, 0.3)
    assert isinstance(laplace_operator(CurvedLatticeSpace(skew, 2),
                                       torch.float64, "cpu"),
                      AffineLatticeLaplace)
