"""Structured H1 dof lattices: the Cartesian tank and the curved lattice.

Counterpart of the structured numberings of ``lpfem.space.H1Space``. Two
spaces share one dof layout, ``ix + Dx*(iy + Dy*iz)`` on the global GLL
lattice, and one element order, lattice-major ``ex + nex*(ey + ney*ez)``:

- :class:`LatticeSpace` (``_try_structured_renumber``): the
  ``make_cartesian3d`` / ``make_wave_tank`` box ``[0,Lx]x[0,Ly]x[0,Lz]`` after
  ``ref_levels`` uniform refinements, built straight from its grid lines,
  without the topological numbering that general meshes need (and that
  takes minutes of host time at the scaling sizes).
- :class:`CurvedLatticeSpace` (``_renumber_from_lattice``,
  ``lpfem/space.py:330-377``): a mesh whose generator declares a logical
  element lattice (``Mesh.elem_lattice``), such as the polar half-cylinder
  block of ``lpfem_torch.cylmesh``, with per-element (possibly curved)
  geometry nodes.

``SurfaceSpace`` is the free surface of either: the top z-plane, in lattice
order, with its quad elements for the quadrature-point error metric.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np

from .elements import basis_1d, lagrange_eval
from .mesh import HEX_VERTS, Mesh, trilinear_weights

__all__ = ["grid_lines", "LatticeSpace", "CurvedLatticeSpace", "SurfaceSpace"]


def grid_lines(n: int, L: float, ref_levels: int = 0) -> np.ndarray:
    """Element boundaries of ``n`` equal cells on [0, L] after
    ``ref_levels`` bisections. Midpoints are formed as ``0.5 a + 0.5 b``,
    the trilinear child-corner rule of ``lpfem.mesh.Mesh.uniform_refine``."""
    g = np.linspace(0.0, L, n + 1)
    for _ in range(ref_levels):
        out = np.empty(2 * len(g) - 1)
        out[0::2] = g
        out[1::2] = 0.5 * g[:-1] + 0.5 * g[1:]
        g = out
    return g


class LatticeSpace:
    """Order-``p`` H1 dof lattice on the tensor grid ``lines = (xs, ys, zs)``.

    Attributes: ``elem_dims (nex, ney, nez)``, ``dof_dims (Dx, Dy, Dz)``,
    ``periodic (px, py, pz)`` (only x may be periodic: the periodic tank),
    ``spacings (hx, hy, hz)`` per-element widths, ``n_dofs``.
    """

    def __init__(self, lines, p: int, periodic=(False, False, False)):
        self.lines = tuple(np.asarray(g, dtype=np.float64) for g in lines)
        self.p = int(p)
        self.periodic = tuple(bool(a) for a in periodic)
        if self.periodic[1] or self.periodic[2]:
            raise NotImplementedError("only the x axis may be periodic")
        for g in self.lines:
            if len(g) < 2 or np.any(np.diff(g) <= 0):
                raise ValueError("grid lines must be strictly increasing")
        self.elem_dims = tuple(len(g) - 1 for g in self.lines)
        self.dof_dims = tuple(n * self.p + (0 if per else 1)
                              for n, per in zip(self.elem_dims, self.periodic))
        Dx, Dy, Dz = self.dof_dims
        self.n_dofs = Dx * Dy * Dz
        self.spacings = tuple(np.diff(g) for g in self.lines)

    @classmethod
    def from_config(cls, cfg, p: int | None = None) -> "LatticeSpace":
        """The tank of ``cfg`` (``periodic_tank`` or ``finite_tank``)."""
        if cfg.mesh_kind not in ("periodic_tank", "finite_tank"):
            raise NotImplementedError(
                f"mesh_kind {cfg.mesh_kind!r}: only the generated Cartesian "
                "tanks are ported (general meshes come later)")
        lines = (grid_lines(cfg.nx, cfg.Lx, cfg.ref_levels),
                 grid_lines(cfg.ny, cfg.Ly, cfg.ref_levels),
                 grid_lines(cfg.nz, cfg.Lz, cfg.ref_levels))
        per = (cfg.mesh_kind == "periodic_tank", False, False)
        return cls(lines, cfg.order if p is None else p, per)

    def with_order(self, p: int) -> "LatticeSpace":
        """The same grid at order ``p`` (a p-multigrid level)."""
        return LatticeSpace(self.lines, p, self.periodic)

    def coarsen(self) -> "LatticeSpace | None":
        """Merge 2x2x2 element blocks (``lpfem.multigrid.
        _coarsen_structured_mesh``); None when an element dimension is odd
        or a periodic axis would drop below 3 coarse elements."""
        if any(n % 2 for n in self.elem_dims):
            return None
        if any(per and n // 2 < 3
               for n, per in zip(self.elem_dims, self.periodic)):
            return None
        return LatticeSpace(tuple(g[::2] for g in self.lines), self.p,
                            self.periodic)

    def axis_nodes(self, a: int) -> np.ndarray:
        """[D_a] coordinates of the lattice nodes along axis ``a``."""
        g, p = self.lines[a], self.p
        xi = basis_1d(p).nodes[:p]
        pts = ((1.0 - xi)[None, :] * g[:-1, None]
               + xi[None, :] * g[1:, None]).reshape(-1)
        return pts if self.periodic[a] else np.append(pts, g[-1])

    @cached_property
    def node_coords(self) -> np.ndarray:
        """[n_dofs, 3] node coordinates in lattice order (a periodic seam
        dof sits at x = 0)."""
        ax, ay, az = (self.axis_nodes(a) for a in range(3))
        Z, Y, X = np.meshgrid(az, ay, ax, indexing="ij")
        return np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def top_plane_dofs(self) -> np.ndarray:
        """Lattice dofs on the z-max plane (the tank free surface, attr 2)."""
        return _top_plane_dofs(self.dof_dims)

    def bounding_box(self) -> tuple[np.ndarray, np.ndarray]:
        return (np.array([g[0] for g in self.lines]),
                np.array([g[-1] for g in self.lines]))


def _top_plane_dofs(dof_dims) -> np.ndarray:
    Dx, Dy, Dz = dof_dims
    return Dx * Dy * (Dz - 1) + np.arange(Dx * Dy, dtype=np.int64)


# lattice-lex (x fastest) position of each MFEM hex corner
_LEX_OF_VERT = np.array([0, 1, 3, 2, 4, 5, 7, 6])


class CurvedLatticeSpace:
    """Order-``p`` H1 dof lattice over a generator-declared element lattice.

    ``mesh.elem_lattice [ne, 3]`` / ``mesh.lattice_dims (nex, ney, nez)``
    give every element's logical position, its local axes aligned with the
    lattice. Elements are reordered lattice-major and dofs numbered on the
    global GLL lattice exactly as ``lpfem.space.H1Space._renumber_from_
    lattice`` does, so the volume numbering equals lpfem's. lpfem checks the
    declared lattice against its topological numbering and falls back to
    it on a mismatch; the port has no unstructured path yet, so the corner
    vertices are checked to sit on one lattice point each and a mismatch
    raises. A mesh without a declared lattice raises NotImplementedError
    (general meshes: ROADMAP A8).

    Attributes: ``mesh`` (lattice-major), ``p``, ``elem_dims``,
    ``dof_dims``, ``periodic``, ``n_dofs``, ``elem_dofs [ne, (p+1)^3]``
    (x fastest).
    """

    def __init__(self, mesh: Mesh, p: int):
        if mesh.elem_lattice is None or mesh.lattice_dims is None:
            raise NotImplementedError(
                "the mesh declares no element lattice: general (e.g. Gmsh) "
                "meshes need the topological space port (ROADMAP A8)")
        nex, ney, nez = (int(n) for n in mesh.lattice_dims)
        el = np.asarray(mesh.elem_lattice, dtype=np.int64)
        eperm = np.argsort(el[:, 0] + nex * (el[:, 1] + ney * el[:, 2]),
                           kind="stable")
        mesh = Mesh(mesh.verts, mesh.elems[eperm], mesh.corner_coords[eperm],
                    mesh.bdr_quads, mesh.bdr_attrs, mesh.periodic,
                    None if mesh.geom_nodes is None else mesh.geom_nodes[eperm],
                    mesh.geom_order, periodic_axes=mesh.periodic_axes,
                    elem_lattice=el[eperm], lattice_dims=(nex, ney, nez))
        self.mesh = mesh
        self.p = int(p)
        self.elem_dims = (nex, ney, nez)
        self.periodic = tuple(a in mesh.periodic_axes for a in range(3))
        self.dof_dims = tuple(n * self.p + (0 if per else 1)
                              for n, per in zip(self.elem_dims, self.periodic))
        Dx, Dy, Dz = self.dof_dims
        self.n_dofs = Dx * Dy * Dz
        el = mesh.elem_lattice
        if (len(el) != nex * ney * nez or el.min() < 0
                or np.any(el.max(axis=0) >= np.array(self.elem_dims))
                or len(np.unique(el[:, 0] + nex * (el[:, 1] + ney * el[:, 2])))
                != len(el)):
            raise ValueError("elem_lattice does not tile lattice_dims once")
        self._check_corners()
        p1 = self.p + 1
        ax = np.arange(p1)
        g = [el[:, a, None] * self.p + ax for a in range(3)]
        for a in range(3):
            if self.periodic[a]:
                g[a] %= self.dof_dims[a]
        gx, gy, gz = g
        self.elem_dofs = (gx[:, None, None, :] + Dx * (
            gy[:, None, :, None] + Dy * gz[:, :, None, None])).reshape(
                len(el), p1 ** 3)

    def _check_corners(self) -> None:
        """Every vertex must sit on one lattice point in every element that
        uses it (the lattice-aligned orientation the numbering assumes)."""
        el = self.mesh.elem_lattice
        corner = el[:, None, :] + HEX_VERTS[None, :, :]          # [ne, 8, 3]
        for a in range(3):
            if self.periodic[a]:
                corner[..., a] %= self.elem_dims[a]
        key = corner[..., 0] + (self.elem_dims[0] + 1) * (
            corner[..., 1] + (self.elem_dims[1] + 1) * corner[..., 2])
        vid = self.mesh.elems.ravel()
        first = np.full(self.mesh.n_verts, -1, dtype=np.int64)
        first[vid[::-1]] = key.ravel()[::-1]
        used = np.unique(vid)
        if (not np.array_equal(first[vid], key.ravel())
                or len(np.unique(first[used])) != len(used)):
            raise ValueError("element orientation or vertex sharing does not "
                             "follow the declared lattice")

    def with_order(self, p: int) -> "CurvedLatticeSpace":
        """The same mesh and geometry at order ``p`` (a p-multigrid level)."""
        return CurvedLatticeSpace(self.mesh, p)

    def coarsen(self) -> None:
        """No h-coarsening of a curved lattice: lpfem's 2x2x2 merge would
        keep only the corners (trilinear geometry), and it never runs on the
        cylinder tank (``nez = 1`` is odd, ``lpfem/multigrid.py:195``).
        Returns None where lpfem's merge declines; raises where it would
        coarsen."""
        if any(n % 2 for n in self.elem_dims):
            return None
        raise NotImplementedError(
            "h-coarsening a curved element lattice is not ported (lpfem's "
            "merge drops the curved geometry)")

    def geometry_lattice(self) -> tuple[np.ndarray, int]:
        """(nodes [ne, (pg+1)^3, 3] lattice-lex, pg): the curved geometry
        nodes, else the trilinear corner lattice
        (``lpfem.operators._geometry_lattice``)."""
        if self.mesh.geom_nodes is not None:
            return self.mesh.geom_nodes, self.mesh.geom_order
        return self.mesh.corner_coords[:, _LEX_OF_VERT, :], 1

    @cached_property
    def elem_node_coords(self) -> np.ndarray:
        """[ne, (p+1)^3, 3] physical coordinates of every element lattice
        node (``lpfem.space.H1Space.elem_node_coords``)."""
        if self.mesh.geom_nodes is not None:
            pg = self.mesh.geom_order
            Bg, _ = lagrange_eval(basis_1d(pg).nodes, basis_1d(self.p).nodes)
            B3 = np.einsum("cz,by,ax->cbazyx", Bg, Bg, Bg).reshape(
                (self.p + 1) ** 3, (pg + 1) ** 3)
            return np.einsum("lk,ekd->eld", B3, self.mesh.geom_nodes)
        W = trilinear_weights(self.p)
        return np.einsum("lk,ekd->eld", W, self.mesh.corner_coords)

    @cached_property
    def node_coords(self) -> np.ndarray:
        """[n_dofs, 3] coordinates per dof (the first element that holds a
        shared dof gives its position, as in lpfem)."""
        X = np.zeros((self.n_dofs, 3))
        flat = self.elem_dofs.ravel()[::-1]
        X[flat] = self.elem_node_coords.reshape(-1, 3)[::-1]
        return X

    @cached_property
    def node_mult(self) -> np.ndarray:
        """[n_dofs] number of elements sharing each dof."""
        return np.bincount(self.elem_dofs.ravel(),
                           minlength=self.n_dofs).astype(np.float64)

    def top_plane_dofs(self) -> np.ndarray:
        """Lattice dofs on the z-max plane (the free surface, attr 2)."""
        return _top_plane_dofs(self.dof_dims)

    def bounding_box(self) -> tuple[np.ndarray, np.ndarray]:
        return self.mesh.bounding_box()


class SurfaceSpace:
    """The free surface of a lattice space: its top z-plane, with surface
    dof ``ix + Dx*iy`` at volume dof ``surf_to_vol[s]``. ``elem_dofs
    [nex*ney, (p+1)^2]`` are the top faces' dofs (x fastest), the surface
    elements of :meth:`max_error_quad`."""

    def __init__(self, vol):
        self.vol = vol
        self.p = vol.p
        Dx, Dy, _ = vol.dof_dims
        self.n_dofs = Dx * Dy
        self.surf_to_vol = vol.top_plane_dofs()
        self.node_coords = vol.node_coords[self.surf_to_vol]
        nex, ney, _ = vol.elem_dims
        p, ar = self.p, np.arange(self.p + 1)
        ix = (np.arange(nex)[:, None] * p + ar) % Dx            # [nex, p1]
        iy = (np.arange(ney)[:, None] * p + ar) % Dy            # [ney, p1]
        self.elem_dofs = (ix[None, :, None, :] + Dx * iy[:, None, :, None]
                          ).reshape(ney * nex, (p + 1) ** 2)

    def project(self, fn) -> np.ndarray:
        """Nodal interpolation of ``fn(x, y, z)``."""
        X = self.node_coords
        return np.asarray(fn(X[:, 0], X[:, 1], X[:, 2]), dtype=np.float64)

    def max_error_quad(self, vals, fn, q: int | None = None) -> float:
        """Max-norm error over the element integration points of an
        order-(2p+3) Gauss rule, MFEM ``GridFunction::ComputeMaxError``
        semantics (``lpfem.space.SurfaceSpace.max_error_quad``,
        ``lpfem/space.py:670-699``; the metric of
        ``Convergence_and_Scaling/convergence-parallel.cpp:269-271``). Host
        NumPy; elements of a periodic x axis that wrap the seam are unwrapped
        by the period."""
        p1 = self.p + 1
        q = q if q is not None else self.p + 2
        B = basis_1d(self.p, q).B                 # [q, p1]
        u = np.asarray(vals)[self.elem_dofs].reshape(-1, p1, p1)
        uq = np.einsum("by,ax,eyx->eba", B, B, u, optimize=True)
        X = np.asarray(self.node_coords)[self.elem_dofs].reshape(
            -1, p1, p1, 3).copy()
        bbmin, bbmax = self.vol.bounding_box()
        for d in range(3):
            if not self.vol.periodic[d]:
                continue
            L = float(bbmax[d] - bbmin[d])
            Xd = X[..., d]
            emax = Xd.max(axis=(1, 2), keepdims=True)
            Xd[Xd < emax - 0.5 * L] += L
        Xq = np.einsum("by,ax,eyxd->ebad", B, B, X, optimize=True)
        ex = fn(Xq[..., 0], Xq[..., 1], Xq[..., 2])
        return float(np.max(np.abs(uq - ex)))
