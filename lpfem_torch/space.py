"""H1 spaces: the structured dof lattices and the topological numbering.

Counterpart of ``lpfem.space``. Three volume spaces share one interface
(``p``, ``n_dofs``, ``elem_dofs``, ``dof_dims`` / ``elem_dims`` (None without
a lattice), ``periodic``, ``extruded``, ``top_plane_dofs()``, ``node_coords``,
``node_mult``, ``project(fn)``, ``with_order(p)``, ``coarsen()``,
``geometry_lattice()``, ``bounding_box()``). On a lattice the dof layout is
``ix + Dx*(iy + Dy*iz)`` on the global GLL lattice and the element order
lattice-major ``ex + nex*(ey + ney*ez)``:

- :class:`LatticeSpace` serves the generated Cartesian tanks of lpfem
  (``make_wave_tank`` / ``make_wave_tank_finite`` after ``ref_levels``
  refinements, what ``H1Space._try_structured_renumber`` detects): built
  straight from the grid lines of the configuration, no mesh, no topological
  numbering (which takes minutes of host time at the scaling sizes).
- :class:`CurvedLatticeSpace` serves lpfem's meshes with a generator-declared
  element lattice (``Mesh.elem_lattice``; ``H1Space._renumber_from_lattice``):
  the polar half-cylinder block of ``lpfem_torch.cylmesh`` and sheared
  tanks; integer arithmetic only, any per-element geometry.
- :class:`H1Space` serves every other mesh (MFEM mesh files, refined
  meshes): lpfem's topological numbering (vertex / edge / face / interior
  dofs with orientation canonicalisation), renumbered onto the lattice when
  the mesh is a Cartesian tensor product (``struct``) or onto vertical
  columns when it is z-extruded (``extruded``), exactly as lpfem does, so
  its volume numbering equals lpfem's.

:class:`SurfaceSpace` is the free surface: on the first two the top z-plane
in lattice order, on an :class:`H1Space` lpfem's trace space over the
boundary quads with attribute 2 (same surface numbering as lpfem).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from .elements import basis_1d, lagrange_eval
from .mesh import HEX_EDGES, HEX_FACES, HEX_VERTS, Mesh, trilinear_weights

__all__ = ["grid_lines", "LatticeSpace", "CurvedLatticeSpace", "H1Space",
           "SurfaceSpace", "ExtrudedInfo", "StructuredInfo", "build_hex_dofs",
           "build_quad_dofs"]


class _NodalProjection:
    """``project`` for any space with ``node_coords``."""

    def project(self, fn) -> np.ndarray:
        """Nodal interpolation of ``fn(x, y, z)`` (MFEM
        ``ProjectCoefficient``; ``lpfem/space.py:614-617``)."""
        X = self.node_coords
        return np.asarray(fn(X[:, 0], X[:, 1], X[:, 2]), dtype=np.float64)


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


class LatticeSpace(_NodalProjection):
    """Order-``p`` H1 dof lattice on the tensor grid ``lines = (xs, ys, zs)``.

    Attributes: ``elem_dims (nex, ney, nez)``, ``dof_dims (Dx, Dy, Dz)``,
    ``periodic (px, py, pz)`` (only x may be periodic: the periodic tank),
    ``spacings (hx, hy, hz)`` per-element widths, ``n_dofs``.
    """

    extruded = None

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
                f"mesh_kind {cfg.mesh_kind!r}: a lattice space holds the "
                "generated Cartesian tanks; other meshes go through H1Space")
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

    # The element tables below serve the error norms and the VTU output
    # (lpfem's H1Space of the same tank has the same element order and
    # numbering); the operators and the time loop never build them.
    @cached_property
    def elem_dofs(self) -> np.ndarray:
        """[ne, (p+1)^3] int64: each element's dofs, x fastest, the
        elements lattice-major."""
        p1 = self.p + 1
        g = [(np.arange(n)[:, None] * self.p + np.arange(p1)) % D
             for n, D in zip(self.elem_dims, self.dof_dims)]
        Dx, Dy, _ = self.dof_dims
        gx, gy, gz = g
        ed = (gx[None, None, :, None, None, :]
              + Dx * (gy[None, :, None, None, :, None]
                      + Dy * gz[:, None, None, :, None, None]))
        return ed.reshape(-1, p1 ** 3)

    def geometry_lattice(self) -> tuple[np.ndarray, int]:
        """(corners [ne, 8, 3] lattice-lex, 1): the boxes' corners (a
        periodic seam element ends at x = Lx)."""
        lo_hi = [np.stack([g[:-1], g[1:]], axis=1) for g in self.lines]
        nex, ney, nez = self.elem_dims
        X = np.broadcast_to(lo_hi[0][None, None, :, None, None, :],
                            (nez, ney, nex, 2, 2, 2))
        Y = np.broadcast_to(lo_hi[1][None, :, None, None, :, None],
                            (nez, ney, nex, 2, 2, 2))
        Z = np.broadcast_to(lo_hi[2][:, None, None, :, None, None],
                            (nez, ney, nex, 2, 2, 2))
        return np.stack([X, Y, Z], axis=-1).reshape(-1, 8, 3), 1

    @cached_property
    def elem_node_coords(self) -> np.ndarray:
        """[ne, (p+1)^3, 3] element node coordinates, trilinear from the
        corners as ``H1Space.elem_node_coords``."""
        corners = self.geometry_lattice()[0][:, _LEX_OF_VERT, :]
        return np.einsum("lk,ekd->eld", trilinear_weights(self.p), corners)


def _top_plane_dofs(dof_dims) -> np.ndarray:
    Dx, Dy, Dz = dof_dims
    return Dx * Dy * (Dz - 1) + np.arange(Dx * Dy, dtype=np.int64)


# lattice-lex (x fastest) position of each MFEM hex corner
_LEX_OF_VERT = np.array([0, 1, 3, 2, 4, 5, 7, 6])


class CurvedLatticeSpace(_NodalProjection):
    """Order-``p`` H1 dof lattice over a generator-declared element lattice.

    ``mesh.elem_lattice [ne, 3]`` / ``mesh.lattice_dims (nex, ney, nez)``
    give every element's logical position, its local axes aligned with the
    lattice. Elements are reordered lattice-major and dofs numbered on the
    global GLL lattice exactly as ``lpfem.space.H1Space._renumber_from_
    lattice`` does, so the volume numbering equals lpfem's. lpfem checks the
    declared lattice against its topological numbering and falls back to
    it on a mismatch; here the corner vertices are checked to sit on one
    lattice point each and a mismatch raises. A mesh without a declared
    lattice belongs to :class:`H1Space`.

    Attributes: ``mesh`` (lattice-major), ``p``, ``elem_dims``,
    ``dof_dims``, ``periodic``, ``n_dofs``, ``elem_dofs [ne, (p+1)^3]``
    (x fastest).
    """

    extruded = None

    def __init__(self, mesh: Mesh, p: int):
        if mesh.elem_lattice is None or mesh.lattice_dims is None:
            raise ValueError("the mesh declares no element lattice: use "
                             "H1Space for it")
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

    def coarsen(self) -> "H1Space | None":
        """The p=1 space on the 2x2x2 merged mesh, where lpfem's
        h-coarsening continues (:func:`_coarsen_structured`); None where it
        stops — the merged mesh declares no lattice, so this is None unless
        its elements are axis-aligned boxes."""
        return _coarsen_structured(self)

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
        return _elem_node_coords(self.mesh, self.p)

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


def _elem_node_coords(mesh: Mesh, p: int) -> np.ndarray:
    """[ne, (p+1)^3, 3] element node coordinates: the curved geometry nodes
    interpolated to the order-``p`` lattice, else trilinear from the
    corners."""
    if mesh.geom_nodes is not None:
        pg = mesh.geom_order
        Bg, _ = lagrange_eval(basis_1d(pg).nodes, basis_1d(p).nodes)
        B3 = np.einsum("cz,by,ax->cbazyx", Bg, Bg, Bg).reshape(
            (p + 1) ** 3, (pg + 1) ** 3)
        return np.einsum("lk,ekd->eld", B3, mesh.geom_nodes)
    return np.einsum("lk,ekd->eld", trilinear_weights(p), mesh.corner_coords)


def _coarsen_structured(space) -> "H1Space | None":
    """The p=1 :class:`H1Space` on the 2x2x2 merged mesh of a lattice space
    (``lpfem.multigrid._coarsen_structured_mesh`` and the checks of its
    h-coarsening loop, ``lpfem/multigrid.py:338-346``). None where lpfem
    stops: an odd element dimension, a periodic axis below 3 coarse
    elements, or a merged mesh on which no lattice is detected (the merged
    mesh declares none, so sheared and curved lattices stop here) or whose
    p=2 lattice differs from the fine p=1 one."""
    nex, ney, nez = space.elem_dims
    if space.p != 1 or nex % 2 or ney % 2 or nez % 2:
        return None
    if any(per and n // 2 < 3
           for n, per in zip(space.elem_dims, space.periodic)):
        return None
    mesh = space.mesh
    elems = mesh.elems.reshape(nez, ney, nex, 8)
    cc = mesh.corner_coords.reshape(nez, ney, nex, 8, 3)
    cE = np.zeros((nez // 2, ney // 2, nex // 2, 8), dtype=np.int64)
    cC = np.zeros((nez // 2, ney // 2, nex // 2, 8, 3))
    for v, (vx, vy, vz) in enumerate(HEX_VERTS):
        cE[..., v] = elems[vz::2, vy::2, vx::2, v]
        cC[..., v, :] = cc[vz::2, vy::2, vx::2, v, :]
    cE = cE.reshape(-1, 8)
    used = np.unique(cE)
    remap = np.full(mesh.n_verts, -1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    mesh_c = Mesh(verts=mesh.verts[used], elems=remap[cE],
                  corner_coords=cC.reshape(-1, 8, 3),
                  bdr_quads=np.zeros((0, 4), dtype=np.int64),
                  bdr_attrs=np.zeros(0, dtype=np.int64),
                  periodic=mesh.periodic, periodic_axes=mesh.periodic_axes)
    sp_c = H1Space(mesh_c, 1)
    if sp_c.struct is None:
        return None
    hs = H1Space(mesh_c, 2)
    if (hs.struct is None or hs.struct.dof_dims != space.dof_dims
            or hs.n_dofs != space.n_dofs):
        return None
    return sp_c


QUAD_VERTS = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.int64)
QUAD_EDGES = np.array([[0, 1], [1, 2], [2, 3], [3, 0]], dtype=np.int64)


def _canonical_uv(r, s, p, k, fwd):
    """Map face-interior lattice coords (r, s) to the canonical frame.

    The canonical frame is anchored at the face corner with the smallest
    global vertex id, first axis toward its smaller-id neighbor. Both elements
    adjacent to a face agree on it, so face dofs are shared consistently
    regardless of local orientation (the analogue of MFEM's face-orientation
    DofTransformation machinery, but for tensor-product H1 it is a pure
    index permutation).

    k:   [n] argmin position of the corner cycle (0..3)
    fwd: [n] bool, True if the forward cycle neighbor has the smaller id
    """
    u_f = np.choose(k, [np.full_like(k, r), np.full_like(k, s),
                        np.full_like(k, p - r), np.full_like(k, p - s)])
    v_f = np.choose(k, [np.full_like(k, s), np.full_like(k, p - r),
                        np.full_like(k, p - s), np.full_like(k, r)])
    u = np.where(fwd, u_f, v_f)
    v = np.where(fwd, v_f, u_f)
    return u, v


NATIVE_MIN_ENTRIES = 2_000_000   # ne (p+1)^3 above which numbering is native


def build_hex_dofs(elems: np.ndarray, n_verts: int, p: int):
    """Global H1 dof numbering on a conforming hex mesh: NumPy up to
    ``NATIVE_MIN_ENTRIES`` E-vector entries, above it the native library
    (:func:`lpfem_torch.native.build_hex_dofs`, edge and face ids in
    first-encounter order), as lpfem switches.

    Returns ``(elem_dofs [ne, (p+1)^3] int64 in lattice-lex order (x fastest),
    n_dofs, face_info)`` where ``face_info = (uniq_faces, face_id [ne, 6])``
    for boundary lookups.
    """
    ne = elems.shape[0]
    p1 = p + 1

    def lat(ix, iy, iz):
        return ix + p1 * (iy + p1 * iz)

    # unique faces (always needed, for boundary lookup)
    f_quads = elems[:, HEX_FACES]                          # [ne, 6, 4]
    uniq_f, inv_f = np.unique(np.sort(f_quads, axis=2).reshape(-1, 4),
                              axis=0, return_inverse=True)
    face_id = inv_f.reshape(ne, 6)
    nF = len(uniq_f)

    # A face shared by more than two element-face slots, or twice by the
    # same element, makes the vertex-keyed topological numbering merge
    # distinct dofs (at p >= 2) — e.g. a periodic axis with fewer than 3
    # elements, which MFEM's MakePeriodic forbids for the same reason.
    fcount = np.bincount(inv_f, minlength=nF)
    fsort = np.sort(face_id, axis=1)
    if p >= 2 and (fcount.max() > 2
                   or np.any(fsort[:, 1:] == fsort[:, :-1])):
        raise ValueError(
            "mesh has multiply-adjacent faces (e.g. a periodic axis with "
            "fewer than 3 elements); H1 dof numbering would merge distinct "
            "dofs at p >= 2")

    # lpfem's rule (``lpfem/space.py:90-96``): the native numbering above
    # NATIVE_MIN_ENTRIES E-vector entries (the same sharing, ids permuted)
    if ne * p1 ** 3 > NATIVE_MIN_ENTRIES:
        from .native import build_hex_dofs as native_hex_dofs
        elem_dofs, n_dofs = native_hex_dofs(elems, n_verts, p)
        return elem_dofs, n_dofs, (uniq_f, face_id)

    elem_dofs = np.zeros((ne, p1 ** 3), dtype=np.int64)
    for v, (vx, vy, vz) in enumerate(HEX_VERTS):
        elem_dofs[:, lat(vx * p, vy * p, vz * p)] = elems[:, v]

    n_dofs = n_verts
    if p >= 2:
        e_pairs = elems[:, HEX_EDGES]                      # [ne, 12, 2]
        uniq_e, inv_e = np.unique(np.sort(e_pairs, axis=2).reshape(-1, 2),
                                  axis=0, return_inverse=True)
        edge_id = inv_e.reshape(ne, 12)
        flip_e = e_pairs[:, :, 0] > e_pairs[:, :, 1]
        nE = len(uniq_e)

        for ei, (a, b) in enumerate(HEX_EDGES):
            c0 = HEX_VERTS[a] * p
            d = HEX_VERTS[b] - HEX_VERTS[a]
            base = n_verts + edge_id[:, ei] * (p - 1)
            for m in range(1, p):
                node = c0 + m * d
                mm = np.where(flip_e[:, ei], p - m, m)
                elem_dofs[:, lat(*node)] = base + (mm - 1)

        base_f = n_verts + nE * (p - 1)
        ar = np.arange(ne)
        for fi in range(6):
            corners = HEX_FACES[fi]
            ids = f_quads[:, fi, :]
            k = np.argmin(ids, axis=1)
            fwd = ids[ar, (k + 1) % 4] < ids[ar, (k - 1) % 4]
            c0 = HEX_VERTS[corners[0]] * p
            e1 = HEX_VERTS[corners[1]] - HEX_VERTS[corners[0]]
            e2 = HEX_VERTS[corners[3]] - HEX_VERTS[corners[0]]
            fbase = base_f + face_id[:, fi] * (p - 1) ** 2
            for s in range(1, p):
                for r in range(1, p):
                    node = c0 + r * e1 + s * e2
                    u, v = _canonical_uv(r, s, p, k, fwd)
                    elem_dofs[:, lat(*node)] = fbase + (u - 1) + (p - 1) * (v - 1)

        base_i = base_f + nF * (p - 1) ** 2
        ibase = base_i + ar * (p - 1) ** 3
        idx = 0
        for iz in range(1, p):
            for iy in range(1, p):
                for ix in range(1, p):
                    elem_dofs[:, lat(ix, iy, iz)] = ibase + idx
                    idx += 1
        n_dofs = base_i + ne * (p - 1) ** 3

    return elem_dofs, n_dofs, (uniq_f, face_id)


def build_quad_dofs(quads: np.ndarray, n_verts: int, p: int):
    """Global H1 dof numbering on a conforming quad (2D) mesh.

    Same scheme as :func:`build_hex_dofs`, one dimension down. Local node
    ordering is lattice-lex (r fastest): ``n = r + (p+1)*s`` with corners
    (0,0)->v0, (p,0)->v1, (p,p)->v2, (0,p)->v3.
    """
    nq = quads.shape[0]
    p1 = p + 1

    def lat(r, s):
        return r + p1 * s

    elem_dofs = np.zeros((nq, p1 ** 2), dtype=np.int64)
    for v, (vx, vy) in enumerate(QUAD_VERTS):
        elem_dofs[:, lat(vx * p, vy * p)] = quads[:, v]

    n_dofs = n_verts
    if p >= 2:
        e_pairs = quads[:, QUAD_EDGES]                     # [nq, 4, 2]
        uniq_e, inv_e = np.unique(np.sort(e_pairs, axis=2).reshape(-1, 2),
                                  axis=0, return_inverse=True)
        edge_id = inv_e.reshape(nq, 4)
        flip_e = e_pairs[:, :, 0] > e_pairs[:, :, 1]
        nE = len(uniq_e)
        for ei, (a, b) in enumerate(QUAD_EDGES):
            c0 = QUAD_VERTS[a] * p
            d = QUAD_VERTS[b] - QUAD_VERTS[a]
            base = n_verts + edge_id[:, ei] * (p - 1)
            for m in range(1, p):
                node = c0 + m * d
                mm = np.where(flip_e[:, ei], p - m, m)
                elem_dofs[:, lat(*node)] = base + (mm - 1)
        base_i = n_verts + nE * (p - 1)
        ibase = base_i + np.arange(nq) * (p - 1) ** 2
        idx = 0
        for s in range(1, p):
            for r in range(1, p):
                elem_dofs[:, lat(r, s)] = ibase + idx
                idx += 1
        n_dofs = base_i + nq * (p - 1) ** 2
    return elem_dofs, n_dofs


@dataclass(frozen=True)
class ExtrudedInfo:
    """z-extrusion structure of an (otherwise unstructured) mesh.

    When present, dofs are numbered ``node2d * Dz + z`` (z fastest) on
    vertical columns over a 2D quad mesh, and elements are ordered
    layer-major. The E-vector transfer then needs only a [ne2d, (p+1)^2]
    gather of contiguous Dz-columns plus reshape z-unfolds in lpfem (its
    ``ColumnLattice``); here the numbering gives the free-surface trace its
    contiguous top ``p+1`` levels of every column."""
    ed2d: np.ndarray     # [ne2d, (p+1)^2] 2D dof map
    n2d: int             # 2D dof count
    Dz: int              # p*nz + 1 dof levels
    nz: int              # element layers


@dataclass(frozen=True)
class StructuredInfo:
    """Tensor-product lattice structure of a Cartesian mesh/space.

    When present, dofs are numbered ``ix + Dx*(iy + Dy*iz)`` on the global
    GLL lattice and elements are ordered ``ex + nex*(ey + ney*ez)``. The
    matrix-free apply then performs E-vector gather/scatter as pure
    reshape/strided-slice 'unfold/fold' ops in lpfem; here it selects the
    lattice kernels and the per-axis multigrid transfers."""
    dof_dims: tuple      # (Dx, Dy, Dz)
    elem_dims: tuple     # (nex, ney, nez)
    periodic: tuple      # (px, py, pz) bools


def _detect_structured_mesh(mesh: Mesh):
    """(elem_dims, elem_perm) if the mesh is a Cartesian tensor product."""
    cen = mesh.corner_coords.mean(axis=1)
    dims, idx = [], []
    for a in range(3):
        r = np.round(cen[:, a], 9)
        u = np.unique(r)
        dims.append(len(u))
        idx.append(np.searchsorted(u, r))
    if dims[0] * dims[1] * dims[2] != mesh.n_elems:
        return None
    lin = idx[0] + dims[0] * (idx[1] + dims[1] * idx[2])
    if len(np.unique(lin)) != mesh.n_elems:
        return None
    return tuple(dims), np.argsort(lin, kind="stable")


class H1Space(_NodalProjection):
    """H1 Lagrange space of order ``p`` on a hex :class:`Mesh`
    (``lpfem.space.H1Space``, same numbering).

    On Cartesian (tensor-product) meshes, and on meshes that declare an
    element lattice, the elements are reordered lattice-major and the dofs
    renumbered onto the global GLL lattice (``self.struct`` is then a
    :class:`StructuredInfo`). Otherwise a z-extruded mesh is renumbered onto
    vertical columns (``self.extruded``), and any other mesh keeps the
    topological numbering. Every detection that fails falls through to the
    next, silently, as in lpfem. ``structured=False`` skips every detection
    (the topological numbering on any mesh, lpfem's flag).
    """

    def __init__(self, mesh: Mesh, p: int, structured: bool = True):
        self.struct = None
        self.extruded = None
        det = None
        lattice = structured and mesh.elem_lattice is not None
        if lattice:
            # generator-declared logical lattice (curved tensor-product
            # meshes, e.g. the polar cylinder block): reorder lattice-major
            nex, ney, nez = mesh.lattice_dims
            el = np.asarray(mesh.elem_lattice)
            eperm = np.argsort(el[:, 0] + nex * (el[:, 1] + ney * el[:, 2]),
                               kind="stable")
        else:
            det = _detect_structured_mesh(mesh) if structured else None
            if det is not None:
                elem_dims, eperm = det
        if lattice or det is not None:
            mesh = Mesh(mesh.verts, mesh.elems[eperm],
                        mesh.corner_coords[eperm], mesh.bdr_quads,
                        mesh.bdr_attrs, mesh.periodic,
                        None if mesh.geom_nodes is None else mesh.geom_nodes[eperm],
                        mesh.geom_order, periodic_axes=mesh.periodic_axes,
                        elem_lattice=(mesh.elem_lattice[eperm] if lattice else None),
                        lattice_dims=mesh.lattice_dims)
        self.mesh = mesh
        self.p = int(p)
        self.periodic = tuple(a in mesh.periodic_axes for a in range(3))
        self.elem_dofs, self.n_dofs, (self._uniq_faces, self._face_id) = \
            build_hex_dofs(mesh.elems, mesh.n_verts, p)
        if lattice:
            self._renumber_from_lattice()
        elif det is not None:
            self._try_structured_renumber(elem_dims)
        if self.struct is None and structured:
            self._try_extruded_renumber()

        # boundary face -> (element, local face) lookup
        if len(mesh.bdr_quads):
            bkeys = np.sort(mesh.bdr_quads, axis=1)
            dt = np.dtype([("", bkeys.dtype)] * 4)
            tab = np.ascontiguousarray(self._uniq_faces).view(dt).ravel()
            q = np.ascontiguousarray(bkeys).view(dt).ravel()
            fidx = np.searchsorted(tab, q)
            ok = tab[np.clip(fidx, 0, len(tab) - 1)] == q
            if not np.all(ok):
                raise ValueError("boundary face not found in element faces")
            # invert face_id -> (elem, local face): first adjacency wins
            owner_e = np.full(len(self._uniq_faces), -1, dtype=np.int64)
            owner_f = np.full(len(self._uniq_faces), -1, dtype=np.int64)
            flat = self._face_id.ravel()
            order = np.arange(len(flat))[::-1]
            owner_e[flat[order]] = order // 6
            owner_f[flat[order]] = order % 6
            self.bdr_elem = owner_e[fidx]
            self.bdr_face = owner_f[fidx]
        else:
            self.bdr_elem = np.zeros(0, dtype=np.int64)
            self.bdr_face = np.zeros(0, dtype=np.int64)

    # -------------------------------------------------- structured renumber
    def _renumber_from_lattice(self) -> None:
        """Renumber dofs onto the global GLL lattice of a generator-declared
        logical element lattice (``mesh.elem_lattice``/``lattice_dims``).

        Unlike :meth:`_try_structured_renumber` this is purely integer —
        no coordinate tensor-product detection — so it works for curved
        meshes whose *topology* is a deformed box (polar cylinder block).
        The candidate numbering is verified against the topological
        ``build_hex_dofs`` sharing pattern over EVERY element (each old dof
        id must map to exactly one lattice id, bijectively); on any mismatch
        (e.g. inconsistent element orientation) we silently keep the
        unstructured numbering.
        """
        mesh = self.mesh
        nex, ney, nez = mesh.lattice_dims
        p, p1 = self.p, self.p + 1
        per = tuple(a in mesh.periodic_axes for a in range(3))
        Dx = nex * p + (0 if per[0] else 1)
        Dy = ney * p + (0 if per[1] else 1)
        Dz = nez * p + (0 if per[2] else 1)
        if Dx * Dy * Dz != self.n_dofs:
            return
        el = np.asarray(mesh.elem_lattice)
        ax = np.arange(p1)
        gx = el[:, 0, None] * p + ax
        gy = el[:, 1, None] * p + ax
        gz = el[:, 2, None] * p + ax
        if per[0]:
            gx %= Dx
        if per[1]:
            gy %= Dy
        if per[2]:
            gz %= Dz
        # local lex order (x fastest) matching build_hex_dofs
        new = (gx[:, None, None, :] + Dx * (gy[:, None, :, None]
                                            + Dy * gz[:, :, None, None]))
        new = new.reshape(len(el), p1 ** 3)
        m = np.full(self.n_dofs, -1, dtype=np.int64)
        m[self.elem_dofs.ravel()] = new.ravel()
        if not np.array_equal(m[self.elem_dofs], new):
            return  # sharing pattern disagrees: orientation not lattice-aligned
        if m.min() < 0 or len(np.unique(m)) != self.n_dofs:
            return
        self.elem_dofs = new
        self.struct = StructuredInfo(dof_dims=(Dx, Dy, Dz),
                                     elem_dims=(nex, ney, nez), periodic=per)
        self.__dict__.pop("node_coords", None)
        self.__dict__.pop("node_mult", None)

    def _try_extruded_renumber(self) -> None:
        """Renumber dofs onto vertical columns of a z-extruded mesh.

        Detects meshes built as a 2D quad mesh swept in z (the structure of
        every wave tank, including unstructured Gmsh imports like the
        reference's ``mesh_cylinder_half.msh``): element corners sit on two
        consecutive z-levels, vertices stack in vertical columns, and every
        layer repeats the same 2D footprint with the same orientation. On
        success dofs are renumbered ``node2d * Dz + z`` (z fastest, so each
        column is a contiguous slab), elements are reordered layer-major,
        and ``self.extruded`` is set. The candidate numbering is verified
        against the topological ``build_hex_dofs`` sharing pattern over
        every element (bijective remap); on any mismatch the unstructured
        numbering is silently kept.
        """
        mesh = self.mesh
        ne = mesh.n_elems
        p, p1 = self.p, self.p + 1
        cz = np.round(mesh.corner_coords[:, :, 2], 9)      # [ne, 8]
        levels = np.unique(cz)
        nz = len(levels) - 1
        if nz < 1 or ne % nz != 0:
            return
        lev = np.searchsorted(levels, cz)
        # HEX_VERTS convention: corners 0..3 on the bottom face, 4..7 above
        bot, top = lev[:, :4], lev[:, 4:]
        if not (np.all(bot == bot[:, :1]) and np.all(top == bot[:, :1] + 1)):
            return
        layer = bot[:, 0]
        if np.any(np.bincount(layer, minlength=nz) != ne // nz):
            return

        elems = mesh.elems
        nv = mesh.n_verts
        vz = np.round(mesh.verts[:, 2], 9)
        vpos = np.searchsorted(levels, vz)
        if not np.all(levels[np.clip(vpos, 0, nz)] == vz):
            return
        base = np.where(vpos == 0)[0]
        n2d_v = len(base)
        if n2d_v * (nz + 1) != nv:
            return
        # vertical vertex columns: propagate 2D ids level by level through
        # each element's (bottom corner i) -> (top corner i+4) pairs
        vert2d = np.full(nv, -1, dtype=np.int64)
        vert2d[base] = np.arange(n2d_v)
        for k in range(nz):
            es = np.where(layer == k)[0]
            src = elems[es, :4].ravel()
            dst = elems[es, 4:].ravel()
            new = vert2d[src]
            if np.any(new < 0):
                return
            cur = vert2d[dst]
            if np.any((cur >= 0) & (cur != new)):
                return
            vert2d[dst] = new
        if np.any(vert2d < 0):
            return

        # 2D footprint from the layer-0 elements (their orientation); every
        # element must repeat its column's footprint with the SAME corner
        # order, else local dof lattices would disagree between layers
        e0 = np.where(layer == 0)[0]
        quads2d = vert2d[elems[e0][:, :4]]                 # [ne2d, 4]
        ne2d = len(e0)
        keys = np.sort(quads2d, axis=1)
        dt4 = np.dtype([("", keys.dtype)] * 4)
        tab = np.ascontiguousarray(keys).view(dt4).ravel()
        order0 = np.argsort(tab)
        all_q = vert2d[elems[:, :4]]
        qk = np.ascontiguousarray(np.sort(all_q, axis=1)).view(dt4).ravel()
        pos = np.searchsorted(tab[order0], qk)
        if np.any(pos >= ne2d) or not np.all(tab[order0][pos] == qk):
            return
        col_of = order0[pos]                               # [ne]
        if not np.array_equal(quads2d[col_of], all_q):
            return                                         # rotated layer

        ed2d, n2d = build_quad_dofs(quads2d, n2d_v, p)
        Dz = p * nz + 1
        if n2d * Dz != self.n_dofs:
            return
        # candidate numbering: dof = node2d * Dz + (p*layer + lz), local
        # order lz major then the 2D lattice (s, r) — hex lattice-lex
        lz = np.arange(p1)
        zs = (p * layer)[:, None, None] + lz[None, :, None]   # [ne, p1, 1]
        new = (ed2d[col_of][:, None, :] * Dz + zs).reshape(ne, p1 ** 3)
        m = np.full(self.n_dofs, -1, dtype=np.int64)
        m[self.elem_dofs.ravel()] = new.ravel()
        if not np.array_equal(m[self.elem_dofs], new):
            return
        if m.min() < 0 or len(np.unique(m)) != self.n_dofs:
            return

        # commit: layer-major element order (matches the column gather)
        eperm = np.argsort(layer * ne2d + col_of, kind="stable")
        self.mesh = Mesh(
            mesh.verts, mesh.elems[eperm], mesh.corner_coords[eperm],
            mesh.bdr_quads, mesh.bdr_attrs, mesh.periodic,
            None if mesh.geom_nodes is None else mesh.geom_nodes[eperm],
            mesh.geom_order, periodic_axes=mesh.periodic_axes)
        self.elem_dofs = new[eperm]
        self._face_id = self._face_id[eperm]
        self.extruded = ExtrudedInfo(ed2d=ed2d, n2d=n2d, Dz=Dz, nz=nz)
        self.__dict__.pop("node_coords", None)
        self.__dict__.pop("node_mult", None)

    def _try_structured_renumber(self, elem_dims) -> None:
        """Renumber dofs onto the global GLL lattice if the node coordinates
        form a tensor product; sets ``self.struct`` on success."""
        mesh = self.mesh
        X = np.zeros((self.n_dofs, 3))
        flat = self.elem_dofs.ravel()[::-1]
        X[flat] = self.elem_node_coords.reshape(-1, 3)[::-1]
        bbmin, bbmax = mesh.bounding_box()
        per = tuple(a in mesh.periodic_axes for a in range(3))
        dims, idx = [], []
        for a in range(3):
            r = np.round(X[:, a], 9)
            if per[a]:
                hi = np.round(bbmax[a], 9)
                r = np.where(r == hi, np.round(bbmin[a], 9), r)
            u = np.unique(r)
            pos = np.searchsorted(u, r)
            if not np.all(u[pos] == r):
                return
            dims.append(len(u))
            idx.append(pos)
        Dx, Dy, Dz = dims
        if Dx * Dy * Dz != self.n_dofs:
            return
        new = idx[0] + Dx * (idx[1] + Dy * idx[2])
        if len(np.unique(new)) != self.n_dofs:
            return
        # sanity: every element's local dof order must be the x-fastest
        # lattice order with unit strides from its own origin (wrapping on
        # periodic axes). A Cartesian mesh imported with rotated element
        # connectivity can have lattice centroids but non-lattice local
        # axes — fall back to the unstructured numbering like every other
        # detection bail-out (the lattice kernels and transfers require
        # this exact order).
        p1 = self.p + 1
        ix = np.arange(p1)
        for a, axis in ((0, 3), (1, 2), (2, 1)):
            g = idx[a][self.elem_dofs].reshape(-1, p1, p1, p1)
            base = np.take(g, [0], axis=axis)
            shape = [1, 1, 1, 1]
            shape[axis] = p1
            want = base + ix.reshape(shape)
            if per[a]:
                want = want % dims[a]
            if not np.array_equal(g, want):
                return
        self.elem_dofs = new[self.elem_dofs]
        self.struct = StructuredInfo(dof_dims=(Dx, Dy, Dz),
                                     elem_dims=tuple(elem_dims),
                                     periodic=per)
        # invalidate caches that depend on dof numbering
        self.__dict__.pop("node_coords", None)
        self.__dict__.pop("node_mult", None)

    # ------------------------------------------------------------- geometry
    @cached_property
    def elem_node_coords(self) -> np.ndarray:
        """[ne, (p+1)^3, 3] physical coordinates of every element lattice node
        (curved geometry honored when ``mesh.geom_nodes`` is set)."""
        return _elem_node_coords(self.mesh, self.p)

    @cached_property
    def node_coords(self) -> np.ndarray:
        """[n_dofs, 3] representative physical coordinates per dof.

        For periodic meshes, seam dofs take one of their (equivalent modulo
        the period) positions — fine for projecting periodic fields, which is
        the only use (MFEM has the same representative-coordinate behavior
        through its L-dof geometry).
        """
        X = np.zeros((self.n_dofs, 3))
        flat = self.elem_dofs.ravel()[::-1]
        X[flat] = self.elem_node_coords.reshape(-1, 3)[::-1]
        return X

    @cached_property
    def node_mult(self) -> np.ndarray:
        """[n_dofs] number of elements sharing each dof (for nodal averaging,
        the MFEM ``GridFunction::GetDerivative`` semantics,
        ``Solvers/PF_linear_serial.cpp:175``)."""
        return np.bincount(self.elem_dofs.ravel(), minlength=self.n_dofs).astype(np.float64)

    # ------------------------------------------------------------ boundaries
    def boundary_faces(self, attrs) -> np.ndarray:
        attrs = np.atleast_1d(np.asarray(attrs))
        return np.where(np.isin(self.mesh.bdr_attrs, attrs))[0]

    def face_lattice_dofs(self, belem: np.ndarray, bface: np.ndarray) -> np.ndarray:
        """[nb, (p+1)^2] volume dofs of each boundary face, in the face's
        2D lattice order (r fastest, corners c0..c3 = HEX_FACES cycle)."""
        p, p1 = self.p, self.p + 1
        out = np.zeros((len(belem), p1 ** 2), dtype=np.int64)
        for fi in range(6):
            sel = np.where(bface == fi)[0]
            if not len(sel):
                continue
            corners = HEX_FACES[fi]
            c0 = HEX_VERTS[corners[0]] * p
            e1 = HEX_VERTS[corners[1]] - HEX_VERTS[corners[0]]
            e2 = HEX_VERTS[corners[3]] - HEX_VERTS[corners[0]]
            cols = np.zeros(p1 ** 2, dtype=np.int64)
            for s in range(p1):
                for r in range(p1):
                    node = c0 + r * e1 + s * e2
                    cols[r + p1 * s] = node[0] + p1 * (node[1] + p1 * node[2])
            out[sel] = self.elem_dofs[np.ix_(belem[sel], cols)]
        return out

    def boundary_dofs(self, attrs) -> np.ndarray:
        """Unique dofs on boundary faces with the given attributes — the
        essential-true-dof list (MFEM ``GetEssentialTrueDofs``,
        ``Solvers/PF_linear_par_partial.cpp:407-412``)."""
        bsel = self.boundary_faces(attrs)
        if not len(bsel):
            return np.zeros(0, dtype=np.int64)
        fd = self.face_lattice_dofs(self.bdr_elem[bsel], self.bdr_face[bsel])
        return np.unique(fd)

    # ------------------------------------- the interface the spaces share
    @property
    def dof_dims(self) -> tuple | None:
        return None if self.struct is None else self.struct.dof_dims

    @property
    def elem_dims(self) -> tuple | None:
        return None if self.struct is None else self.struct.elem_dims

    def with_order(self, p: int) -> "H1Space":
        """The same mesh at order ``p`` (a p-multigrid level)."""
        return H1Space(self.mesh, p)

    def coarsen(self) -> "H1Space | None":
        """The h-coarsened p=1 space (:func:`_coarsen_structured`); None
        without a lattice or where lpfem's chain stops."""
        return None if self.struct is None else _coarsen_structured(self)

    def top_plane_dofs(self) -> np.ndarray:
        """The free-surface dofs, sorted: the boundary faces with attribute 2
        (``lpfem.multigrid.PMultigrid``'s essential set). On a lattice they
        must be its top z-plane, which the lattice kernels constrain; an
        h-coarsened mesh (no boundary table) takes the plane itself."""
        if self.struct is None:
            return self.boundary_dofs(2)
        top = _top_plane_dofs(self.struct.dof_dims)
        if len(self.mesh.bdr_quads) and not np.array_equal(
                self.boundary_dofs(2), top):
            raise NotImplementedError(
                "the boundary faces with attribute 2 are not the top z-plane "
                "of the detected lattice")
        return top

    def geometry_lattice(self) -> tuple[np.ndarray, int]:
        """(nodes [ne, (pg+1)^3, 3] lattice-lex, pg): the curved geometry
        nodes, else the trilinear corner lattice
        (``lpfem.operators._geometry_lattice``)."""
        if self.mesh.geom_nodes is not None:
            return self.mesh.geom_nodes, self.mesh.geom_order
        return self.mesh.corner_coords[:, _LEX_OF_VERT, :], 1

    def bounding_box(self) -> tuple[np.ndarray, np.ndarray]:
        return self.mesh.bounding_box()


class SurfaceSpace(_NodalProjection):
    """The free surface of a volume space, with surface dof ``s`` at volume
    dof ``surf_to_vol[s]`` and ``elem_dofs [n_elems, (p+1)^2]`` its quad
    elements (for :meth:`max_error_quad`).

    - On a :class:`LatticeSpace` / :class:`CurvedLatticeSpace`: the top
      z-plane in lattice order, surface dof ``ix + Dx*iy``, the top faces
      as elements (x fastest). lpfem numbers the same dofs topologically;
      ``lpfem_torch.convert`` maps between the two orders.
    - On an :class:`H1Space`: lpfem's trace space on the boundary faces with
      attribute ``attr`` (``lpfem.space.SurfaceSpace``, MFEM's
      ``SubMesh::CreateFromBoundary``): a standalone 2D H1 numbering over
      the boundary quads, the same surface order as lpfem's.
    """

    def __init__(self, vol, attr: int = 2):
        self.vol = vol
        self.p = vol.p
        if isinstance(vol, H1Space):
            self._init_boundary(vol, attr)
        else:
            self._init_top_plane(vol)
        self.node_coords = vol.node_coords[self.surf_to_vol]

    def _init_top_plane(self, vol) -> None:
        Dx, Dy, _ = vol.dof_dims
        self.n_dofs = Dx * Dy
        self.surf_to_vol = vol.top_plane_dofs()
        nex, ney, _ = vol.elem_dims
        p, ar = self.p, np.arange(self.p + 1)
        ix = (np.arange(nex)[:, None] * p + ar) % Dx            # [nex, p1]
        iy = (np.arange(ney)[:, None] * p + ar) % Dy            # [ney, p1]
        self.elem_dofs = (ix[None, :, None, :] + Dx * iy[:, None, :, None]
                          ).reshape(ney * nex, (p + 1) ** 2)

    def _init_boundary(self, vol: H1Space, attr: int) -> None:
        bsel = vol.boundary_faces(attr)
        if not len(bsel):
            raise ValueError(f"no boundary faces with attribute {attr}")
        belem = vol.bdr_elem[bsel]
        bface = vol.bdr_face[bsel]
        mesh = vol.mesh
        # surface quads in volume-vertex ids, cyclic order of the local face
        squads_vol = np.zeros((len(bsel), 4), dtype=np.int64)
        for fi in range(6):
            sel = np.where(bface == fi)[0]
            if len(sel):
                squads_vol[sel] = mesh.elems[np.ix_(belem[sel], HEX_FACES[fi])]
        used = np.unique(squads_vol)
        remap = np.full(mesh.n_verts, -1, dtype=np.int64)
        remap[used] = np.arange(len(used))
        self.elem_dofs, self.n_dofs = build_quad_dofs(remap[squads_vol],
                                                      len(used), self.p)
        vol_face_dofs = vol.face_lattice_dofs(belem, bface)  # [nb, p1^2]
        s2v = np.full(self.n_dofs, -1, dtype=np.int64)
        s2v[self.elem_dofs.ravel()] = vol_face_dofs.ravel()
        if np.any(s2v < 0) or not np.all(s2v[self.elem_dofs] == vol_face_dofs):
            raise ValueError("inconsistent surface-to-volume dof map")
        self.surf_to_vol = s2v

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
        # the seam is unwrapped by the bounding box's extent, as lpfem does
        # (on a sheared periodic tank that is not the period: ROADMAP C8)
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
