"""Host-side hexahedral mesh layer (NumPy).

Counterpart of ``lpfem.mesh``: the ``Mesh`` record with ``uniform_refine``
(MFEM ``UniformRefinement``), the Cartesian generators (``MakeCartesian3D``,
``MakePeriodic`` with its vertex identification, the tank boundary marking of
``Meshes/wave_tank.cpp``) and the MFEM v1.0 mesh-file writer and parser,
including the per-element L2 nodes section periodic meshes carry; the Gmsh
v2.2 reader (``load_gmsh``, through the native scanner of
``lpfem_torch.native``, with the Python parser kept as
``parse_gmsh_python``), a v2.2 writer for linear meshes (``save_gmsh``), and
MFEM's ``SetCurvature`` with lpfem's boundary snap (``set_curvature``,
``cylinder_projector``).

Geometry's source of truth is ``corner_coords [n_elem, 8, 3]`` (per element,
*unwrapped*, which is what makes periodic meshes work); topology is
``elems [n_elem, 8]`` with identified vertex ids. Hex local vertex order is
MFEM/VTK's:

  0:(0,0,0) 1:(1,0,0) 2:(1,1,0) 3:(0,1,0) 4:(0,0,1) 5:(1,0,1) 6:(1,1,1) 7:(0,1,1)
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np

from .elements import basis_1d

__all__ = [
    "Mesh",
    "make_cartesian3d",
    "make_periodic",
    "mark_boundary_tank",
    "make_wave_tank",
    "make_wave_tank_finite",
    "save_mfem",
    "load_mfem",
    "save_gmsh",
    "load_gmsh",
    "parse_gmsh_python",
    "cylinder_projector",
    "set_curvature",
    "HEX_VERTS",
    "HEX_EDGES",
    "HEX_FACES",
    "trilinear_weights",
]

# Lattice coordinates (ix,iy,iz in {0,1}) of the 8 hex vertices.
HEX_VERTS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    dtype=np.int64,
)

# 12 edges as local vertex pairs.
HEX_EDGES = np.array(
    [
        [0, 1], [1, 2], [3, 2], [0, 3],
        [4, 5], [5, 6], [7, 6], [4, 7],
        [0, 4], [1, 5], [2, 6], [3, 7],
    ],
    dtype=np.int64,
)

# 6 faces as cyclic quads (outward normals not required; perimeter cycles).
HEX_FACES = np.array(
    [
        [0, 3, 2, 1],  # bottom  z=0
        [0, 1, 5, 4],  # front   y=0
        [1, 2, 6, 5],  # right   x=1
        [2, 3, 7, 6],  # back    y=1
        [3, 0, 4, 7],  # left    x=0
        [4, 5, 6, 7],  # top     z=1
    ],
    dtype=np.int64,
)

# lattice-lexicographic (x fastest) index of each hex vertex
_HEX_VERT_LEX = np.array([0, 1, 3, 2, 4, 5, 7, 6], dtype=np.int64)


def trilinear_weights(p: int) -> np.ndarray:
    """[(p+1)^3, 8]: the trilinear weight of each hex vertex at every node
    of the order-``p`` GLL lattice, x fastest (``lpfem.space._geom_weights``
    and the loop of ``lpfem.cylmesh.set_cylinder_geometry``)."""
    gll = basis_1d(p).nodes
    p1 = p + 1
    W = np.zeros((p1 ** 3, 8))
    for iz in range(p1):
        for iy in range(p1):
            for ix in range(p1):
                W[ix + p1 * (iy + p1 * iz)] = _trilinear_weights(
                    np.array([gll[ix], gll[iy], gll[iz]]))
    return W


@dataclass
class Mesh:
    verts: np.ndarray          # [nv, 3] topological vertex positions
    elems: np.ndarray          # [ne, 8] MFEM hex vertex order
    corner_coords: np.ndarray  # [ne, 8, 3] geometric corner positions (unwrapped)
    bdr_quads: np.ndarray      # [nb, 4] cyclic vertex quads
    bdr_attrs: np.ndarray      # [nb]
    periodic: bool = False
    # optional high-order geometry nodes [ne, (pg+1)^3, 3], lattice-lex
    # order (x fastest); None -> trilinear from the corners
    geom_nodes: np.ndarray | None = None
    geom_order: int = 1
    # axes (0=x, 1=y, 2=z) identified by make_periodic
    periodic_axes: tuple = ()
    # logical lattice declared by the generator: integer element coordinates
    # [ne, 3] on a (nex, ney, nez) grid, element axes aligned with it
    # (``space.CurvedLatticeSpace`` numbers such a mesh on its GLL lattice)
    elem_lattice: np.ndarray | None = None
    lattice_dims: tuple | None = None

    @property
    def n_elems(self) -> int:
        return self.elems.shape[0]

    @property
    def n_verts(self) -> int:
        return self.verts.shape[0]

    def bounding_box(self) -> tuple[np.ndarray, np.ndarray]:
        cc = self.corner_coords.reshape(-1, 3)
        return cc.min(axis=0), cc.max(axis=0)

    # ---------------------------------------------------------------- refine
    def uniform_refine(self) -> "Mesh":
        """8-way hex split (MFEM ``UniformRefinement``).

        New topological vertices are created per unique edge / face / element
        (keys are sorted parent vertex tuples, so periodic identification is
        inherited). Geometry of children comes from trilinear interpolation of
        the parent's ``corner_coords``, which keeps seam-crossing periodic
        elements consistent.
        """
        ne = self.n_elems
        elems = self.elems
        nv = self.n_verts

        # --- unique edges ---
        e_pairs = elems[:, HEX_EDGES]                    # [ne, 12, 2]
        e_keys = np.sort(e_pairs.reshape(-1, 2), axis=1)
        uniq_e, inv_e = np.unique(e_keys, axis=0, return_inverse=True)
        edge_id = inv_e.reshape(ne, 12)
        n_edge = len(uniq_e)

        # --- unique faces ---
        f_quads = elems[:, HEX_FACES]                    # [ne, 6, 4]
        f_keys = np.sort(f_quads.reshape(-1, 4), axis=1)
        uniq_f, inv_f = np.unique(f_keys, axis=0, return_inverse=True)
        face_id = inv_f.reshape(ne, 6)
        n_face = len(uniq_f)

        # new vertex ids
        ev = nv + edge_id                                # [ne, 12]
        fv = nv + n_edge + face_id                       # [ne, 6]
        cv = nv + n_edge + n_face + np.arange(ne)        # [ne]

        # topological coords (only used for marking/diagnostics)
        new_verts = np.zeros((nv + n_edge + n_face + ne, 3))
        new_verts[:nv] = self.verts
        new_verts[nv:nv + n_edge] = 0.5 * (self.verts[uniq_e[:, 0]] + self.verts[uniq_e[:, 1]])
        new_verts[nv + n_edge:nv + n_edge + n_face] = self.verts[uniq_f].mean(axis=1)
        new_verts[nv + n_edge + n_face:] = self.verts[elems].mean(axis=1)

        # Build a per-element 3x3x3 lattice of vertex ids
        lat = np.zeros((ne, 3, 3, 3), dtype=np.int64)
        for i, (ix, iy, iz) in enumerate(HEX_VERTS):
            lat[:, 2 * ix, 2 * iy, 2 * iz] = elems[:, i]
        for e, (a, b) in enumerate(HEX_EDGES):
            mid = HEX_VERTS[a] + HEX_VERTS[b]            # in {0,1,2}
            lat[:, mid[0], mid[1], mid[2]] = ev[:, e]
        for f in range(6):
            mid = HEX_VERTS[HEX_FACES[f]].sum(axis=0) // 2
            lat[:, mid[0], mid[1], mid[2]] = fv[:, f]
        lat[:, 1, 1, 1] = cv

        # children: 8 sub-hexes at offsets o in {0,1}^3
        child_elems = np.zeros((ne, 8, 8), dtype=np.int64)
        for ci, (ox, oy, oz) in enumerate(HEX_VERTS):
            for vi, (vx, vy, vz) in enumerate(HEX_VERTS):
                child_elems[:, ci, vi] = lat[:, ox + vx, oy + vy, oz + vz]
        child_elems = child_elems.reshape(ne * 8, 8)

        # children geometry: trilinear interpolation of parent corners at
        # lattice points (o+v)/2
        cc = self.corner_coords                           # [ne, 8, 3]
        child_cc = np.zeros((ne, 8, 8, 3))
        for ci, o in enumerate(HEX_VERTS):
            for vi, v in enumerate(HEX_VERTS):
                xi = (o + v) / 2.0                        # in [0,1]^3
                w = _trilinear_weights(xi)                # [8]
                child_cc[:, ci, vi] = np.einsum("k,ekd->ed", w, cc)
        child_cc = child_cc.reshape(ne * 8, 8, 3)

        # boundary quads: split each into 4 using the same edge/face vertices
        bq = self.bdr_quads
        nb = bq.shape[0]
        new_bq = np.zeros((nb * 4, 4), dtype=np.int64)
        new_ba = np.repeat(self.bdr_attrs, 4)
        if nb:
            bq_ekeys = np.sort(
                np.stack([bq, np.roll(bq, -1, axis=1)], axis=-1).reshape(-1, 2), axis=1
            )  # [nb*4, 2] edges (a,b),(b,c),(c,d),(d,a)
            em = _lookup_rows(uniq_e, bq_ekeys).reshape(nb, 4) + nv
            fkey = np.sort(bq, axis=1)
            fm = _lookup_rows(uniq_f, fkey) + nv + n_edge
            a, b, c, d = bq[:, 0], bq[:, 1], bq[:, 2], bq[:, 3]
            mab, mbc, mcd, mda = em[:, 0], em[:, 1], em[:, 2], em[:, 3]
            new_bq[0::4] = np.stack([a, mab, fm, mda], axis=1)
            new_bq[1::4] = np.stack([mab, b, mbc, fm], axis=1)
            new_bq[2::4] = np.stack([fm, mbc, c, mcd], axis=1)
            new_bq[3::4] = np.stack([mda, fm, mcd, d], axis=1)

        return Mesh(
            verts=new_verts,
            elems=child_elems.astype(np.int64),
            corner_coords=child_cc,
            bdr_quads=new_bq,
            bdr_attrs=new_ba.astype(np.int64),
            periodic=self.periodic,
            periodic_axes=self.periodic_axes,
        )


def _trilinear_weights(xi: np.ndarray) -> np.ndarray:
    """Trilinear shape functions at xi in [0,1]^3, ordered like HEX_VERTS."""
    w = np.zeros(8)
    for i, (vx, vy, vz) in enumerate(HEX_VERTS):
        w[i] = (
            (xi[0] if vx else 1 - xi[0])
            * (xi[1] if vy else 1 - xi[1])
            * (xi[2] if vz else 1 - xi[2])
        )
    return w


def _lookup_rows(table: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Index of each query row in ``table`` (rows of table are unique, sorted)."""
    # lexicographic searchsorted over structured view
    dt = np.dtype([("", table.dtype)] * table.shape[1])
    t = np.ascontiguousarray(table).view(dt).ravel()
    q = np.ascontiguousarray(queries).view(dt).ravel()
    idx = np.searchsorted(t, q)
    if not np.all(t[np.clip(idx, 0, len(t) - 1)] == q):
        raise KeyError("row not found in table")
    return idx


# --------------------------------------------------------------- generators

def make_cartesian3d(nx: int, ny: int, nz: int, Lx: float, Ly: float,
                     Lz: float, xs=None, ys=None, zs=None) -> Mesh:
    """Cartesian hex box, MFEM ``Mesh::MakeCartesian3D`` equivalent.

    ``xs``/``ys``/``zs`` optionally override the uniform grid lines with
    explicit (strictly increasing) coordinates — a graded tensor-product
    grid, e.g. z-spacing packed toward the free surface. Still a separable
    lattice: every fast path (Kronecker operator, fused kernels, top-plane
    trace) applies.
    """
    xs = np.linspace(0, Lx, nx + 1) if xs is None else np.asarray(xs, float)
    ys = np.linspace(0, Ly, ny + 1) if ys is None else np.asarray(ys, float)
    zs = np.linspace(0, Lz, nz + 1) if zs is None else np.asarray(zs, float)
    for name, g, ne in (("xs", xs, nx), ("ys", ys, ny), ("zs", zs, nz)):
        if len(g) != ne + 1:
            raise ValueError(f"{name}: expected {ne + 1} grid lines, "
                             f"got {len(g)}")
        if np.any(np.diff(g) <= 0):
            raise ValueError(f"{name} must be strictly increasing "
                             "(inverted elements otherwise)")
    # vertex id = ix + (nx+1)*(iy + (ny+1)*iz)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    verts = np.stack(
        [X.transpose(2, 1, 0).ravel(), Y.transpose(2, 1, 0).ravel(), Z.transpose(2, 1, 0).ravel()],
        axis=1,
    )

    def vid(ix, iy, iz):
        return ix + (nx + 1) * (iy + (ny + 1) * iz)

    ex, ey, ez = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    ex, ey, ez = (a.transpose(2, 1, 0).ravel() for a in (ex, ey, ez))
    elems = np.stack(
        [vid(ex + v[0], ey + v[1], ez + v[2]) for v in HEX_VERTS], axis=1
    ).astype(np.int64)
    corner_coords = verts[elems]

    # boundary quads on the 6 box sides
    bq, ba = [], []

    def add_face(vids, attr):
        bq.append(vids)
        ba.append(attr)

    for iy in range(ny):
        for ix in range(nx):
            add_face([vid(ix, iy, 0), vid(ix, iy + 1, 0), vid(ix + 1, iy + 1, 0), vid(ix + 1, iy, 0)], 1)  # z=0
            add_face([vid(ix, iy, nz), vid(ix + 1, iy, nz), vid(ix + 1, iy + 1, nz), vid(ix, iy + 1, nz)], 6)  # z=max
    for iz in range(nz):
        for ix in range(nx):
            add_face([vid(ix, 0, iz), vid(ix + 1, 0, iz), vid(ix + 1, 0, iz + 1), vid(ix, 0, iz + 1)], 2)  # y=0
            add_face([vid(ix, ny, iz), vid(ix, ny, iz + 1), vid(ix + 1, ny, iz + 1), vid(ix + 1, ny, iz)], 4)  # y=max
    for iz in range(nz):
        for iy in range(ny):
            add_face([vid(0, iy, iz), vid(0, iy, iz + 1), vid(0, iy + 1, iz + 1), vid(0, iy + 1, iz)], 5)  # x=0
            add_face([vid(nx, iy, iz), vid(nx, iy + 1, iz), vid(nx, iy + 1, iz + 1), vid(nx, iy, iz + 1)], 3)  # x=max

    return Mesh(
        verts=verts,
        elems=elems,
        corner_coords=corner_coords,
        bdr_quads=np.array(bq, dtype=np.int64),
        bdr_attrs=np.array(ba, dtype=np.int64),
    )


def make_periodic(mesh: Mesh, translations: list[np.ndarray], tol: float = 1e-8) -> Mesh:
    """Identify vertices differing by any of ``translations``.

    MFEM ``Mesh::MakePeriodic`` + ``CreatePeriodicVertexMapping`` equivalent
    (``Meshes/wave_tank.cpp:17-21``). Boundary faces on the identified sides
    disappear. Geometry (``corner_coords``) keeps unwrapped positions.
    """
    verts = mesh.verts
    nv = len(verts)
    rep = np.arange(nv)
    key = np.round(verts / tol).astype(np.int64)
    for t in translations:
        t = np.asarray(t, dtype=np.float64)
        # map each vertex v -> v - t if a vertex exists there (vectorized
        # key join: one np.unique over both key sets — the per-vertex dict
        # loop was the make_periodic scaling hazard at generated-tank sizes)
        skey = np.round((verts - t) / tol).astype(np.int64)
        uniq, inv = np.unique(np.concatenate([key, skey]), axis=0,
                              return_inverse=True)
        owner_of = np.full(len(uniq), -1, dtype=np.int64)
        owner_of[inv[:nv]] = np.arange(nv)
        j = owner_of[inv[nv:]]
        hit = (j >= 0) & (j != np.arange(nv))
        rep[hit] = j[hit]
    # path-compress (vectorized pointer jumping)
    while True:
        rep2 = rep[rep]
        if np.array_equal(rep2, rep):
            break
        rep = rep2
    used = np.unique(rep)
    remap = -np.ones(nv, dtype=np.int64)
    remap[used] = np.arange(len(used))
    new_elems = remap[rep[mesh.elems]]

    # drop boundary faces that became interior: after identification a seam
    # face is adjacent to two elements. (MFEM's MakePeriodic leaves coincident
    # duplicates in the boundary list — see the attr-5/attr-3 pair in the
    # committed ``Meshes/wave-tank.mesh``; they are physically inert and we
    # drop them instead.) Vectorized: a boundary quad survives iff its
    # sorted key appears exactly once among the element faces.
    f_keys = np.sort(new_elems[:, HEX_FACES].reshape(-1, 4), axis=1)
    bkeys = (np.sort(remap[rep[mesh.bdr_quads]], axis=1)
             if len(mesh.bdr_quads) else np.zeros((0, 4), dtype=np.int64))
    uniq, inv = np.unique(np.concatenate([f_keys, bkeys]), axis=0,
                          return_inverse=True)
    cnt = np.bincount(inv[: len(f_keys)], minlength=len(uniq))
    keep = np.where(cnt[inv[len(f_keys):]] == 1)[0]
    bq = (remap[rep[mesh.bdr_quads[keep]]] if len(keep)
          else np.zeros((0, 4), dtype=np.int64))

    axes = tuple(sorted({int(np.argmax(np.abs(np.asarray(t, dtype=np.float64))))
                         for t in translations}))
    return Mesh(
        verts=verts[used],
        elems=new_elems,
        corner_coords=mesh.corner_coords.copy(),
        bdr_quads=bq,
        bdr_attrs=mesh.bdr_attrs[keep],
        periodic=True,
        periodic_axes=axes,
    )


def mark_boundary_tank(mesh: Mesh, finite: bool = False) -> Mesh:
    """Re-mark boundary attributes by face-center coordinates.

    Tank convention (``Meshes/wave_tank.cpp:30-47``, ``wave-tank-finite.cpp``):
    bottom=1, top(free surface)=2, y-min=3, y-max=4, and for finite tanks
    x-max=5, x-min=6.
    """
    cc = mesh.corner_coords.reshape(-1, 3)
    bbmin, bbmax = cc.min(axis=0), cc.max(axis=0)
    tol = 1e-12 * np.sum(bbmax - bbmin)
    tol = max(tol, 1e-10)
    # face centers from geometric positions: use topological verts (ok for
    # non-seam faces; periodic tanks have no x faces anyway)
    centers = mesh.verts[mesh.bdr_quads].mean(axis=1)
    attrs = mesh.bdr_attrs.copy()
    for b, x in enumerate(centers):
        if abs(x[2] - bbmin[2]) < tol:
            attrs[b] = 1
        elif abs(x[2] - bbmax[2]) < tol:
            attrs[b] = 2
        elif abs(x[1] - bbmin[1]) < tol:
            attrs[b] = 3
        elif abs(x[1] - bbmax[1]) < tol:
            attrs[b] = 4
        elif finite and abs(x[0] - bbmax[0]) < tol:
            attrs[b] = 5
        elif finite and abs(x[0] - bbmin[0]) < tol:
            attrs[b] = 6
    return Mesh(mesh.verts, mesh.elems, mesh.corner_coords, mesh.bdr_quads,
                attrs, mesh.periodic, mesh.geom_nodes, mesh.geom_order,
                periodic_axes=mesh.periodic_axes)


def make_wave_tank(nx: int = 128, ny: int = 2, nz: int = 16,
                   Lx: float = 1.0, Ly: float = 0.1, Lz: float = 1.0 / (2 * np.pi)) -> Mesh:
    """x-periodic wave tank (``Meshes/wave_tank.cpp:13-21``).

    Defaults produce the ``wave-tank-big8.mesh`` configuration; the committed
    family is nx,ny,nz = (3,1,1) -> wave-tank.mesh, (32,2,8) -> big,
    (64,2,8) -> big2, (64,2,16) -> big4, (128,2,16) -> big8.
    """
    base = make_cartesian3d(nx, ny, nz, Lx, Ly, Lz)
    m = make_periodic(base, [np.array([Lx, 0.0, 0.0])])
    return mark_boundary_tank(m, finite=False)


def make_wave_tank_finite(nx: int = 36, ny: int = 1, nz: int = 1,
                          Lx: float = 12.0, Ly: float = 1.0,
                          Lz: float = 1.0 / (2 * np.pi)) -> Mesh:
    """Finite wave tank (``Meshes/wave-tank-finite.cpp:10-45``)."""
    m = make_cartesian3d(nx, ny, nz, Lx, Ly, Lz)
    return mark_boundary_tank(m, finite=True)


def save_mfem(mesh: Mesh, path: str) -> None:
    """Write an MFEM v1.0 mesh file (generator parity with
    ``Meshes/wave_tank.cpp:49`` ``mesh.Save(...)``). Periodic meshes carry
    the per-element L2 geometry nodes section like the committed
    ``wave-tank.mesh``."""
    with open(path, "w") as f:
        f.write("MFEM mesh v1.0\n\ndimension\n3\n\n")
        f.write(f"elements\n{mesh.n_elems}\n")
        for e in range(mesh.n_elems):
            f.write("1 5 " + " ".join(str(v) for v in mesh.elems[e]) + "\n")
        f.write(f"\nboundary\n{len(mesh.bdr_quads)}\n")
        for b in range(len(mesh.bdr_quads)):
            f.write(f"{mesh.bdr_attrs[b]} 3 "
                    + " ".join(str(v) for v in mesh.bdr_quads[b]) + "\n")
        f.write(f"\nvertices\n{mesh.n_verts}\n")
        if mesh.periodic:
            f.write("\nnodes\nFiniteElementSpace\n"
                    "FiniteElementCollection: L2_T1_3D_P1\n"
                    "VDim: 3\nOrdering: 1\n\n")
            # corner_coords rows are hex-vertex order; the nodes section is
            # lattice-lex order
            lex = mesh.corner_coords[:, np.argsort(_HEX_VERT_LEX), :]
            for e in range(mesh.n_elems):
                for n in range(8):
                    f.write(" ".join(f"{c:.16g}" for c in lex[e, n]) + "\n")
        else:
            f.write("3\n")
            for v in range(mesh.n_verts):
                f.write(" ".join(f"{c:.16g}" for c in mesh.verts[v]) + "\n")


# -------------------------------------------------------------------- parsers

def load_mfem(path: str) -> Mesh:
    """Parse an MFEM v1.0 mesh file with hex elements.

    Handles both plain meshes and periodic ones carrying a per-element
    ``nodes`` section (``L2_T1_3D_P1`` geometry), as in
    ``Meshes/wave-tank.mesh``.
    """
    with open(path) as f:
        tokens = _token_stream(f)
    return _parse_mfem(tokens)


def _token_stream(f: io.TextIOBase):
    toks = []
    for line in f:
        line = line.split("#", 1)[0].strip()
        if line:
            toks.extend(line.split())
    return iter(toks)


def _parse_mfem(tok) -> Mesh:
    def expect(word):
        while True:
            t = next(tok)
            if t == word:
                return
    expect("dimension")
    dim = int(next(tok))
    if dim != 3:
        raise NotImplementedError("only 3D hex meshes supported")
    expect("elements")
    ne = int(next(tok))
    elems = np.zeros((ne, 8), dtype=np.int64)
    for e in range(ne):
        _attr = int(next(tok))
        geom = int(next(tok))
        if geom != 5:
            raise NotImplementedError("only hexes (geom 5) supported")
        elems[e] = [int(next(tok)) for _ in range(8)]
    expect("boundary")
    nb = int(next(tok))
    bq = np.zeros((nb, 4), dtype=np.int64)
    ba = np.zeros(nb, dtype=np.int64)
    for b in range(nb):
        ba[b] = int(next(tok))
        geom = int(next(tok))
        if geom != 3:
            raise NotImplementedError("only quad boundary (geom 3) supported")
        bq[b] = [int(next(tok)) for _ in range(4)]
    expect("vertices")
    nv = int(next(tok))
    rest = list(tok)
    if rest and rest[0] == "nodes":
        # periodic mesh: per-element L2 P1 geometry
        i = rest.index("Ordering:") + 2
        vals = np.array([float(x) for x in rest[i:]])
        nodes = vals.reshape(ne, 8, 3)  # lex order, byNODES... Ordering 1 = byVDIM
        corner_coords = nodes[:, _HEX_VERT_LEX, :]
        # topological vertex coords: first occurrence per vertex id
        verts = np.zeros((nv, 3))
        flat_ids = elems.ravel()
        flat_xyz = corner_coords.reshape(-1, 3)
        # reversed so earliest occurrence wins
        verts[flat_ids[::-1]] = flat_xyz[::-1]
        # infer periodic axes: an axis is periodic iff some identified vertex
        # appears at two different coordinates along it
        vmax = np.full((nv, 3), -np.inf)
        vmin = np.full((nv, 3), np.inf)
        np.maximum.at(vmax, flat_ids, flat_xyz)
        np.minimum.at(vmin, flat_ids, flat_xyz)
        span = vmax - vmin
        axes = tuple(int(a) for a in range(3) if np.nanmax(span[:, a]) > 1e-10)
        return Mesh(verts, elems, corner_coords, bq, ba, periodic=True,
                    periodic_axes=axes)
    else:
        vdim = int(rest[0])
        vals = np.array([float(x) for x in rest[1:1 + nv * vdim]])
        verts = np.zeros((nv, 3))
        verts[:, :vdim] = vals.reshape(nv, vdim)
        return Mesh(verts, elems, verts[elems], bq, ba, periodic=False)


# ---------------------------------------------------------------------- Gmsh

def save_gmsh(mesh: Mesh, path: str) -> None:
    """Write the linear hexes of ``mesh`` and its boundary quads as a Gmsh
    v2.2 ASCII file (node ids from 1; hexes as element type 5, quads as
    type 3 with the boundary attribute as physical and elementary tag), the
    subset :func:`load_gmsh` reads. The topological vertices are written,
    so a periodic mesh loses its identification."""
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        f.write(f"$Nodes\n{mesh.n_verts}\n")
        for v in range(mesh.n_verts):
            f.write(f"{v + 1} " + " ".join(f"{c:.17g}" for c in mesh.verts[v])
                    + "\n")
        f.write("$EndNodes\n")
        nb = len(mesh.bdr_quads)
        f.write(f"$Elements\n{nb + mesh.n_elems}\n")
        for b in range(nb):
            a = int(mesh.bdr_attrs[b])
            f.write(f"{b + 1} 3 2 {a} {a} "
                    + " ".join(str(v + 1) for v in mesh.bdr_quads[b]) + "\n")
        for e in range(mesh.n_elems):
            f.write(f"{nb + e + 1} 5 2 1 1 "
                    + " ".join(str(v + 1) for v in mesh.elems[e]) + "\n")
        f.write("$EndElements\n")


def parse_gmsh_python(path: str):
    """The Python Gmsh v2.2 parser (``lpfem/mesh.py:556-593``): ``(verts
    [nn, 3], hexes [nh, 8], quads [nq, 4], qtags [nq])``, node ids remapped
    to 0..nn-1 in ascending id order, each quad's first tag (its physical
    group) as its attribute. The native scanner
    (``lpfem_torch.native.parse_gmsh``) computes the same."""
    with open(path) as f:
        lines = f.read().split("\n")
    i = 0
    nodes = {}
    elems, bq, ba = [], [], []
    while i < len(lines):
        line = lines[i].strip()
        if line == "$Nodes":
            n = int(lines[i + 1])
            for j in range(n):
                parts = lines[i + 2 + j].split()
                nodes[int(parts[0])] = [float(parts[1]), float(parts[2]),
                                        float(parts[3])]
            i += 2 + n
        elif line == "$Elements":
            n = int(lines[i + 1])
            for j in range(n):
                parts = [int(x) for x in lines[i + 2 + j].split()]
                etype, ntags = parts[1], parts[2]
                phys = parts[3] if ntags >= 1 else 0
                conn = parts[3 + ntags:]
                if etype == 5:          # 8-node hex (Gmsh order = MFEM's)
                    elems.append(conn)
                elif etype == 3:        # 4-node quad
                    bq.append(conn)
                    ba.append(phys)
            i += 2 + n
        else:
            i += 1
    node_ids = sorted(nodes)
    remap = {nid: k for k, nid in enumerate(node_ids)}
    verts = np.array([nodes[nid] for nid in node_ids])
    hexes = np.array([[remap[v] for v in e] for e in elems], dtype=np.int64)
    quads = (np.array([[remap[v] for v in q] for q in bq], dtype=np.int64)
             if bq else np.zeros((0, 4), dtype=np.int64))
    return verts, hexes, quads, np.array(ba, dtype=np.int64)


def load_gmsh(path: str) -> Mesh:
    """A Gmsh v2.2 ``.msh`` file with hex volume and quad boundary elements
    (``lpfem.mesh.load_gmsh``; MFEM's reader for
    ``Meshes/mesh_cylinder_half.msh``,
    ``Solvers/cylinder-diffraction.cpp:225``): physical surface tags become
    boundary attributes. Parsed by the native scanner
    (``lpfem_torch.native.parse_gmsh``, as lpfem wherever its native
    library is built)."""
    from .native import parse_gmsh
    verts, elems, bq, ba = parse_gmsh(path)
    return Mesh(verts, elems, verts[elems], bq, ba, periodic=False)


# face index -> (lattice axis normal to the face, side in {0, 1}); the order
# of HEX_FACES
_FACE_AXIS = ((2, 0), (1, 0), (0, 1), (1, 1), (0, 0), (2, 1))


def cylinder_projector(cx: float, cy: float, a: float):
    """Projection onto the vertical cylinder of radius ``a`` at (cx, cy)
    (``lpfem/mesh.py:601-611``)."""

    def proj(x: np.ndarray) -> np.ndarray:
        d = x[:, :2] - np.array([cx, cy])
        r = np.maximum(np.hypot(d[:, 0], d[:, 1]), 1e-300)
        out = x.copy()
        out[:, :2] = np.array([cx, cy]) + d * (a / r)[:, None]
        return out

    return proj


def set_curvature(mesh: Mesh, pg: int,
                  boundary_projectors: dict | None = None) -> None:
    """MFEM ``Mesh::SetCurvature(order)`` (``lpfem/mesh.py:614-681``): give
    ``mesh`` order-``pg`` geometry nodes interpolating its trilinear
    geometry, which is what MFEM does to a linear Gmsh import
    (``Solvers/cylinder-diffraction.cpp:263``: the rim stays faceted).

    ``boundary_projectors`` (lpfem's addition, ``{attr: fn(xyz [n, 3]) ->
    xyz}``) snaps the geometry nodes of the boundary faces with that
    attribute onto the true surface, the displacement blended linearly to
    zero at the opposite element face (:func:`cylinder_projector` makes an
    imported faceted rim exactly circular); the displacements of several
    projected faces of one element add up from the base geometry."""
    gll = basis_1d(pg).nodes
    pg1 = pg + 1
    L = pg1 ** 3
    W = trilinear_weights(pg)                                 # [L, 8]
    geom = np.einsum("lk,eki->eli", W, mesh.corner_coords)   # [ne, L, 3]

    if boundary_projectors:
        # boundary quad -> (owning element, local face)
        fq = np.sort(mesh.elems[:, HEX_FACES], axis=2)       # [ne, 6, 4]
        dt = np.dtype([("", fq.dtype)] * 4)
        flat = np.ascontiguousarray(fq.reshape(-1, 4)).view(dt).ravel()
        order = np.argsort(flat, kind="stable")
        keys = np.ascontiguousarray(np.sort(mesh.bdr_quads, axis=1)).view(
            dt).ravel()
        pos = np.searchsorted(flat, keys, sorter=order)
        hit = order[np.clip(pos, 0, len(flat) - 1)]
        if not np.all(flat[hit] == keys):
            raise ValueError("boundary quad not found among element faces")
        own_e, own_f = hit // 6, hit % 6

        lat = np.arange(L)
        lat3 = np.stack([lat % pg1, (lat // pg1) % pg1, lat // pg1 ** 2], 1)
        for b, attr in enumerate(mesh.bdr_attrs):
            projf = boundary_projectors.get(int(attr))
            if projf is None:
                continue
            e, f = int(own_e[b]), int(own_f[b])
            ax, side = _FACE_AXIS[f]
            # each lattice node's projection onto the face
            pinned = lat3.copy()
            pinned[:, ax] = side * pg
            fidx = pinned[:, 0] + pg1 * (pinned[:, 1] + pg1 * pinned[:, 2])
            base = np.einsum("lk,ki->li", W, mesh.corner_coords[e])
            disp = projf(base[fidx]) - base[fidx]            # [L, 3]
            xi = gll[lat3[:, ax]]
            wgt = xi if side == 1 else 1.0 - xi              # 1 at the face
            geom[e] += wgt[:, None] * disp

    mesh.geom_nodes = geom
    mesh.geom_order = pg
