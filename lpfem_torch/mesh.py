"""Hexahedral mesh record (host NumPy): the fields a mesh generator fills.

Counterpart of ``lpfem.mesh.Mesh`` (``lpfem/mesh.py:82-116``) without the
refinement, the file parsers and the periodic-vertex machinery: the port
builds its meshes from generators that declare a logical element lattice
(``lpfem_torch.cylmesh``). Hex local vertex order is MFEM/VTK's:

  0:(0,0,0) 1:(1,0,0) 2:(1,1,0) 3:(0,1,0) 4:(0,0,1) 5:(1,0,1) 6:(1,1,1) 7:(0,1,1)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .elements import basis_1d

__all__ = ["Mesh", "HEX_VERTS", "trilinear_weights"]

# Lattice coordinates (ix, iy, iz in {0, 1}) of the 8 hex vertices.
HEX_VERTS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    dtype=np.int64,
)


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
                n = ix + p1 * (iy + p1 * iz)
                xi = np.array([gll[ix], gll[iy], gll[iz]])
                for v, (vx, vy, vz) in enumerate(HEX_VERTS):
                    W[n, v] = ((xi[0] if vx else 1 - xi[0])
                               * (xi[1] if vy else 1 - xi[1])
                               * (xi[2] if vz else 1 - xi[2]))
    return W


@dataclass
class Mesh:
    verts: np.ndarray          # [nv, 3] topological vertex positions
    elems: np.ndarray          # [ne, 8] MFEM hex vertex order
    corner_coords: np.ndarray  # [ne, 8, 3] geometric corner positions
    bdr_quads: np.ndarray      # [nb, 4] cyclic vertex quads
    bdr_attrs: np.ndarray      # [nb]
    periodic: bool = False
    # optional high-order geometry nodes [ne, (pg+1)^3, 3], lattice-lex
    # order (x fastest); None -> trilinear from the corners
    geom_nodes: np.ndarray | None = None
    geom_order: int = 1
    periodic_axes: tuple = ()
    # logical lattice declared by the generator: integer element coordinates
    # [ne, 3] on a (nex, ney, nez) grid, element axes aligned with it
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
