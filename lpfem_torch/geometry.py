"""Geometric factors of the element-form Laplace operator (host NumPy, f64).

Counterpart of ``lpfem/operators.py:45-175``: the quadrature-point Jacobians
of the isoparametric geometry (curved nodes when the mesh has them, else the
trilinear corner lattice), the symmetric metric ``G = w |J| J^-1 J^-T`` in
its six unique components (or, on affine elements, its six constants per
element), the reference-gradient interpolation matrix, and the z-column of
the inverse Jacobian at the element nodes that the free-surface trace reads.
Inverted geometry raises.
"""

from __future__ import annotations

import numpy as np

from .elements import basis_1d, lagrange_eval

__all__ = ["affine_c6", "geometric_factors", "grad_interp_matrix",
           "quad_geometry", "surface_elements", "top_trace_geometry"]

_GEOM_CHUNK = 1 << 16   # elements per host chunk (bounds the [*,Q,3,3] temps)


def _t3(u, Az, Ay, Ax):
    return np.einsum("cz,by,ax,ezyxd->ecbad", Az, Ay, Ax, u, optimize=True)


def _jacobian_chunk(cc, B1, D1, q):
    """Quad-point Jacobians for one element chunk: cc [m, pg1, pg1, pg1, 3]
    -> (J [m, Q, 3, 3], detJ, Jinv). Raises on inverted geometry."""
    J = np.stack([_t3(cc, B1, B1, D1), _t3(cc, B1, D1, B1),
                  _t3(cc, D1, B1, B1)], axis=-1)
    m = J.shape[0]
    J = J.reshape(m, q ** 3, 3, 3)
    detJ = np.linalg.det(J)
    if np.any(detJ <= 0):
        raise ValueError("non-positive Jacobian determinant in mesh geometry")
    Jinv = np.linalg.inv(J)     # Jinv[i,j] = dxi_i/dx_j
    return J, detJ, Jinv


def _metric6_chunk(detJ, Jinv):
    """G/w3 at quad points: the 6 unique components of detJ * Jinv Jinv^T,
    order (xx, xy, xz, yy, yz, zz) — [m, Q, 6]."""
    M = np.einsum("eqik,eqjk->eqij", Jinv, Jinv) * detJ[..., None, None]
    return np.stack([M[..., 0, 0], M[..., 0, 1], M[..., 0, 2],
                     M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]], axis=-1)


def affine_c6(space, q: int, dtype) -> np.ndarray | None:
    """C6 [ne, 6] float64 when every element is affine: the quad-point
    metric is then ``G[e, q] = w3[q] C6[e]`` with ``w3`` the products of the
    Gauss weights, 6 numbers per element instead of 6 q^3. None when the
    metric varies inside some element by more than 1e-6 (``dtype`` float32)
    or 1e-12 (float64) of its largest entry, the dtype-tied tolerance of
    ``lpfem.operators.affine_c6`` (``lpfem/operators.py:94-121``)."""
    gnodes, pg = space.geometry_lattice()
    bg = basis_1d(pg, q)
    pg1 = pg + 1
    cc = gnodes.reshape(-1, pg1, pg1, pg1, 3)
    ne = cc.shape[0]
    C6 = np.empty((ne, 6))
    gmax = rmax = 0.0
    for s in range(0, ne, _GEOM_CHUNK):
        _, detJ, Jinv = _jacobian_chunk(cc[s:s + _GEOM_CHUNK], bg.B, bg.D, q)
        M6 = _metric6_chunk(detJ, Jinv)
        C6[s:s + _GEOM_CHUNK] = M6[:, 0, :]
        gmax = max(gmax, float(np.max(np.abs(M6))))
        rmax = max(rmax, float(np.max(np.abs(M6 - M6[:, :1, :]))))
    afftol = 1e-6 if np.dtype(dtype) == np.float32 else 1e-12
    return None if rmax > afftol * gmax else C6


def geometric_factors(space, q: int | None = None) -> np.ndarray:
    """G [ne, Q, 6] float64, Q = q^3 points flattened C-order over
    (qz, qy, qx), elements in the space's lattice-major order
    (``lpfem.operators.geometric_factors``, its ``G``)."""
    p = space.p
    if q is None:
        q = p + 1
    qw = basis_1d(p, q).qwts
    gnodes, pg = space.geometry_lattice()
    bg = basis_1d(pg, q)
    pg1 = pg + 1
    cc = gnodes.reshape(-1, pg1, pg1, pg1, 3)   # [ne, z, y, x, 3]
    ne = cc.shape[0]
    w3 = np.einsum("c,b,a->cba", qw, qw, qw).reshape(-1)
    G = np.empty((ne, q ** 3, 6))
    for s in range(0, ne, _GEOM_CHUNK):
        _, detJ, Jinv = _jacobian_chunk(cc[s:s + _GEOM_CHUNK], bg.B, bg.D, q)
        G[s:s + _GEOM_CHUNK] = w3[None, :, None] * _metric6_chunk(detJ, Jinv)
    return G


def quad_geometry(space, q: int) -> tuple[np.ndarray, np.ndarray]:
    """(wdetJ [ne, Q], xq [ne, Q, 3]) float64: the Gauss weight times
    |J| and the physical coordinates at the q^3 points of every element,
    (qz, qy, qx) C-order, elements in the space's order — the error-norm
    tables of ``lpfem.operators.geometric_factors``
    (``lpfem/operators.py:123-163``)."""
    qw = basis_1d(space.p, q).qwts
    gnodes, pg = space.geometry_lattice()
    bg = basis_1d(pg, q)
    pg1 = pg + 1
    cc = gnodes.reshape(-1, pg1, pg1, pg1, 3)
    w3 = np.einsum("c,b,a->cba", qw, qw, qw).reshape(-1)
    wdetJ = np.empty((cc.shape[0], q ** 3))
    for s in range(0, cc.shape[0], _GEOM_CHUNK):
        _, detJ, _ = _jacobian_chunk(cc[s:s + _GEOM_CHUNK], bg.B, bg.D, q)
        wdetJ[s:s + _GEOM_CHUNK] = detJ * w3[None, :]
    B3 = np.einsum("cz,by,ax->cbazyx", bg.B, bg.B, bg.B).reshape(q ** 3,
                                                                 pg1 ** 3)
    return wdetJ, np.einsum("qk,ekd->eqd", B3, gnodes)


def grad_interp_matrix(p: int, q: int) -> np.ndarray:
    """Jr [3, q^3, (p+1)^3]: reference-gradient interpolation, C-order
    (z, y, x) (``lpfem.operators._grad_interp_matrix``)."""
    b = basis_1d(p, q)
    B, D = b.B, b.D
    g_x = np.einsum("cz,by,ax->cbazyx", B, B, D)
    g_y = np.einsum("cz,by,ax->cbazyx", B, D, B)
    g_z = np.einsum("cz,by,ax->cbazyx", D, B, B)
    L = (p + 1) ** 3
    Q = q ** 3
    return np.stack([g.reshape(Q, L) for g in (g_x, g_y, g_z)], axis=0)


def surface_elements(space, ess) -> np.ndarray:
    """Sorted ids of the elements that hold at least one of the dofs
    ``ess`` (the top element layer of a tank)."""
    on = np.zeros(space.n_dofs, dtype=bool)
    on[np.asarray(ess)] = True
    return np.flatnonzero(on[space.elem_dofs].any(axis=1))


def top_trace_geometry(space, dtype_tol: float = 1e-12, elems=None):
    """(jz, Jz) for the free-surface trace of the nodal z-derivative
    (``lpfem.operators.NodalZDerivative``, ``:911-1014``), over the elements
    ``elems`` (default: those that touch the free surface; lpfem tests all
    elements, but only these reach the trace).

    ``Jz``: the inverse-Jacobian z-column ``(dxi/dz, deta/dz, dzeta/dz)`` at
    the element nodes, ``[m, (p+1)^3, 3]``, or ``[m, 1, 3]`` when it is
    constant inside every element to ``dtype_tol`` of its max (lpfem's
    compact ``Jz3``, affine elements).

    ``jz``: ``dzeta/dz`` of the layer when lpfem's extrusion check passes —
    the column constant inside every element, in-plane parts <= 1e-13 of its
    scale and one ``jz`` across the layer (``_detect_top``) — so that the
    trace reduces to ``jz * sum_m Dn[p, m] phi[z = Dz-1-p+m]``; else None,
    where lpfem takes its full nodal-derivative path. (Round-off alone can
    fail the first test: on the 4,224-hex cylinder tank the column varies
    by 1.9e-12 of its scale.)"""
    if elems is None:
        elems = surface_elements(space, space.top_plane_dofs())
    p1 = space.p + 1
    b = basis_1d(space.p)
    gnodes, pg = space.geometry_lattice()
    B1n, D1n = lagrange_eval(basis_1d(pg).nodes, b.nodes)
    pg1 = pg + 1
    cc = gnodes[elems].reshape(-1, pg1, pg1, pg1, 3)
    J = np.stack([_t3(cc, B1n, B1n, D1n), _t3(cc, B1n, D1n, B1n),
                  _t3(cc, D1n, B1n, B1n)], axis=-1).reshape(
                      len(cc), p1 ** 3, 3, 3)
    Jz = np.linalg.inv(J)[..., 2]                               # [m, L, 3]
    if np.max(np.abs(Jz - Jz[:, :1, :])) > dtype_tol * np.max(np.abs(Jz)):
        return None, Jz
    Jz = Jz[:, :1, :]
    scale = np.max(np.abs(Jz[..., 2]))
    if (scale == 0.0 or np.max(np.abs(Jz[..., :2])) > 1e-13 * scale
            or np.ptp(Jz[..., 2]) > 1e-13 * scale):
        return None, Jz
    return float(Jz[0, 0, 2]), Jz
