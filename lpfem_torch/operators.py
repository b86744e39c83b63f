"""Laplace operators on the structured lattices, and the free-surface trace.

Counterpart of the parts of ``lpfem.operators`` the ported paths use:

- :class:`SeparableLattice` — the assembled tensor-product (Kronecker) form
  ``A = Mz (x) My (x) Kx + Mz (x) Ky (x) Mx + Kz (x) My (x) Mx`` of the
  stiffness on an axis-aligned tank grid (``lpfem.operators.
  SeparableLattice``). The 1D bands are assembled in float64 on the host,
  then cast to the operator dtype; applies go through the CUDA kernel
  ``kernels.sep_apply`` (its plain version on CPU tensors). ``diag`` is the
  assembled diagonal (``LaplacePA.diag``), ``constrained_rhs`` the
  ``FormLinearSystem`` elimination, ``assemble_scipy`` the sparse matrix the
  dense coarse solve inverts.
- :class:`ElementLaplace` — the element form of ``lpfem.operators.
  LaplacePA`` on a curved element lattice (:class:`~lpfem_torch.space.
  CurvedLatticeSpace`), the operator of every curved mesh: the gather of
  every element's dofs, the per-element apply ``kernels.pa_apply`` (CUDA
  port of B3b), the fold back. Metric ``G6q [ne, 6Q]`` in component-major
  layout (``lpfem/operators.py:544-545``) and ``Jr2 [3Q, L]`` are buffers.
- :class:`NodalZDerivative` — the free-surface trace of MFEM's nodal
  ``GetDerivative(1, 2, w)`` on z-extruded geometry, which reads only the top
  ``p+1`` dof planes (``NodalZDerivative.top_trace``).

The essential set is always the top z-plane (the free surface) here, so the
constrained forms take no index list.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch import nn

from .elements import basis_1d
from .geometry import geometric_factors, grad_interp_matrix, top_trace_geometry
from .kernels.pa_apply import pa_apply_element
from .kernels.sep_apply import sep_apply
from .space import LatticeSpace

__all__ = ["SeparableLattice", "ElementLaplace", "NodalZDerivative"]

BAND_NAMES = ("Kx", "Mx", "Ky", "My", "Kz", "Mz")


def _reference_matrices(p: int, q: int | None = None):
    """(Khat, Mhat) [p+1, p+1]: 1D stiffness and mass on the [0, 1]
    reference element with the q-point Gauss rule (default p+1)."""
    b = basis_1d(p, q)
    W = b.qwts
    return (b.D * W[:, None]).T @ b.D, (b.B * W[:, None]).T @ b.B


def _bands_1d(hs: np.ndarray, p: int, periodic: bool,
              loc: np.ndarray, stiff: bool) -> np.ndarray:
    """Assembled 1D factor in diagonal-offset form ``[2p+1, D]``
    (``out[p + s, i] = G[i, i + s]``), element contributions ``loc / h``
    (stiffness) or ``loc * h`` (mass) summed in element order."""
    ne = len(hs)
    D = ne * p + (0 if periodic else 1)
    out = np.zeros((2 * p + 1, D))
    ar = np.arange(p + 1)
    s = ar[None, :] - ar[:, None]                  # local offset j - i
    for e, he in enumerate(hs):
        blk = loc / he if stiff else loc * he
        rows = (e * p + ar) % D
        out[p + s, rows[:, None]] += blk
    return out


def _band_matrix(band: np.ndarray, periodic: bool) -> sp.csr_matrix:
    """Sparse [D, D] matrix of a diagonal-offset band table."""
    twop1, D = band.shape
    p = (twop1 - 1) // 2
    i = np.arange(D)
    rows, cols, vals = [], [], []
    for s in range(-p, p + 1):
        j = i + s
        ok = np.ones(D, bool) if periodic else (j >= 0) & (j < D)
        rows.append(i[ok])
        cols.append(j[ok] % D)
        vals.append(band[p + s, ok])
    return sp.csr_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(D, D))


class _LatticeOperator(nn.Module):
    """What the two operators share: the dof lattice, the device, and the
    top-plane (free-surface) elimination of ``FormLinearSystem``."""

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device

    def _plane(self, x: torch.Tensor) -> torch.Tensor:
        """[Dz, Dy*Dx] view of a flat dof vector."""
        return x.view(self.dof_dims[2], -1)

    def constrained_rhs(self, b: torch.Tensor, ess_vals: torch.Tensor):
        """(B, x_bc): eliminated right-hand side and boundary lift of the
        system with ``x = ess_vals`` on the top plane — ``B = b - A x_bc`` on
        free dofs, ``ess_vals`` on the plane."""
        x_bc = torch.zeros_like(b)
        self._plane(x_bc)[-1] = ess_vals
        B = b - self.apply(x_bc)
        self._plane(B)[-1] = ess_vals
        return B, x_bc


class SeparableLattice(_LatticeOperator):
    """Assembled Kronecker Laplace on a :class:`LatticeSpace`.

    Buffers ``Kx, Mx, Ky, My, Kz, Mz`` hold the 1D bands ``[2p+1, D_a]`` in
    ``dtype``; ``bands64`` keeps the float64 host tables.
    """

    def __init__(self, space: LatticeSpace, dtype: torch.dtype,
                 device, q: int | None = None):
        super().__init__()
        p = space.p
        if space.periodic[0] and space.dof_dims[0] <= 2 * p:
            raise ValueError("periodic x needs Dx > 2p (band offsets alias)")
        self.space = space
        self.p, self.q = p, (p + 1 if q is None else q)
        self.dof_dims = space.dof_dims
        self.periodic = space.periodic
        self.n_dofs = space.n_dofs
        self.dtype = dtype
        Khat, Mhat = _reference_matrices(p, self.q)
        hx, hy, hz = space.spacings
        px = space.periodic[0]
        self.bands64 = (_bands_1d(hx, p, px, Khat, True),
                        _bands_1d(hx, p, px, Mhat, False),
                        _bands_1d(hy, p, False, Khat, True),
                        _bands_1d(hy, p, False, Mhat, False),
                        _bands_1d(hz, p, False, Khat, True),
                        _bands_1d(hz, p, False, Mhat, False))
        for name, band in zip(BAND_NAMES, self.bands64):
            self.register_buffer(
                name, torch.tensor(band, dtype=torch.float64).to(
                    device=device, dtype=dtype))

    @property
    def bands(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, n) for n in BAND_NAMES)

    def _lattice(self, x: torch.Tensor) -> torch.Tensor:
        Dx, Dy, Dz = self.dof_dims
        return x.reshape(Dz, Dy, Dx)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x on the flat dof vector."""
        return sep_apply(self._lattice(x), self.bands,
                         self.periodic).reshape(-1)

    forward = apply

    def constrained_apply_top(self, x: torch.Tensor) -> torch.Tensor:
        """Apply with identity rows/cols on the top z-plane (the free-surface
        essential set)."""
        return sep_apply(self._lattice(x), self.bands, self.periodic,
                         ess_top=True).reshape(-1)

    def diag(self) -> torch.Tensor:
        """Assembled diagonal (MFEM ``OperatorJacobiSmoother`` source) from
        the centre bands, Mz0 (x) My0 (x) Kx0 + Mz0 (x) Ky0 (x) Mx0 +
        Kz0 (x) My0 (x) Mx0, in float64, then cast to the operator dtype."""
        Kx, Mx, Ky, My, Kz, Mz = (b[self.p] for b in self.bands64)
        d = (Mz[:, None, None] * My[None, :, None] * Kx[None, None, :]
             + Mz[:, None, None] * Ky[None, :, None] * Mx[None, None, :]
             + Kz[:, None, None] * My[None, :, None] * Mx[None, None, :])
        return torch.tensor(d.reshape(-1)).to(device=self.Kx.device,
                                              dtype=self.dtype)

    def assemble_scipy(self) -> sp.csr_matrix:
        """Assembled float64 sparse matrix (lattice order) from the bands."""
        px = self.periodic[0]
        Kx, Mx = (_band_matrix(b, px) for b in self.bands64[:2])
        Ky, My, Kz, Mz = (_band_matrix(b, False) for b in self.bands64[2:])
        return (sp.kron(Mz, sp.kron(My, Kx)) + sp.kron(Mz, sp.kron(Ky, Mx))
                + sp.kron(Kz, sp.kron(My, Mx))).tocsr()


def _fold_table(elem_dofs: np.ndarray, n: int) -> np.ndarray:
    """[n, m] int64: the positions of every dof's element copies in the
    flattened E-vector ``x[elem_dofs]``, in element order, padded with the
    position one past its end (m = the largest multiplicity, 8 on a hex
    lattice)."""
    flat = np.asarray(elem_dofs).ravel()
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=n)
    start = np.cumsum(counts) - counts
    table = np.full((n, counts.max()), flat.size, dtype=np.int64)
    table[flat[order], np.arange(flat.size) - start[flat[order]]] = order
    return table


def _fold(ye: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Assembled vector of the E-vector ``ye`` (transpose of the gather):
    every dof's copies gathered through :func:`_fold_table` (the pad reads
    an appended zero) and summed — three launches, and unlike a scatter-add
    with atomics the result does not depend on scheduling."""
    return F.pad(ye.reshape(-1), (0, 1))[table].sum(-1)


_SYM = ((0, 1, 2), (1, 3, 4), (2, 4, 5))   # G6 component of G[i][j]


class ElementLaplace(_LatticeOperator):
    """Element-form (partial assembly) Laplace on a curved element lattice:
    ``A x = scatter(pa_apply_element(gather(x)))`` — lpfem's
    ``LaplacePA.apply`` on a curved mesh (``lpfem/operators.py:689-700,
    760``), whose TPU kernel is B3b.

    The E-vector transfer is MFEM's element restriction: ``gather`` one
    index into ``elem_dofs``, ``scatter`` its transpose as a gather and a
    sum over each dof's copies (:func:`_fold`). lpfem's gather-free
    ``StructuredLattice`` cascade (``lpfem/operators.py:178-245``) works
    around the TPU's slow gathers; here its ~20 reshapes and strided adds
    per apply would be ~20 kernel launches, against one in and three
    back.

    Buffers, on ``device``: ``G6q [ne, 6Q]`` (the metric ``w |J| J^-1
    J^-T``, computed in float64 on the host and rounded once to ``dtype``,
    as lpfem's ``geometric_factors``), ``Jr2 [3Q, L]`` (gradient
    interpolation), ``B``/``D`` ``[q, p+1]`` (its 1D factors, which the
    sum-factorised kernel reads), ``free_e [ne, L]`` (0 on top-plane dofs),
    and the int64 ``elem_dofs [ne, L]``/``fold [n_dofs, 8]``. ``G64``
    keeps the float64 host metric for the assembled matrix.
    """

    def __init__(self, space, dtype: torch.dtype, device,
                 q: int | None = None):
        super().__init__()
        p = space.p
        q = p + 1 if q is None else q
        self.space = space
        self.p, self.q = p, q
        self.dof_dims = space.dof_dims
        self.periodic = space.periodic
        self.n_dofs = space.n_dofs
        self.dtype = dtype
        self.G64 = geometric_factors(space, q)               # [ne, Q, 6]
        ne, Q, _ = self.G64.shape
        b = basis_1d(p, q)

        def buf(a):
            return torch.tensor(a, dtype=torch.float64).to(device=device,
                                                           dtype=dtype)

        self.register_buffer("G6q", buf(self.G64.transpose(0, 2, 1)
                                        .reshape(ne, 6 * Q)))
        self.register_buffer("Jr2", buf(grad_interp_matrix(p, q)
                                        .reshape(3 * Q, -1)))
        self.register_buffer("B", buf(b.B))
        self.register_buffer("D", buf(b.D))
        ed = space.elem_dofs
        free = np.ones(space.n_dofs)
        free[space.top_plane_dofs()] = 0.0
        self.register_buffer("free_e", buf(free[ed]))
        self.register_buffer("elem_dofs", torch.as_tensor(ed, device=device))
        self.register_buffer("fold", torch.as_tensor(
            _fold_table(ed, space.n_dofs), device=device))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """[n_dofs] -> E-vector [ne, L] in lattice-major element order."""
        return x[self.elem_dofs]

    def scatter(self, ye: torch.Tensor) -> torch.Tensor:
        """E-vector [ne, L] -> assembled [n_dofs] (transpose of
        ``gather``)."""
        return _fold(ye, self.fold)

    def apply_local(self, x: torch.Tensor) -> torch.Tensor:
        """Per-element contributions [ne, L] (the E-vector, pre-fold)."""
        return pa_apply_element(self.gather(x), self.G6q, self.B, self.D)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x on the flat dof vector."""
        return self.scatter(self.apply_local(x))

    forward = apply

    def constrained_apply_top(self, x: torch.Tensor) -> torch.Tensor:
        """Apply with identity rows/cols on the top z-plane: the top plane
        of the input read as zero, the output's top plane set to the
        input's (``lpfem/operators.py:835-837``)."""
        y = self.scatter(pa_apply_element(self.gather(x) * self.free_e,
                                          self.G6q, self.B, self.D))
        self._plane(y)[-1] = self._plane(x)[-1]
        return y

    def diag(self) -> torch.Tensor:
        """Assembled diagonal in the operator dtype from the buffers, the
        sums of ``LaplacePA.diag`` (``lpfem/operators.py:789-796``)."""
        Q = self.q ** 3
        Jx, Jy, Jz = self.Jr2[:Q], self.Jr2[Q:2 * Q], self.Jr2[2 * Q:]
        G = self.G6q.view(-1, 6, Q)
        d_e = (G[:, 0] @ (Jx * Jx) + 2 * (G[:, 1] @ (Jx * Jy))
               + 2 * (G[:, 2] @ (Jx * Jz)) + G[:, 3] @ (Jy * Jy)
               + 2 * (G[:, 4] @ (Jy * Jz)) + G[:, 5] @ (Jz * Jz))
        return self.scatter(d_e)

    def element_matrices(self) -> torch.Tensor:
        """Dense element stiffness matrices [ne, L, L], float64 on the
        operator's device: ``sum_ij Jr_i^T diag(G_ij) Jr_j``
        (``lpfem/operators.py:869-886``)."""
        dev = self.device
        Jr = torch.tensor(grad_interp_matrix(self.p, self.q), device=dev)
        G = torch.tensor(self.G64, device=dev)                # [ne, Q, 6]
        A = None
        for i in range(3):
            for j in range(3):
                t = Jr[i].T @ (G[:, :, _SYM[i][j], None] * Jr[j])
                A = t if A is None else A + t
        return A

    def assemble_scipy(self) -> sp.csr_matrix:
        """Assembled float64 sparse matrix (lattice order), duplicates
        summed (``lpfem/operators.py:888-898``)."""
        Ae = self.element_matrices().cpu().numpy()
        ed = self.space.elem_dofs
        L = ed.shape[1]
        rows = np.repeat(ed, L, axis=1).ravel()
        cols = np.tile(ed, (1, L)).ravel()
        return sp.coo_matrix((Ae.ravel(), (rows, cols)),
                             shape=(self.n_dofs, self.n_dofs)).tocsr()


class NodalZDerivative(nn.Module):
    """Free-surface trace of MFEM's nodal ``GetDerivative(1, 2, w)``: the
    per-element nodal z-derivative averaged over the elements that share a
    node (``Solvers/PF_linear_serial.cpp:175,268``), on the top plane, in
    surface (lattice) order. Only the top element layer reaches the plane,
    so only the top ``p+1`` dof planes are read.

    - On z-extruded geometry (always on a :class:`LatticeSpace`, where
      ``jz = 1 / hz`` of the top layer; on a curved lattice when lpfem's
      extrusion check passes, ``geometry.top_trace_geometry``) the average
      collapses: ``w = jz * sum_m Dn[p, m] phi[z = Dz-1-p+m]``
      (``NodalZDerivative.top_trace``).
    - Otherwise the nodal derivative of every top-layer element at its top
      face, ``sum_i dxi_i/dz * dphi/dxi_i``, folded onto the plane and
      divided by the node multiplicity — lpfem's full ``__call__`` path
      (``lpfem/operators.py:1051-1073``) restricted to the plane.
    """

    def __init__(self, space, dtype: torch.dtype, device):
        super().__init__()
        p = space.p
        self.p, self.p1 = p, p + 1
        self.dof_dims = space.dof_dims
        Dn = basis_1d(p).Dn

        def buf(a):
            return torch.tensor(a, dtype=torch.float64).to(device=device,
                                                           dtype=dtype)

        if isinstance(space, LatticeSpace):
            self.jz, Jz_face = float(1.0 / space.spacings[2][-1]), None
        else:
            self.jz, Jz_face = top_trace_geometry(
                space, 1e-6 if dtype == torch.float32 else 1e-12)
        self.register_buffer("dn", buf(Dn[p]))
        if self.jz is None:
            Dx, Dy, Dz = space.dof_dims
            nte = space.elem_dims[0] * space.elem_dims[1]
            # top-layer element dofs within the top p+1 planes, and their
            # top faces within the top plane
            top = space.elem_dofs[-nte:] - (Dz - self.p1) * Dx * Dy
            face = top.reshape(nte, self.p1, -1)[:, p] - p * Dx * Dy
            self.register_buffer("top_dofs", torch.as_tensor(top,
                                                             device=device))
            self.register_buffer("fold", torch.as_tensor(
                _fold_table(face, Dx * Dy), device=device))
            self.register_buffer("Dn", buf(Dn))
            self.register_buffer("jz_face", buf(Jz_face))
            self.register_buffer("inv_mult_top", buf(
                1.0 / space.node_mult[space.top_plane_dofs()]))

    def top_trace(self, x: torch.Tensor) -> torch.Tensor:
        Dx, Dy, Dz = self.dof_dims
        xs = x.reshape(Dz, Dy * Dx)[Dz - self.p1:]
        if self.jz is not None:
            return self.jz * (self.dn @ xs)
        p, p1 = self.p, self.p1
        u = xs.reshape(-1)[self.top_dofs].view(-1, p1, p1, p1)
        top = u[:, p]                                       # [e, y, x]
        gx = top @ self.Dn.T
        gy = self.Dn @ top
        gz = torch.einsum("m,emyx->eyx", self.dn, u)
        Jz = self.jz_face.view(-1, p1, p1, 3)
        w = Jz[..., 0] * gx + Jz[..., 1] * gy + Jz[..., 2] * gz
        return _fold(w, self.fold) * self.inv_mult_top

    forward = top_trace
