"""Laplace operators, the rule that picks one for a space, and the
free-surface trace.

Counterpart of ``lpfem.operators``. lpfem's ``LaplacePA`` chooses between
four applies inside one class; here each is a class and
:func:`laplace_operator` applies lpfem's rule (``lpfem/operators.py:532-548,
601-645, 742-760``), minus the TPU's lane rules:

1. :class:`SeparableLattice` — an axis-aligned box lattice with separable
   spacings: the assembled tensor-product (Kronecker) form
   ``A = Mz (x) My (x) Kx + Mz (x) Ky (x) Mx + Kz (x) My (x) Mx``
   (``lpfem.operators.SeparableLattice``), 1D bands assembled in float64 on
   the host; applies go through the CUDA kernel ``kernels.sep_apply`` (B1).
2. :class:`AffineLatticeLaplace` — any other lattice of affine elements
   (sheared or rotated tanks), y and z not periodic: the whole element-form
   apply in one fused CUDA kernel, ``kernels.lattice_apply`` (B2).
3. :class:`ElementLaplace` with the affine metric ``C6 [ne, 6]`` — affine
   elements without a usable lattice (z-extruded or unstructured meshes from
   files): gather, ``kernels.pa_apply.pa_apply_affine`` (B3a), fold.
4. :class:`ElementLaplace` with the full metric ``G6q [ne, 6Q]`` — curved
   elements: gather, ``kernels.pa_apply.pa_apply_element`` (B3b), fold.

That rule is lpfem's ``apply_mode="pallas"`` (the default). The other
modes, as lpfem's ``LaplacePA(mode=...)`` (``lpfem/operators.py:527-548,
689-760``):

- ``"fused"``: the Kronecker form on a separable grid (1., B1 on the card,
  the function of lpfem's XLA ``sep.apply``); elsewhere
  :class:`ElementLaplace` with lpfem's element-local form, one ``[E, L] @
  [L, 3Q]`` product, the metric and the transposed product;
- ``"sumfact"``: :class:`ElementLaplace` with the element-local
  sum-factorised einsums on every mesh, separable grids included.

The products of those two forms are XLA code in lpfem, outside any Pallas
kernel, and ``torch.matmul`` / ``torch.einsum`` carry them here; they run
only where the mode asks for them. ``"assembled"`` (lpfem's
``PF_linear_par`` configuration) is :class:`AssembledLaplace`, a sparse
matrix assembled from an operator's element matrices, which the solve uses
in place of the operator.

Every wrapper takes its kernel's plain version on CPU tensors. All classes
share ``apply``, ``constrained_apply_top`` (identity rows and columns on the
free-surface dofs ``space.top_plane_dofs()``), ``constrained_apply`` (the
same on any essential list; the top plane takes the route above),
``constrained_rhs``, ``diag``, ``assemble_scipy`` and the error norms
``interp_quad`` / ``l2_norm_sq`` / ``l2_error`` (MFEM ``ComputeL2Error``).

:class:`NodalZDerivative` is the free-surface trace of MFEM's nodal
``GetDerivative(1, 2, w)``, :func:`nodal_z_derivative` the same derivative
at every dof.
"""

from __future__ import annotations

import warnings
from functools import cached_property

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch import nn

from .ds import DS
from .elements import basis_1d
from .geometry import (affine_c6, geometric_factors, grad_interp_matrix,
                       quad_geometry, surface_elements, top_trace_geometry)
from .kernels.lattice_apply import lattice_affine_apply
from .kernels.pa_apply import (pa_apply_affine, pa_apply_affine_reference,
                               pa_apply_element, pa_apply_element_reference)
from .kernels.sep_apply import sep_apply
from .mesh import HEX_VERTS
from .profiling import detail, recording
from .space import LatticeSpace

__all__ = ["SeparableLattice", "AffineLatticeLaplace", "ElementLaplace",
           "AssembledLaplace", "NodalZDerivative", "nodal_z_derivative",
           "laplace_operator", "separable_spacings", "APPLY_MODES"]

BAND_NAMES = ("Kx", "Mx", "Ky", "My", "Kz", "Mz")
APPLY_MODES = ("pallas", "fused", "sumfact")   # the operator's own modes


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


def _strided_slice(idx: np.ndarray) -> slice | None:
    """``idx`` (sorted) as a slice, when it is an arithmetic progression."""
    if len(idx) == 1:
        return slice(int(idx[0]), int(idx[0]) + 1)
    step = int(idx[1] - idx[0])
    if step > 0 and np.array_equal(idx, idx[0] + step * np.arange(len(idx))):
        return slice(int(idx[0]), int(idx[-1]) + 1, step)
    return None


class _Operator(nn.Module):
    """What the operators share: the space, the device, and the
    free-surface elimination of ``FormLinearSystem``. ``mode`` is the
    apply mode :func:`laplace_operator` built it for (multigrid levels take
    the fine operator's, as lpfem's)."""

    mode = "pallas"

    def _init_common(self, space, dtype: torch.dtype, q: int | None) -> None:
        self.space = space
        self.p, self.q = space.p, (space.p + 1 if q is None else q)
        self.n_dofs = space.n_dofs
        self.dtype = dtype

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device

    @cached_property
    def ess(self) -> torch.Tensor:
        """The free-surface dofs ``space.top_plane_dofs()``, on the device."""
        return torch.as_tensor(self.space.top_plane_dofs(),
                               device=self.device)

    def _is_top(self, ess: torch.Tensor) -> bool:
        """Whether the essential list ``ess`` is the free-surface set
        ``space.top_plane_dofs()`` in some order; read on the host once per
        list object (the last one is remembered)."""
        seen = self.__dict__.get("_top_seen")
        if seen is None or seen[0] is not ess:
            top = self.space.top_plane_dofs()
            got = np.sort(ess.detach().cpu().numpy())
            seen = (ess, bool(np.array_equal(got, top)))
            self.__dict__["_top_seen"] = seen
        return seen[1]

    def constrained_apply(self, x: torch.Tensor,
                          ess: torch.Tensor) -> torch.Tensor:
        """Apply with identity rows/cols on the essential dofs ``ess`` (the
        operator ``FormLinearSystem`` produces; ``lpfem/operators.py:
        820-837``): ``x`` read as zero there, the output set to ``x``. On
        the free-surface set this is :meth:`constrained_apply_top` (the
        kernels' ``ess_top`` route)."""
        if self._is_top(ess):
            return self.constrained_apply_top(x)
        x0 = x.clone()
        x0[ess] = 0.0
        y = self.apply(x0)
        y[ess] = x[ess]
        return y

    def constrained_rhs(self, b: torch.Tensor, ess_vals: torch.Tensor,
                        ess: torch.Tensor | None = None):
        """(B, x_bc): eliminated right-hand side and boundary lift of the
        system with ``x[ess] = ess_vals`` — ``B = b - A x_bc`` on free dofs,
        ``ess_vals`` on the essential ones (``lpfem.operators.LaplacePA.
        constrained_rhs``). ``ess``: the free-surface dofs in the order of
        ``ess_vals`` (default: sorted, the lattice order of a top plane)."""
        ess = self.ess if ess is None else ess
        x_bc = torch.zeros_like(b)
        x_bc[ess] = ess_vals
        B = b - self.apply(x_bc)
        B[ess] = ess_vals
        return B, x_bc

    # ------------------------------------------------------------------ norms
    @cached_property
    def _quad(self):
        """(elem_dofs, B, wdetJ) on the device in the operator dtype, and
        xq [ne, Q, 3] float64 on the host: the space's element table and the
        q-point Gauss geometry (built at first use)."""
        wdetJ, xq = quad_geometry(self.space, self.q)
        dev = self.device
        return (torch.as_tensor(self.space.elem_dofs, device=dev),
                torch.tensor(basis_1d(self.p, self.q).B).to(
                    device=dev, dtype=self.dtype),
                torch.tensor(wdetJ).to(device=dev, dtype=self.dtype), xq)

    def interp_quad(self, x: torch.Tensor) -> torch.Tensor:
        """Field values at the quadrature points, [ne, Q]
        (``lpfem/operators.py:849-854``)."""
        ed, B, _, _ = self._quad
        p1 = self.p + 1
        u = x[ed].view(-1, p1, p1, p1)
        v = torch.einsum("cz,by,ax,ezyx->ecba", B, B, B, u)
        return v.reshape(u.shape[0], self.q ** 3)

    def l2_norm_sq(self, x: torch.Tensor) -> torch.Tensor:
        v = self.interp_quad(x)
        return torch.sum(self._quad[2] * v * v)

    def l2_error(self, x: torch.Tensor, exact_fn) -> torch.Tensor:
        """L2 error against ``exact_fn(xq, yq, zq)`` (NumPy, float64) at the
        quadrature points (MFEM ``ComputeL2Error`` semantics;
        ``lpfem/operators.py:860-867``)."""
        _, _, wdetJ, xq = self._quad
        v = self.interp_quad(x)
        ex = torch.tensor(np.asarray(exact_fn(xq[..., 0], xq[..., 1],
                                              xq[..., 2]))).to(v)
        d = v - ex
        return torch.sqrt(torch.sum(wdetJ * d * d))


def separable_spacings(space):
    """(hx, hy, hz) per-element widths when the space is a lattice of
    axis-aligned boxes whose widths depend only on their own axis index —
    the test of ``lpfem.operators.SeparableLattice.build``
    (``lpfem/operators.py:346-380``) — else None."""
    if isinstance(space, LatticeSpace):
        return space.spacings
    if space.dof_dims is None or space.periodic[1] or space.periodic[2]:
        return None
    mesh = space.mesh
    if mesh.geom_nodes is not None and mesh.geom_order > 1:
        return None              # the corners cannot vouch for curved interiors
    nex, ney, nez = space.elem_dims
    if any(d <= 2 * space.p and per
           for d, per in zip(space.dof_dims, space.periodic)):
        return None              # band offsets would alias mod D
    cc = np.asarray(mesh.corner_coords).reshape(nez, ney, nex, 8, 3)
    lo, hi = cc.min(axis=3), cc.max(axis=3)
    h = hi - lo                                    # [nez, ney, nex, 3]
    box = lo[..., None, :] + HEX_VERTS.astype(np.float64) * h[..., None, :]
    tol = 1e-12 * (np.max(np.abs(cc)) + np.max(h))
    if np.max(np.abs(cc - box)) > tol:
        return None              # sheared / curved elements
    for a, ax in ((0, (0, 1)), (1, (0, 2)), (2, (1, 2))):
        if np.max(np.ptp(h[..., a], axis=ax)) > tol:
            return None
    return h[0, 0, :, 0], h[0, :, 0, 1], h[:, 0, 0, 2]


class SeparableLattice(_Operator):
    """Assembled Kronecker Laplace on a lattice of axis-aligned boxes: a
    :class:`LatticeSpace`, or a mesh-based lattice space with the
    ``spacings`` that :func:`separable_spacings` found.

    Buffers ``Kx, Mx, Ky, My, Kz, Mz`` hold the 1D bands ``[2p+1, D_a]`` in
    ``dtype``; ``bands64`` keeps the float64 host tables.
    """

    def __init__(self, space, dtype: torch.dtype, device,
                 q: int | None = None, spacings=None):
        super().__init__()
        self._init_common(space, dtype, q)
        p = self.p
        if space.periodic[0] and space.dof_dims[0] <= 2 * p:
            raise ValueError("periodic x needs Dx > 2p (band offsets alias)")
        self.dof_dims = space.dof_dims
        self.periodic = space.periodic
        Khat, Mhat = _reference_matrices(p, self.q)
        hx, hy, hz = space.spacings if spacings is None else spacings
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
    lattice). Negative entries of ``elem_dofs`` have no dof and are left
    out."""
    flat = np.asarray(elem_dofs).ravel()
    pos = np.flatnonzero(flat >= 0)
    dof = flat[pos]
    order = np.argsort(dof, kind="stable")
    counts = np.bincount(dof, minlength=n)
    start = np.cumsum(counts) - counts
    table = np.full((n, counts.max()), flat.size, dtype=np.int64)
    table[dof[order], np.arange(dof.size) - start[dof[order]]] = pos[order]
    return table


def _fold(ye: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Assembled vector of the E-vector ``ye`` (transpose of the gather):
    every dof's copies gathered through :func:`_fold_table` (the pad reads
    an appended zero) and summed — three launches, and unlike a scatter-add
    with atomics the result does not depend on scheduling."""
    return F.pad(ye.reshape(-1), (0, 1))[table].sum(-1)


_SYM = ((0, 1, 2), (1, 3, 4), (2, 4, 5))   # G6 component of G[i][j]


def sumfact_local(u: torch.Tensor, C6: torch.Tensor | None,
                  w3: torch.Tensor | None, G6q: torch.Tensor | None,
                  B: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """lpfem's sum-factorised element apply (``mode="sumfact"``,
    ``lpfem/operators.py:715-740``): the reference gradient by 1D
    contractions, the metric (affine ``w3[k] C6[e]``, or the full ``G6q
    [ne, 6Q]``), and the transposed contractions. lpfem writes each
    direction as one four-operand einsum that XLA factors; here the
    contractions are taken one axis at a time, the x and y partials shared
    between the three gradient components (eight contractions each way)."""
    ne = u.shape[0]
    q, p1 = B.shape
    Q = q ** 3
    uz = u.reshape(ne, p1, p1, p1)                           # [e, z, y, x]

    def x(A, v):
        return torch.einsum("ax,ezyx->ezya", A, v)

    def y(A, v):
        return torch.einsum("by,ezya->ezba", A, v)

    def z(A, v):
        return torch.einsum("cz,ezba->ecba", A, v).reshape(ne, Q)

    ub, ud = x(B, uz), x(D, uz)
    gx, gy, gz = z(B, y(B, ud)), z(B, y(D, ub)), z(D, y(B, ub))
    if C6 is not None:
        cx, cxy, cxz, cy, cyz, cz = (C6[:, i:i + 1] for i in range(6))
        h = ((cx * gx + cxy * gy + cxz * gz) * w3,
             (cxy * gx + cy * gy + cyz * gz) * w3,
             (cxz * gx + cyz * gy + cz * gz) * w3)
    else:
        G = [G6q[:, i * Q:(i + 1) * Q] for i in range(6)]
        h = (G[0] * gx + G[1] * gy + G[2] * gz,
             G[1] * gx + G[3] * gy + G[4] * gz,
             G[2] * gx + G[4] * gy + G[5] * gz)

    def zt(A, v):
        return torch.einsum("cz,ecba->ezba", A, v.reshape(ne, q, q, q))

    def yt(A, v):
        return torch.einsum("by,ezba->ezya", A, v)

    def xt(A, v):
        return torch.einsum("ax,ezya->ezyx", A, v)

    out = (xt(D, yt(B, zt(B, h[0])))
           + xt(B, yt(D, zt(B, h[1])) + yt(B, zt(D, h[2]))))
    return out.reshape(ne, p1 ** 3)


class ElementLaplace(_Operator):
    """Element-form (partial assembly) Laplace on any space:
    ``A x = scatter(apply_local(gather(x)))`` — lpfem's ``LaplacePA.apply``
    through its element kernels (``lpfem/operators.py:689-700, 760``).

    The metric is full (``C6=None``: ``G6q [ne, 6Q]``, curved elements, TPU
    kernel B3b) or affine (``C6 [ne, 6]`` from ``geometry.affine_c6`` with
    the Gauss-weight products ``w3 [Q]``, TPU kernel B3a).

    The E-vector transfer is MFEM's element restriction: ``gather`` one
    index into ``elem_dofs``, ``scatter`` its transpose as a gather and a
    sum over each dof's copies (:func:`_fold`). lpfem has three transfers
    that avoid the TPU's slow gathers — the ``StructuredLattice`` cascade of
    reshapes and strided adds, the ``ColumnLattice`` column gather with
    z-unfolds on extruded meshes, and the plain index on the rest
    (``lpfem/operators.py:178-283, 680-687, 762-769``). Here all three are
    this one pair of index tables over the space's own numbering (lattice,
    column or topological): one launch in and three back, where the
    cascades would be ~20.

    ``mode`` picks the element-local apply: ``"pallas"`` the CUDA kernels
    B3a / B3b, ``"fused"`` lpfem's two dense products in plain PyTorch (the
    kernels' plain versions), ``"sumfact"`` lpfem's sum-factorised einsums
    (:func:`sumfact_local`).

    Buffers, on ``device``: the metric (computed in float64 on the host and
    rounded once to ``dtype``, as lpfem's), ``Jr2 [3Q, L]`` (gradient
    interpolation), ``B``/``D`` ``[q, p+1]`` (its 1D factors, which the
    sum-factorised kernels read). The int64 ``elem_dofs [ne, L]`` /
    ``fold [n_dofs, m]`` and the mask ``free_e [ne, L]`` (0 on free-surface
    dofs) are made on the device at first use. ``G64`` / ``C64`` keep the
    float64 host metric for the assembled matrix.
    """

    def __init__(self, space, dtype: torch.dtype, device,
                 q: int | None = None, C6: np.ndarray | None = None,
                 mode: str = "pallas"):
        super().__init__()
        if mode not in APPLY_MODES:
            raise ValueError(f"unknown apply mode {mode!r}")
        self._init_common(space, dtype, q)
        self.mode = mode
        self.dof_dims = space.dof_dims
        self.periodic = space.periodic
        p, q = self.p, self.q
        b = basis_1d(p, q)
        self.C64 = C6
        self.G64 = None if C6 is not None else geometric_factors(space, q)

        def buf(a):
            return torch.tensor(a, dtype=torch.float64).to(device=device,
                                                           dtype=dtype)

        if C6 is not None:
            self.register_buffer("C6", buf(C6))
            self.register_buffer("w3", buf(np.einsum(
                "c,b,a->cba", b.qwts, b.qwts, b.qwts).reshape(-1)))
        else:
            ne, Q, _ = self.G64.shape                        # [ne, Q, 6]
            self.register_buffer("G6q", buf(self.G64.transpose(0, 2, 1)
                                            .reshape(ne, 6 * Q)))
        self.register_buffer("Jr2", buf(grad_interp_matrix(p, q)
                                        .reshape(3 * q ** 3, -1)))
        self.register_buffer("B", buf(b.B))
        self.register_buffer("D", buf(b.D))
        self._ess_slice = _strided_slice(space.top_plane_dofs())

    # ------------------------------------------------- the E-vector transfer
    @cached_property
    def elem_dofs(self) -> torch.Tensor:
        return torch.as_tensor(self.space.elem_dofs, device=self.device)

    @cached_property
    def fold(self) -> torch.Tensor:
        return torch.as_tensor(_fold_table(self.space.elem_dofs, self.n_dofs),
                               device=self.device)

    @cached_property
    def free_e(self) -> torch.Tensor:
        free = np.ones(self.n_dofs)
        free[self.space.top_plane_dofs()] = 0.0
        return torch.tensor(free[self.space.elem_dofs]).to(
            device=self.device, dtype=self.dtype)

    # gather and fold run ~13.5k times a step on the cylinder: while nothing
    # records they test for a profile themselves and take no context, under
    # half a detail's cost (lpfem_torch.profiling.recording)
    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """[n_dofs] -> E-vector [ne, L] in the space's element order (the
        detail ``operators.gather``)."""
        if recording():
            with detail("operators.gather"):
                return x[self.elem_dofs]
        return x[self.elem_dofs]

    def scatter(self, ye: torch.Tensor) -> torch.Tensor:
        """E-vector [ne, L] -> assembled [n_dofs] (transpose of
        ``gather``; the detail ``operators.fold``)."""
        if recording():
            with detail("operators.fold"):
                return _fold(ye, self.fold)
        return _fold(ye, self.fold)

    # ------------------------------------------------------------ the applies
    def _local(self, u: torch.Tensor) -> torch.Tensor:
        affine = self.C64 is not None
        if self.mode == "sumfact":
            return sumfact_local(u, self.C6 if affine else None,
                                 self.w3 if affine else None,
                                 None if affine else self.G6q, self.B,
                                 self.D)
        if self.mode == "fused":
            if affine:
                return pa_apply_affine_reference(u, self.C6, self.w3, self.B,
                                                 self.D, self.Jr2)
            return pa_apply_element_reference(u, self.G6q, self.B, self.D,
                                              self.Jr2)
        if affine:
            return pa_apply_affine(u, self.C6, self.w3, self.B, self.D)
        return pa_apply_element(u, self.G6q, self.B, self.D)

    def apply_local(self, x: torch.Tensor) -> torch.Tensor:
        """Per-element contributions [ne, L] (the E-vector, pre-fold)."""
        return self._local(self.gather(x))

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x on the flat dof vector."""
        return self.scatter(self.apply_local(x))

    forward = apply

    def _copy_ess(self, y: torch.Tensor, x: torch.Tensor) -> None:
        """y[ess] = x[ess], as one strided copy where the free surface is a
        slice of the numbering (the top plane of a lattice, the last level
        of every column)."""
        sl = self._ess_slice
        if sl is not None:
            y[sl] = x[sl]
        else:
            y[self.ess] = x[self.ess]

    def constrained_apply_top(self, x: torch.Tensor) -> torch.Tensor:
        """Apply with identity rows/cols on the free-surface dofs: read as
        zero on input, the output's set to the input's
        (``lpfem/operators.py:835-837``)."""
        y = self.scatter(self._local(self.gather(x) * self.free_e))
        self._copy_ess(y, x)
        return y

    # ------------------------------------------------- diagonal and assembly
    def _element_diag(self) -> torch.Tensor:
        """[ne, L] element diagonals in the operator dtype from the buffers,
        the sums of ``LaplacePA.diag`` (``lpfem/operators.py:776-796``)."""
        Q = self.q ** 3
        Jx, Jy, Jz = self.Jr2[:Q], self.Jr2[Q:2 * Q], self.Jr2[2 * Q:]
        pairs = ((1, Jx, Jx), (2, Jx, Jy), (2, Jx, Jz), (1, Jy, Jy),
                 (2, Jy, Jz), (1, Jz, Jz))
        if self.C64 is not None:
            # rank-1 metric: d_e = C6 @ W6, the quadrature sums in [6, L]
            W6 = torch.stack([m * torch.einsum("q,ql,ql->l", self.w3, a, b)
                              for m, a, b in pairs])
            return self.C6 @ W6
        G = self.G6q.view(-1, 6, Q)
        return sum(m * (G[:, i] @ (a * b))
                   for i, (m, a, b) in enumerate(pairs))

    def diag(self) -> torch.Tensor:
        """Assembled diagonal (MFEM ``OperatorJacobiSmoother`` source)."""
        return self.scatter(self._element_diag())

    def element_matrices(self, elems: slice = slice(None)) -> torch.Tensor:
        """Dense element stiffness matrices [ne, L, L] (of the elements
        ``elems``), float64 on the operator's device:
        ``sum_ij Jr_i^T diag(G_ij) Jr_j`` (``lpfem/operators.py:869-886``)."""
        dev = self.device
        Jr = torch.tensor(grad_interp_matrix(self.p, self.q), device=dev)
        if self.C64 is not None:
            b = basis_1d(self.p, self.q)
            w3 = torch.tensor(np.einsum("c,b,a->cba", b.qwts, b.qwts,
                                        b.qwts).reshape(-1), device=dev)
            K = torch.einsum("q,iqk,jql->ijkl", w3, Jr, Jr)
            C = torch.tensor(self.C64[elems], device=dev)
            C6f = torch.stack([torch.stack([C[:, _SYM[i][j]]
                                            for j in range(3)], dim=-1)
                               for i in range(3)], dim=-2)      # [ne, 3, 3]
            return torch.einsum("eij,ijkl->ekl", C6f, K)
        G = torch.tensor(self.G64[elems], device=dev)         # [ne, Q, 6]
        A = None
        for i in range(3):
            for j in range(3):
                t = Jr[i].T @ (G[:, :, _SYM[i][j], None] * Jr[j])
                A = t if A is None else A + t
        return A

    def assemble_scipy(self) -> sp.csr_matrix:
        """Assembled float64 sparse matrix, duplicates summed
        (``lpfem/operators.py:888-898``)."""
        Ae = self.element_matrices().cpu().numpy()
        ed = self.space.elem_dofs
        L = ed.shape[1]
        rows = np.repeat(ed, L, axis=1).ravel()
        cols = np.tile(ed, (1, L)).ravel()
        return sp.coo_matrix((Ae.ravel(), (rows, cols)),
                             shape=(self.n_dofs, self.n_dofs)).tocsr()


class AffineLatticeLaplace(ElementLaplace):
    """Element-form Laplace on a lattice of affine elements, applied by one
    fused kernel: ``kernels.lattice_apply`` (TPU kernel B2) reads every
    element's window from ``x``, applies the affine metric and folds into
    ``y``, with the top-plane constraint inside. lpfem runs it where the
    space has a lattice, the metric is affine and y, z are not periodic,
    and the Kronecker form does not apply (``lpfem/operators.py:601-645,
    752-759, 827-834``). Diagonal, element matrices and assembly are
    :class:`ElementLaplace`'s."""

    def __init__(self, space, dtype: torch.dtype, device,
                 q: int | None = None, C6: np.ndarray | None = None):
        if space.dof_dims is None or space.periodic[1] or space.periodic[2]:
            raise ValueError("AffineLatticeLaplace needs a dof lattice with "
                             "y and z not periodic")
        if C6 is None:
            C6 = affine_c6(space, space.p + 1 if q is None else q,
                           np.float32 if dtype == torch.float32
                           else np.float64)
            if C6 is None:
                raise ValueError("the elements are not affine")
        super().__init__(space, dtype, device, q, C6)

    def _lattice_apply(self, x: torch.Tensor, ess_top: bool) -> torch.Tensor:
        return lattice_affine_apply(x, self.C6, self.w3, self.B, self.D,
                                    self.space.elem_dims, self.periodic,
                                    ess_top)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self._lattice_apply(x, False)

    forward = apply

    def constrained_apply_top(self, x: torch.Tensor) -> torch.Tensor:
        return self._lattice_apply(x, True)


def laplace_operator(space, dtype: torch.dtype, device, q: int | None = None,
                     mode: str = "pallas"):
    """The Laplace operator lpfem's ``LaplacePA(mode=mode)`` would run on
    ``space`` (the module docstring's rule): used for the fine operators and
    for every multigrid level. The affine test is tied to ``dtype`` as
    lpfem's."""
    if mode not in APPLY_MODES:
        raise ValueError(f"unknown apply mode {mode!r} (the operator's: "
                         f"{', '.join(APPLY_MODES)})")
    h = separable_spacings(space) if mode != "sumfact" else None
    if h is not None:
        op = SeparableLattice(space, dtype, device, q, spacings=h)
        op.mode = mode
        return op
    C6 = affine_c6(space, space.p + 1 if q is None else q,
                   np.float32 if dtype == torch.float32 else np.float64)
    if (mode == "pallas" and C6 is not None and space.dof_dims is not None
            and not space.periodic[1] and not space.periodic[2]):
        return AffineLatticeLaplace(space, dtype, device, q, C6)
    return ElementLaplace(space, dtype, device, q, C6, mode=mode)


def assemble_csr(op, dtype: torch.dtype, elem_dofs=None, elems=None,
                 n: int | None = None, chunk: int = 4096) -> torch.Tensor:
    """The assembled element operator of ``op`` as a sparse CSR tensor on
    ``op``'s device with 32-bit indices, duplicates summed: ``chunk``
    element matrices at a time (float64, rounded to ``dtype``) into one
    coordinate list, coalesced on the device. ``elems`` (element ids,
    default all), ``elem_dofs [len(elems), L]`` (default the space's) and
    ``n`` (default ``op.n_dofs``) place the rows and columns elsewhere (the
    stacked local layouts of a sharded level). Raises where the nonzeros or
    the rows do not fit 32-bit indices."""
    ed = torch.as_tensor(op.space.elem_dofs if elem_dofs is None
                         else elem_dofs, device=op.device)
    n = op.n_dofs if n is None else n
    ne, L = ed.shape
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows do not fit 32-bit indices")
    idx = torch.empty(2, ne * L * L, dtype=torch.int64, device=op.device)
    val = torch.empty(ne * L * L, dtype=dtype, device=op.device)
    for s in range(0, ne, chunk):
        e = ed[s:s + chunk]
        m = e.shape[0]
        part = slice(s * L * L, (s + m) * L * L)
        idx[0, part] = e[:, :, None].expand(m, L, L).reshape(-1)
        idx[1, part] = e[:, None, :].expand(m, L, L).reshape(-1)
        sel = slice(s, s + m) if elems is None else elems[s:s + m]
        val[part] = op.element_matrices(sel).reshape(-1).to(dtype)
    A = torch.sparse_coo_tensor(idx, val, (n, n),
                                check_invariants=False).coalesce()
    del idx, val
    if A._nnz() >= 2 ** 31:
        raise ValueError(f"{A._nnz()} nonzeros do not fit 32-bit indices")
    with warnings.catch_warnings():       # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        A = A.to_sparse_csr()
        # the coalesced values are a view of the uncoalesced list's storage:
        # copied, so that the matrix holds nnz values and no more
        crow, col, vals = (A.crow_indices().int(), A.col_indices().int(),
                           A.values().clone())
        del A
        return torch.sparse_csr_tensor(crow, col, vals, size=(n, n),
                                       check_invariants=False)


def element_source(op):
    """An operator with ``element_matrices`` for ``op``'s space: ``op``
    itself, or for the Kronecker lattice (which has none) a float64
    :class:`ElementLaplace` with the affine metric of its boxes."""
    if hasattr(op, "element_matrices"):
        return op
    return ElementLaplace(op.space, torch.float64, op.device, op.q,
                          affine_c6(op.space, op.q, np.float64))


class AssembledLaplace:
    """The fully assembled Laplace operator (``lpfem.operators.
    AssembledLaplace``, ``lpfem/operators.py:1076-1148``): MFEM's
    ``BilinearForm::Assemble`` with the hypre SpMV of the reference's
    ``PF_linear_par`` configuration (``Solvers/PF_linear_par.cpp:114-120``).

    The matrix is assembled on the operator's device from its element
    matrices (:func:`assemble_csr`; an operator without them, the Kronecker
    lattice, lends its space to a float64 :class:`ElementLaplace` for the
    assembly) into a CSR tensor in the operator's dtype with 32-bit
    indices; ``apply`` is one sparse matrix-vector product
    (``torch.mv``, cuSPARSE on the card; lpfem's is an XLA ELL row sum).
    lpfem assembles on the host row by row; here 2,179,584 rows at p = 4
    (456M nonzeros) assemble in one pass on the card.

    The solve uses it in place of the operator (``FreeSurfaceOperator(
    op_solve=...)``): ``constrained_apply`` / ``constrained_apply_top``,
    ``constrained_rhs`` and ``diag`` keep the operators' contracts.
    :meth:`gauss_seidel_host` runs MFEM's serial ``GSSmoother`` sweeps on
    the host.
    """

    mode = "assembled"

    def __init__(self, op, chunk: int = 4096):
        self.op = op
        self.space = op.space
        self.n_dofs = op.n_dofs
        self.dtype = op.dtype
        self.device = op.device
        self.A = assemble_csr(element_source(op), op.dtype, chunk=chunk)
        self.nnz = int(self.A.values().numel())
        self._top = torch.as_tensor(op.space.top_plane_dofs(),
                                    device=self.device)
        self._scipy = None

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x (one sparse matrix-vector product)."""
        return torch.mv(self.A, x)

    __call__ = apply

    def constrained_apply(self, x: torch.Tensor,
                          ess: torch.Tensor) -> torch.Tensor:
        """Identity rows and columns on the essential dofs ``ess``."""
        x0 = x.clone()
        x0[ess] = 0.0
        y = self.apply(x0)
        y[ess] = x[ess]
        return y

    def constrained_apply_top(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`constrained_apply` on the free-surface dofs."""
        return self.constrained_apply(x, self._top)

    def constrained_rhs(self, b: torch.Tensor, ess_vals: torch.Tensor,
                        ess: torch.Tensor | None = None):
        """(B, x_bc), the contract of the operators'
        ``constrained_rhs``."""
        ess = self._top if ess is None else ess
        x_bc = torch.zeros_like(b)
        x_bc[ess] = ess_vals
        B = b - self.apply(x_bc)
        B[ess] = ess_vals
        return B, x_bc

    def diag(self) -> torch.Tensor:
        """The matrix diagonal (a new tensor)."""
        A = self.A
        crow = A.crow_indices().long()
        col = A.col_indices().long()
        rows = torch.repeat_interleave(
            torch.arange(self.n_dofs, device=self.device), crow.diff())
        on = col == rows
        d = torch.zeros(self.n_dofs, dtype=self.dtype, device=self.device)
        d[rows[on]] = A.values()[on]
        return d

    def scipy(self) -> sp.csr_matrix:
        """The matrix as a float64 SciPy CSR on the host (kept)."""
        if self._scipy is None:
            A = self.A
            self._scipy = sp.csr_matrix(
                (A.values().detach().to("cpu", torch.float64).numpy(),
                 A.col_indices().cpu().numpy(),
                 A.crow_indices().cpu().numpy()),
                shape=(self.n_dofs, self.n_dofs))
        return self._scipy

    def gauss_seidel_host(self, b: np.ndarray, x0: np.ndarray,
                          sweeps: int = 1) -> np.ndarray:
        """Symmetric Gauss-Seidel sweeps on the host (SciPy triangular
        solves; ``lpfem/operators.py:1129-1148``): MFEM's serial
        ``GSSmoother`` (``Solvers/laplace_solver.cpp:112``), a sequential
        validation path."""
        from scipy.sparse.linalg import spsolve_triangular
        A = self.scipy()
        Lo = sp.tril(A, format="csr")
        U = sp.triu(A, format="csr")
        D = A.diagonal()
        x = np.array(x0, dtype=np.float64)
        for _ in range(sweeps):
            x = spsolve_triangular(Lo, b - U @ x + D * x, lower=True)
            x = spsolve_triangular(U, b - Lo @ x + D * x, lower=False)
        return x


class NodalZDerivative(nn.Module):
    """Free-surface trace of MFEM's nodal ``GetDerivative(1, 2, w)``: the
    per-element nodal z-derivative averaged over the elements that share a
    node (``Solvers/PF_linear_serial.cpp:175,268``), at the surface dofs
    ``ess`` (volume dofs in surface order; default: the space's top plane).
    Only the elements that touch the surface are read.

    - On z-extruded geometry (always on a :class:`LatticeSpace`, where
      ``jz = 1 / hz`` of the top layer; elsewhere when lpfem's extrusion
      check passes, ``geometry.top_trace_geometry``, and the numbering has
      the layers — a lattice, or the columns of ``H1Space.extruded``) the
      average collapses: ``w = jz * sum_m Dn[p, m] phi[z = Dz-1-p+m]`` on
      the top ``p+1`` dof planes, or the last ``p+1`` levels of every column
      (``NodalZDerivative.top_trace``, ``lpfem/operators.py:1016-1040``).
    - Otherwise the nodal derivative ``sum_i dxi_i/dz * dphi/dxi_i`` of
      every surface element, folded onto the surface dofs and divided by
      the node multiplicity — lpfem's full ``__call__`` path
      (``lpfem/operators.py:1051-1073``) restricted to the surface, with
      three constants per element (lpfem's ``Jz3``) where the elements are
      affine.
    """

    def __init__(self, space, dtype: torch.dtype, device, ess=None):
        super().__init__()
        p = space.p
        self.p, self.p1 = p, p + 1
        Dn = basis_1d(p).Dn
        ess = np.asarray(space.top_plane_dofs() if ess is None else ess)

        def buf(a):
            return torch.tensor(a, dtype=torch.float64).to(device=device,
                                                           dtype=dtype)

        self.register_buffer("dn", buf(Dn[p]))
        self.layout = self.top_idx = None
        if isinstance(space, LatticeSpace):
            self.jz, Jz, elems = float(1.0 / space.spacings[2][-1]), None, None
        else:
            elems = surface_elements(space, ess)
            self.jz, Jz = top_trace_geometry(
                space, 1e-6 if dtype == torch.float32 else 1e-12, elems)
        if self.jz is not None:
            idx = self._layers(space, ess)
            if idx is None:
                self.jz = None
            elif not np.array_equal(idx, np.arange(len(idx))):
                self.top_idx = torch.as_tensor(idx, device=device)
        if self.jz is None:
            surf_of = np.full(space.n_dofs, -1, dtype=np.int64)
            surf_of[ess] = np.arange(len(ess))
            ed = space.elem_dofs[elems]
            self.register_buffer("elem_dofs", torch.as_tensor(ed,
                                                              device=device))
            self.register_buffer("fold", torch.as_tensor(
                _fold_table(surf_of[ed], len(ess)), device=device))
            self.register_buffer("Dn", buf(Dn))
            self.register_buffer("Jz", buf(Jz))       # [m, L or 1, 3]
            self.register_buffer("inv_mult", buf(1.0 / space.node_mult[ess]))

    def _layers(self, space, ess: np.ndarray) -> np.ndarray | None:
        """Where the numbering has z-layers and ``ess`` is its last one: set
        ``layout`` = (kind, Dz, nplane) and return each surface dof's index
        in the layer (lpfem's ``_detect_top``); else None."""
        if space.dof_dims is not None:
            Dx, Dy, Dz = space.dof_dims
            off = (Dz - 1) * Dy * Dx
            if space.periodic[2] or np.any(ess < off):
                return None
            self.layout = ("struct", Dz, Dy * Dx)
            return ess - off
        ext = space.extruded
        if ext is None or np.any(ess % ext.Dz != ext.Dz - 1):
            return None
        self.layout = ("ext", ext.Dz, ext.n2d)
        return ess // ext.Dz

    def top_trace(self, x: torch.Tensor | DS) -> torch.Tensor:
        """The trace at the surface dofs, in the buffers' dtype. A
        double-single ``x`` (the potential of the ``hi_apply="ds"`` solve,
        which runs on lattices only) is recombined on the top ``p+1``
        planes or column levels alone (``lpfem/operators.py:1024-1034``),
        never on the full volume."""
        if self.jz is not None:
            kind, Dz, nplane = self.layout
            p1 = self.p1
            if kind == "struct":
                def top(v):
                    return v.view(Dz, nplane)[Dz - p1:]
            else:
                def top(v):
                    return v.view(nplane, Dz)[:, Dz - p1:]
            if isinstance(x, DS):
                xs = top(x.hi).to(self.dn.dtype) + top(x.lo).to(self.dn.dtype)
            else:
                xs = top(x)
            w = self.jz * (self.dn @ xs if kind == "struct" else xs @ self.dn)
            return w if self.top_idx is None else w[self.top_idx]
        if isinstance(x, DS):
            raise ValueError("a double-single potential needs the layered "
                             "trace (the double-single solve runs on "
                             "lattices only)")
        p1 = self.p1
        u = x[self.elem_dofs].view(-1, p1, p1, p1)          # [e, z, y, x]
        gx = (u @ self.Dn.T).reshape(-1, p1 ** 3)
        gy = (self.Dn @ u).reshape(-1, p1 ** 3)
        gz = torch.einsum("cz,ezyx->ecyx", self.Dn, u).reshape(-1, p1 ** 3)
        Jz = self.Jz
        w = Jz[..., 0] * gx + Jz[..., 1] * gy + Jz[..., 2] * gz
        return _fold(w, self.fold) * self.inv_mult

    forward = top_trace


def nodal_z_derivative(space, x: torch.Tensor) -> torch.Tensor:
    """MFEM's nodal ``GetDerivative(1, 2, w)`` at every dof of ``space``
    (lpfem's ``NodalZDerivative.__call__``, ``lpfem/operators.py:1051-1073``;
    the metric of ``Problem.w_error_inf``), in ``x``'s dtype and device.

    On a :class:`LatticeSpace` (boxes) the element's z-derivative at a node
    is ``(1/hz) sum_m Dn[l, m] x[ez*p + m]`` along the node's z-line, and
    the elements sharing the node across x or y give the same value, so
    MFEM's average over the sharing elements is the mean over its one or
    two z-neighbours: each z-element's column derivative is added into its
    planes and divided by the planes' count. Any other space takes the
    general path of :class:`NodalZDerivative` with every dof as the
    target: every element's nodal derivative, folded and divided by the
    node multiplicity."""
    if not isinstance(space, LatticeSpace):
        return NodalZDerivative(space, x.dtype, x.device,
                                ess=np.arange(space.n_dofs))(x)
    p = space.p
    Dx, Dy, Dz = space.dof_dims
    hz = space.spacings[2]
    rows = (np.arange(len(hz))[:, None] * p + np.arange(p + 1)).ravel()
    u = x.view(Dz, Dy * Dx)
    idx = torch.as_tensor(rows, device=x.device)
    Dn = torch.tensor(basis_1d(p).Dn, dtype=x.dtype, device=x.device)
    jz = torch.tensor(1.0 / hz, dtype=x.dtype, device=x.device)
    we = jz[:, None, None] * torch.einsum(
        "lm,emk->elk", Dn, u[idx].view(len(hz), p + 1, -1))
    w = torch.zeros_like(u).index_add_(0, idx, we.reshape(len(rows), -1))
    count = torch.tensor(np.bincount(rows, minlength=Dz), dtype=x.dtype,
                         device=x.device)
    return (w / count[:, None]).reshape(-1)
