"""p-multigrid preconditioner with Chebyshev-Jacobi smoothing.

Counterpart of ``lpfem.multigrid``: the same mesh and geometry at orders
p -> p/2 -> ... -> 1, each level's operator chosen by
:func:`~lpfem_torch.operators.laplace_operator` (lpfem builds a ``LaplacePA``
per level, which chooses the same way); then h-coarsened p=1 levels (2x2x2
element merges, where the merged mesh is still a Cartesian lattice) while
the bottom level is above ``max(coarse_dense_limit, h_coarsen_min_dofs)``.
Between two lattice levels the transfer is three per-axis dense
interpolations (the lattice fast path of ``lpfem/multigrid.py:301-316``,
which acts in reference space and so serves sheared and curved lattices
unchanged); otherwise the element path (``lpfem/multigrid.py:148-182``). A
Chebyshev(degree k) Jacobi smoother on every level; a dense-inverse coarse
solve (inverted in float64 on the host) up to ``coarse_dense_limit`` dofs,
else Chebyshev-16. The essential set is the free surface
(``space.top_plane_dofs()``) on every level.

The smoother, the element transfer and the V-cycle (:class:`VCycle`) serve
the sharded p-multigrid too (``shard.ShardedPMG``: its own hierarchy).

The route of the coarse solve, ``PMultigrid.coarse_route``, follows from
what the bottom level is: ``"dense"`` up to ``coarse_dense_limit`` dofs;
above it ``"fused"`` where ``kernels.coarse_cheb.CoarseChebyshev.for_level``
takes the level (a full-metric p = 1 ``ElementLaplace`` on a CUDA device
that fits one thread-block cluster: the same Chebyshev-16 in one launch),
else ``"chebyshev"`` (the eager :class:`ChebyshevSmoother`).

Spans (:func:`~lpfem_torch.profiling.span`): ``multigrid.vcycle`` (one
V-cycle), ``multigrid.lower`` (its descent below the top level, so that
the V-cycle's self time is the top level's own smoothers, residual and
transfers) and ``multigrid.coarse``; details
(:func:`~lpfem_torch.profiling.detail`): ``multigrid.L<i>.presmooth`` /
``.residual`` / ``.restrict`` / ``.prolong`` / ``.postsmooth`` (level
``i``'s stages, ``L0`` the finest; ``.prolong`` includes the correction's
add).

``estimate_lmax`` starts from a seeded ``torch.Generator``; the reference
starts from ``jax.random.normal(PRNGKey(0))``, which cannot be reproduced,
so parity tests inject the reference's per-level lambda_max (``lmax=``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .elements import basis_1d, lagrange_eval
from .kernels import coarse_cheb
from .kernels.cheb_step import cheb_first, cheb_step
from .operators import laplace_operator
from .profiling import detail, span

__all__ = ["ChebyshevSmoother", "PMultigrid", "VCycle", "estimate_lmax"]


def estimate_lmax(apply_fn, inv_diag: torch.Tensor, iters: int = 20,
                  safety: float = 1.1, seed: int = 0) -> float:
    """Power-iteration estimate of lambda_max(D^-1 A) times ``safety``
    (MFEM's ``OperatorChebyshevSmoother`` does the same), from a start
    vector drawn on the host with ``seed``."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    v = torch.randn(inv_diag.shape[0], generator=gen, dtype=torch.float64)
    v = v.to(device=inv_diag.device, dtype=inv_diag.dtype)
    lam = torch.ones((), dtype=inv_diag.dtype, device=inv_diag.device)
    for _ in range(iters):
        w = inv_diag * apply_fn(v)
        lam = torch.linalg.vector_norm(w)
        v = w / lam
    return float(lam) * safety


class ChebyshevSmoother:
    """Fixed-degree Chebyshev acceleration of Jacobi, z ~= A^-1 r: a linear,
    symmetric positive polynomial in D^-1 A (valid as a CG preconditioner and
    as an MG smoother), three-term recurrence on [lmax/30, lmax].

    Each step is the level's apply followed by one vector update
    (``kernels.cheb_step``: one launch a step on a CUDA tensor, the eager
    expressions on a CPU tensor) into ``d`` and ``z``, allocated once a
    call; ``coefs`` are ``coarse_cheb.chebyshev_coefficients``'."""

    def __init__(self, apply_fn, inv_diag: torch.Tensor, lmax: float,
                 degree: int = 3, lmin_frac: float = 1.0 / 30.0):
        self.apply_fn = apply_fn
        self.inv_diag = inv_diag
        self.degree = degree
        self.lmax = lmax
        lmin = lmin_frac * lmax
        self.theta = (lmax + lmin) / 2.0
        self.delta = (lmax - lmin) / 2.0
        self.coefs = coarse_cheb.chebyshev_coefficients(self.theta,
                                                        self.delta, degree)

    def __call__(self, r: torch.Tensor, z0: torch.Tensor | None = None):
        """z ~= A^-1 r (``z0``: initial guess, used by the V-cycle; neither
        ``r`` nor ``z0`` is written)."""
        A, invD = self.apply_fn, self.inv_diag
        d = torch.empty_like(r)
        z = torch.empty_like(r)
        cheb_first(r, invD, self.theta, d, z, z0=z0,
                   Az0=None if z0 is None else A(z0))
        for c1, c2 in self.coefs:
            cheb_step(r, A(z), invD, d, z, c1, c2)
        return z


def p_orders(p: int) -> list[int]:
    """The p-levels' orders: p, p/2, ..., 1."""
    orders = []
    while p > 1:
        orders.append(p)
        p = max(1, p // 2)
    return orders + [1]


def _axis_interp(n: int, pc: int, pf: int, periodic: bool) -> np.ndarray:
    """[Df, Dc] interpolation from the order-``pc`` GLL grid to the
    order-``pf`` grid over ``n`` elements (``lpfem.multigrid._axis_interp``)."""
    I1, _ = lagrange_eval(basis_1d(pc).nodes, basis_1d(pf).nodes)
    Dc = n * pc + (0 if periodic else 1)
    Df = n * pf + (0 if periodic else 1)
    P = np.zeros((Df, Dc))
    for e in range(n):
        rows = (e * pf + np.arange(pf + 1)) % Df
        cols = (e * pc + np.arange(pc + 1)) % Dc
        P[np.ix_(rows, cols)] = I1
    return P


def interp_3d(pc: int, pf: int, dtype, device) -> torch.Tensor:
    """``I3 [(pf+1)^3, (pc+1)^3]``: the element interpolation from order
    ``pc`` to order ``pf`` (``lpfem/multigrid.py:148-182``,
    ``lpfem/shard.py:904-908``)."""
    I1, _ = lagrange_eval(basis_1d(pc).nodes, basis_1d(pf).nodes)
    I3 = np.einsum("cz,by,ax->cbazyx", I1, I1, I1).reshape(
        (pf + 1) ** 3, (pc + 1) ** 3)
    return torch.tensor(I3).to(device=device, dtype=dtype)


class _Level:
    """One hierarchy level: operator with the top-plane constraint, the
    free-dof mask and the constrained Jacobi inverse diagonal."""

    def __init__(self, op):
        self.op = op
        dev = op.device
        top = op.space.top_plane_dofs()
        free = np.ones(op.n_dofs)
        free[top] = 0.0
        self.free = torch.tensor(free).to(device=dev, dtype=op.dtype)
        diag = op.diag()
        diag[torch.as_tensor(top, device=dev)] = 1.0
        self.inv_diag = 1.0 / diag
        self.apply_c = op.constrained_apply_top
        # an ElementLaplace's E-vector pair: a side of an element transfer
        self.gather_E = getattr(op, "gather", None)
        self.assemble_E = getattr(op, "scatter", None)


class _Transfer:
    """Embedded interpolation P = Pz (x) Py (x) Px between two lattice
    levels, as three dense per-axis contractions; restriction is P^T."""

    def __init__(self, fine: _Level, coarse: _Level, pc: int,
                 pf: int, elem_dims, dtype, device):
        fs = fine.op.space
        self.P1z, self.P1y, self.P1x = (
            torch.tensor(_axis_interp(elem_dims[a], pc, pf,
                                      fs.periodic[a])).to(device=device,
                                                          dtype=dtype)
            for a in (2, 1, 0))
        self.fine_shape = tuple(reversed(fs.dof_dims))
        self.coarse_shape = tuple(reversed(coarse.op.space.dof_dims))
        self.fine_free, self.coarse_free = fine.free, coarse.free

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        v = xc.reshape(self.coarse_shape)
        v = torch.einsum("ZC,Cyx->Zyx", self.P1z, v)
        v = torch.einsum("YC,zCx->zYx", self.P1y, v)
        v = torch.einsum("XC,zyC->zyX", self.P1x, v)
        return v.reshape(-1) * self.fine_free

    def restrict(self, rf: torch.Tensor) -> torch.Tensor:
        v = rf.reshape(self.fine_shape)
        v = torch.einsum("ZC,Zyx->Cyx", self.P1z, v)
        v = torch.einsum("YC,zYx->zCx", self.P1y, v)
        v = torch.einsum("XC,zyX->zyC", self.P1x, v)
        return v.reshape(-1) * self.coarse_free


class _ElementTransfer:
    """The same interpolation element by element (``lpfem/multigrid.py:
    148-182``, ``lpfem/shard.py:814-847``): gather the coarse E-vector,
    interpolate with ``I3 [Lf, Lc]``, fold on the fine side and multiply by
    its inverse node multiplicity ``inv_mult`` (the copies of a shared node
    are equal); restriction is the exact transpose. A side is a level with
    an E-vector ``gather_E`` / ``assemble_E`` (an ``ElementLaplace``'s
    :class:`_Level`, a ``ShardedLevel``), on the fine side ``via`` where
    given (a sharded h-transfer's p=2 exchange on the half mesh)."""

    def __init__(self, I3: torch.Tensor, fine, coarse,
                 inv_mult: torch.Tensor, via=None):
        side = fine if via is None else via
        self.I3, self.inv_mult, self.via = I3, inv_mult, via
        self._gather_f, self._fold_f = side.gather_E, side.assemble_E
        self._gather_c, self._fold_c = coarse.gather_E, coarse.assemble_E
        self.fine_free, self.coarse_free = fine.free, coarse.free

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        uf = self._gather_c(xc) @ self.I3.T
        return self._fold_f(uf) * self.inv_mult * self.fine_free

    def restrict(self, rf: torch.Tensor) -> torch.Tensor:
        uc = self._gather_f(rf * self.inv_mult) @ self.I3
        return self._fold_c(uc) * self.coarse_free


class VCycle:
    """The V-cycle of :class:`PMultigrid` and ``shard.ShardedPMG``, over
    the hierarchy their constructors build: ``levels`` (each with
    ``apply_c``), ``smoothers`` (the bottom one unused), ``transfers``
    (``transfers[i]`` between levels ``i`` and ``i + 1``) and
    ``coarse_solve``. Spans and details: the module docstring."""

    @functools.cached_property
    def _stages(self) -> list:
        """The details of each level's stages, named by the level's index."""
        return [tuple(f"multigrid.L{i}.{stage}" for stage in
                      ("presmooth", "residual", "restrict", "prolong",
                       "postsmooth"))
                for i in range(len(self.levels) - 1)]

    def _vcycle(self, li: int, r: torch.Tensor) -> torch.Tensor:
        if li == len(self.levels) - 1:
            with span("multigrid.coarse"):
                return self.coarse_solve(r)
        sm = self.smoothers[li]
        lv = self.levels[li]
        tr = self.transfers[li]
        pre, res, restrict, prolong, post = self._stages[li]
        with detail(pre):
            z = sm(r)                               # pre-smooth from zero
        with detail(res):
            rf = r - lv.apply_c(z)
        with detail(restrict):
            rc = tr.restrict(rf)
        if li == 0:
            # the levels below the top one: the top level's own work is
            # then the self time of multigrid.vcycle
            with span("multigrid.lower"):
                zc = self._vcycle(1, rc)
        else:
            zc = self._vcycle(li + 1, rc)
        with detail(prolong):
            z = z + tr.prolong(zc)
        with detail(post):
            return sm(r, z0=z)                      # post-smooth

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        with span("multigrid.vcycle"):
            return self._vcycle(0, r)


class PMultigrid(VCycle):
    """V-cycle p/h-multigrid preconditioner for the Laplace operator with
    the top-plane essential constraint. ``pmg(r)`` assumes ``r`` vanishes on
    the top plane (true inside CG on the constrained system).

    ``lmax``: per-level lambda_max(D^-1 A) (e.g. from the reference via
    ``convert.smoother_lmax``); estimated when None. The Chebyshev coarse
    solve reuses the bottom level's value, which is what the reference's
    separate estimate on the same operator returns.

    ``coarse_route``: ``"dense"``, ``"fused"`` or ``"chebyshev"`` (the
    module docstring); on the fused route ``coarse_solve`` is a
    ``kernels.coarse_cheb.CoarseChebyshev`` and its eager smoother is
    ``coarse_solve.chebyshev``.
    """

    def __init__(self, fine_op, smooth_degree: int = 3,
                 coarse_dense_limit: int = 6000, coarse_cheb_degree: int = 16,
                 h_coarsen_min_dofs: int = 20000,
                 lmax: list[float] | None = None):
        space = fine_op.space
        dtype, device = fine_op.dtype, fine_op.device
        self.orders = orders = p_orders(space.p)

        mode = fine_op.mode
        ops = [fine_op] + [laplace_operator(space.with_order(pl), dtype,
                                            device, mode=mode)
                           for pl in orders[1:]]
        self.levels = [_Level(op) for op in ops]
        self.transfers = []
        for i in range(len(orders) - 1):
            fine, coarse = self.levels[i], self.levels[i + 1]
            fs, cs = ops[i].space, ops[i + 1].space
            if fs.dof_dims is not None and cs.dof_dims is not None:
                tr = _Transfer(fine, coarse, orders[i + 1], orders[i],
                               fs.elem_dims, dtype, device)
            else:
                tr = _ElementTransfer(
                    interp_3d(orders[i + 1], orders[i], dtype, device),
                    fine, coarse, torch.tensor(1.0 / fs.node_mult).to(
                        device=device, dtype=dtype))
            self.transfers.append(tr)

        # h-coarsening below p=1: p=1 on the fine grid shares its dof lattice
        # with p=2 on the half grid, so the transfer is the p=1 -> p=2
        # interpolation over the coarse elements
        while True:
            bot = self.levels[-1].op.space
            if bot.n_dofs <= max(coarse_dense_limit, h_coarsen_min_dofs):
                break
            sp_c = bot.coarsen()
            if sp_c is None:
                break
            self.levels.append(_Level(laplace_operator(sp_c, dtype, device,
                                                       mode=mode)))
            self.transfers.append(_Transfer(self.levels[-2], self.levels[-1],
                                            1, 2, sp_c.elem_dims, dtype,
                                            device))
            self.orders = self.orders + [1]

        if lmax is None:
            lmax = [estimate_lmax(lv.apply_c, lv.inv_diag)
                    for lv in self.levels]
        if len(lmax) != len(self.levels):
            raise ValueError(f"lmax has {len(lmax)} entries for "
                             f"{len(self.levels)} levels")
        self.lmax = [float(v) for v in lmax]
        self.smoothers = [ChebyshevSmoother(lv.apply_c, lv.inv_diag, lm,
                                            degree=smooth_degree)
                          for lv, lm in zip(self.levels, self.lmax)]

        cl = self.levels[-1]
        if cl.op.n_dofs <= coarse_dense_limit:
            A = cl.op.assemble_scipy().toarray()
            ess = cl.op.space.top_plane_dofs()
            A[ess, :] = 0.0
            A[:, ess] = 0.0
            A[ess, ess] = 1.0
            self._coarse_inv = torch.tensor(np.linalg.inv(A)).to(
                device=device, dtype=dtype)
            self.coarse_solve = lambda r: self._coarse_inv @ r
            self.coarse_route = "dense"
        else:
            self._coarse_inv = None
            cheb = ChebyshevSmoother(cl.apply_c, cl.inv_diag, self.lmax[-1],
                                     degree=coarse_cheb_degree)
            fused = coarse_cheb.CoarseChebyshev.for_level(cl.op, cl.inv_diag,
                                                          cheb)
            self.coarse_solve = cheb if fused is None else fused
            self.coarse_route = "chebyshev" if fused is None else "fused"
