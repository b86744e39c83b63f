"""Free-surface right-hand side: Laplace solve, surface trace, surface ODEs.

Counterpart of ``lpfem.surface.FreeSurfaceOperator`` (the reference's
``rhs_linear::Mult``, ``Solvers/PF_linear_periodic.cpp:14-104``):

    d eta / dt    = w_tilde = dphi/dz |_fs
    d phi_fs / dt = -g eta

with phi solving Laplace's equation, phi = phi_fs on the free surface (the
dofs ``surf.surf_to_vol``) and zero-Neumann walls, plus the optional relaxation-zone penalty
forcing ``d g/dt += alpha(t) C(x)/tau (g_e - g)``
(``Solvers/PF_linear_serial.cpp:186-257``, ``lpfem/surface.py:82-143,
350-357``). The volume potential rides along as the CG warm start (MFEM's
persistent ``GridFunction &phi``).

Three solve paths: ``op_hi`` given (``dtype="mixed"``) runs ``pcg_ir`` —
float64 outer residual on ``op_hi``, float32 inner CG on ``op`` — or, with
``hi_apply="ds"`` on a :class:`~lpfem_torch.operators.SeparableLattice`,
``pcg_ir_ds``: the outer loop in double-single arithmetic on
:class:`~lpfem_torch.ds.SeparableDS` (kernel B4 on the GPU), the volume
potential carried as a DS pair; otherwise ``pcg`` on ``op``. ``op`` is any
operator of ``lpfem_torch.operators``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .analytic import AiryWave
from .ds import DS, SeparableDS, ds_from_f32, ds_from_f64
from .operators import NodalZDerivative, SeparableLattice
from .profiling import span, sync
from .solvers import jacobi_preconditioner, pcg, pcg_ir, pcg_ir_ds
from .space import SurfaceSpace

__all__ = ["cgen_weight", "cabs_weight", "RelaxationZones",
           "FreeSurfaceOperator", "SolveInfo", "SolveStats", "SolveCarry"]


class SolveInfo(NamedTuple):
    """Per-solve convergence telemetry (what MFEM's CGSolver reports)."""
    iters: int           # total (inner) CG iterations
    converged: bool      # final residual met the threshold
    rz: float            # final (preconditioned / outer) residual measure
    rz0: float
    syncs: int           # host reads of loop exit tests


@dataclass(frozen=True)
class SolveStats:
    """Running aggregate of :class:`SolveInfo` across RK4 stages/steps."""
    max_iters: int = 0
    unconverged: bool = False
    n_solves: int = 0
    total_iters: int = 0
    syncs: int = 0

    def update(self, info: SolveInfo) -> "SolveStats":
        return SolveStats(max_iters=max(self.max_iters, info.iters),
                          unconverged=self.unconverged or not info.converged,
                          n_solves=self.n_solves + 1,
                          total_iters=self.total_iters + info.iters,
                          syncs=self.syncs + info.syncs)


class SolveCarry(NamedTuple):
    """RK4 aux carry with telemetry: volume-potential warm start (a DS pair
    on the double-single path) plus the aggregated solver stats."""
    phi: torch.Tensor | DS
    stats: SolveStats


def _as_ds(x: torch.Tensor) -> DS:
    return (ds_from_f64(x) if x.dtype == torch.float64
            else ds_from_f32(x.to(torch.float32)))


def cgen_weight(x: np.ndarray, xg0: float, xg1: float) -> np.ndarray:
    """Generation-zone forcing weight: 1 at the inlet (x <= xg0), cubic
    smoothstep down to 0 at xg1 (``Solvers/PF_linear_serial.cpp:397-408``)."""
    xi = np.clip((x - xg0) / (xg1 - xg0), 0.0, 1.0)
    s = 1.0 - xi
    return -2.0 * s ** 3 + 3.0 * s ** 2


def cabs_weight(x: np.ndarray, x0: float, x1: float,
                p: float = 5.0) -> np.ndarray:
    """Absorption-zone weight: 0 at x0 rising as xi^p to 1 at the outlet x1
    (``Solvers/PF_linear_serial.cpp:417-430``)."""
    xi = np.clip((x - x0) / (x1 - x0), 0.0, 1.0)
    return xi ** p


@dataclass
class RelaxationZones:
    """Penalty-forcing data on the surface nodes (``lpfem.surface.
    RelaxationZones``). ``cgen``/``cabs`` are nodal weights (lateral zones,
    like the cylinder case's ``Cabsy``, are summed into one of them); the
    target wave enters through its surface-node phase tables, so a stage
    needs only the scalar trig of ``omega * t``."""
    cgen: torch.Tensor       # [Ns]
    cabs: torch.Tensor       # [Ns]
    cos_kx: torch.Tensor     # [Ns] cos(k (kx x + ky y)) at surface nodes
    sin_kx: torch.Tensor     # [Ns]
    H: float
    omega: float
    phi_amp: float           # -H/2 c cosh(kh)/sinh(kh)
    tau: float               # penalty timescale (= dt in the reference)
    T: float                 # wave period, for the generation ramp
    n_ramp: float = 3.0      # ramp periods

    @classmethod
    def build(cls, surf: SurfaceSpace, wave: AiryWave, tau: float,
              cgen: np.ndarray | None = None, cabs: np.ndarray | None = None,
              n_ramp: float = 3.0, dtype: torch.dtype = torch.float64,
              device="cpu") -> "RelaxationZones":
        X = surf.node_coords
        ns = surf.n_dofs
        karg = wave.k * (wave.kx * X[:, 0] + wave.ky * X[:, 1])
        zero = np.zeros(ns)

        def vec(a):
            return torch.tensor(np.asarray(a, dtype=np.float64)).to(
                device=device, dtype=dtype)

        return cls(
            cgen=vec(zero if cgen is None else cgen),
            cabs=vec(zero if cabs is None else cabs),
            cos_kx=vec(np.cos(karg)), sin_kx=vec(np.sin(karg)),
            H=float(wave.H), omega=float(wave.omega),
            phi_amp=float(-0.5 * wave.H * wave.c * np.cosh(wave.kh)
                          / np.sinh(wave.kh)),
            tau=float(tau), T=float(wave.T), n_ramp=float(n_ramp))

    def targets(self, t: float):
        """(eta_e, phi_fs_e) at stage time t: the Airy wave, via angle sums."""
        c, s = math.cos(self.omega * t), math.sin(self.omega * t)
        eta_e = 0.5 * self.H * (c * self.cos_kx + s * self.sin_kx)
        phi_e = self.phi_amp * (s * self.cos_kx - c * self.sin_kx)
        return eta_e, phi_e

    def forcing(self, t: float, eta: torch.Tensor, phi_fs: torch.Tensor,
                deta: torch.Tensor, dphi_fs: torch.Tensor):
        """``(deta, dphi_fs)`` with the penalty forcing at stage time ``t``
        added: towards the target wave in the generation zone (ramped in
        over ``n_ramp`` periods), towards rest in the absorption zone."""
        eta_e, phi_e = self.targets(t)
        alpha_gen = min(max(t / (self.n_ramp * self.T), 0.0), 1.0)
        inv_tau = 1.0 / self.tau
        gen_w = alpha_gen * self.cgen * inv_tau
        deta = deta + gen_w * (eta_e - eta) - self.cabs * inv_tau * eta
        dphi_fs = (dphi_fs + gen_w * (phi_e - phi_fs)
                   - self.cabs * inv_tau * phi_fs)
        return deta, dphi_fs


class FreeSurfaceOperator:
    """``(t, y, aux) -> (dy/dt, aux)`` with ``y = [eta; phi_fs]`` on the
    surface dofs (in the order of ``surf``) and ``aux`` a
    :class:`SolveCarry`."""

    def __init__(self, op, surf: SurfaceSpace,
                 g: float = 9.81, cg_rtol_sq: float = 1e-24,
                 cg_atol_sq: float = 0.0, cg_max_iter: int = 1000,
                 precond_fn=None, op_hi=None,
                 ir_max_outer: int = 4, ir_inner_rtol_sq: float = 1e-8,
                 relax: RelaxationZones | None = None,
                 hi_apply: str = "auto", op_solve=None):
        """``op_solve`` replaces ``op`` in the solve of a float64 or
        float32 run (lpfem's, ``lpfem/surface.py:162-176``): the CG and its
        Jacobi diagonal run on it (the assembled
        :class:`~lpfem_torch.operators.AssembledLaplace` of
        ``apply_mode="assembled"``), while ``op`` keeps the geometric roles
        (the z-derivative) and the preconditioner's.

        ``hi_apply`` picks the outer arithmetic of the mixed solve by
        lpfem's rule (``lpfem/surface.py:201-235``): ``"ds"`` requires it
        double-single and raises unless ``op_hi`` is a ``SeparableLattice``
        with the top-plane essential set; ``"f64"`` forces float64;
        ``"auto"`` picks double-single only on a TPU, where float64 is
        emulated, so here it always keeps the float64 outer, as lpfem does
        off a TPU."""
        self.op = op
        self.op_hi = op_hi
        self.op_solve = op if op_solve is None else op_solve
        self.surf = surf
        self.g = g
        self.relax = relax
        self.cg_rtol_sq = cg_rtol_sq
        self.cg_atol_sq = cg_atol_sq
        self.cg_max_iter = cg_max_iter
        self.ir_max_outer = ir_max_outer
        self.ir_inner_rtol_sq = ir_inner_rtol_sq
        self.n_surf = surf.n_dofs
        zop = op_hi if op_hi is not None else op
        self.ess = torch.as_tensor(surf.surf_to_vol, device=zop.device)
        self.zderiv = NodalZDerivative(zop.space, zop.dtype, zop.device,
                                       ess=surf.surf_to_vol)
        if precond_fn is None:
            # Jacobi with identity on the essential dofs
            diag = self.op_solve.diag()
            diag[self.ess] = 1.0
            precond_fn = jacobi_preconditioner(diag)
        self._precond = precond_fn
        if hi_apply not in ("auto", "ds", "f64"):
            raise ValueError(f"unknown hi_apply {hi_apply!r}")
        self._ds_op = None
        if hi_apply == "ds":
            if not (isinstance(op_hi, SeparableLattice) and np.array_equal(
                    np.sort(surf.surf_to_vol), op_hi.space.top_plane_dofs())):
                raise ValueError("hi_apply='ds' needs dtype='mixed' on a "
                                 "separable lattice with the top-plane "
                                 "essential set")
            self._ds_op = SeparableDS(op_hi)

    def solve_laplace(self, phi_fs: torch.Tensor, phi_warm: torch.Tensor):
        """Dirichlet Laplace solve, phi = phi_fs on the free surface
        (``Solvers/PF_linear_periodic.cpp:71-92``). Returns (phi, info).
        The span ``surface.solve`` covers the right-hand side, the warm
        start, the solver and the verdict."""
        with span("surface.solve"):
            if self._ds_op is not None:
                return self._solve_laplace_ds(phi_fs, phi_warm)
            sop = self.op_hi if self.op_hi is not None else self.op_solve
            b = torch.zeros(sop.n_dofs, dtype=phi_warm.dtype,
                            device=phi_warm.device)
            B, _ = sop.constrained_rhs(b, phi_fs, self.ess)
            x0 = phi_warm.clone()
            x0[self.ess] = phi_fs
            lo = self.op if self.op_hi is not None else self.op_solve
            return self.cg_solve(sop.constrained_apply_top,
                                 lo.constrained_apply_top, B, x0,
                                 self._precond)

    def cg_solve(self, apply_hi, apply_lo, B: torch.Tensor,
                 x0: torch.Tensor, precond, dot_fn=torch.dot):
        """The solver call, on one device and on shards: ``pcg_ir`` where
        there is an ``op_hi`` (outer on ``apply_hi``, the system's own
        apply, inner CG in ``op``'s dtype on ``apply_lo``), else ``pcg`` on
        ``apply_lo``, with this operator's tolerances and limits. Returns
        (x, info)."""
        if self.op_hi is not None:
            res = pcg_ir(apply_hi, apply_lo, B, x0, precond_lo=precond,
                         rtol_sq=self.cg_rtol_sq, atol_sq=self.cg_atol_sq,
                         max_outer=self.ir_max_outer,
                         inner_rtol_sq=self.ir_inner_rtol_sq,
                         inner_max_iter=self.cg_max_iter,
                         lo_dtype=self.op.dtype, dot_fn=dot_fn)
        else:
            res = pcg(apply_lo, B, x0, precond_fn=precond,
                      rtol_sq=self.cg_rtol_sq, atol_sq=self.cg_atol_sq,
                      max_iter=self.cg_max_iter, dot_fn=dot_fn)
        return res.x, self._info(res)

    def _solve_laplace_ds(self, phi_fs: torch.Tensor, phi_warm):
        """The double-single solve (``lpfem/surface.py:282-319``): the
        eliminated right-hand side ``B = -A x_bc`` through the unconstrained
        DS apply with ``B[ess] = phi_fs`` in both streams, the warm start
        (a DS pair, or a float64 / float32 tensor on a cold start) with its
        surface values set, and ``pcg_ir_ds`` over the constrained DS
        apply. Returns a DS ``phi``."""
        ess, dsop = self.ess, self._ds_op
        vals = _as_ds(phi_fs)
        zero = torch.zeros(self.op_hi.n_dofs, dtype=torch.float32,
                           device=phi_fs.device)
        y = dsop.apply(DS(zero.index_put((ess,), vals.hi),
                          zero.index_put((ess,), vals.lo)))
        B = DS((-y.hi).index_put_((ess,), vals.hi),
               (-y.lo).index_put_((ess,), vals.lo))
        w = phi_warm if isinstance(phi_warm, DS) else _as_ds(phi_warm)
        x0 = DS(w.hi.index_put((ess,), vals.hi),
                w.lo.index_put((ess,), vals.lo))
        res = pcg_ir_ds(dsop.constrained_apply_top,
                        self.op.constrained_apply_top, B, x0,
                        precond_lo=self._precond,
                        rtol_sq=self.cg_rtol_sq, atol_sq=self.cg_atol_sq,
                        max_outer=self.ir_max_outer,
                        inner_rtol_sq=self.ir_inner_rtol_sq,
                        inner_max_iter=self.cg_max_iter)
        return res.x, self._info(res)

    def _info(self, res) -> SolveInfo:
        """Verdict under the MFEM threshold the solve ran with, in the
        residual's dtype (float32 on the double-single path, as lpfem's);
        a max_iter, breakdown or NaN exit reports converged == False."""
        with span("surface.verdict"):
            ok = res.rz <= torch.clamp_min(res.rz0 * self.cg_rtol_sq,
                                           self.cg_atol_sq)
            rz, rz0, conv = torch.stack([res.rz, res.rz0,
                                         ok.to(res.rz.dtype)]).tolist()
            return SolveInfo(iters=int(res.iters), converged=bool(conv),
                             rz=rz, rz0=rz0,
                             syncs=res.syncs + sync("surface.verdict"))

    def __call__(self, t, y: torch.Tensor, aux: SolveCarry):
        with span("surface.stage"):
            ns = self.n_surf
            eta, phi_fs = y[:ns], y[ns:]
            phi, info = self.solve_laplace(phi_fs, aux.phi)
            with span("surface.top_trace"):
                deta = self.zderiv.top_trace(phi)
            dphi_fs = -self.g * eta
            if self.relax is not None:
                deta, dphi_fs = self.relax.forcing(t, eta, phi_fs, deta,
                                                   dphi_fs)
            return torch.cat([deta, dphi_fs]), SolveCarry(
                phi, aux.stats.update(info))
