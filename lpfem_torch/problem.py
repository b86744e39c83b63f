"""Problem assembly: Config (+ mesh) -> lattice -> operators -> RK4 time loop.

Counterpart of ``lpfem.problem.Problem`` for the configurations this package
covers:

- the generated Cartesian tanks (``periodic_tank``, ``finite_tank``), on a
  :class:`~lpfem_torch.space.LatticeSpace` built from the configuration;
- an MFEM or a Gmsh v2.2 mesh file (``mesh_kind="mfem"`` / ``"gmsh"``),
  loaded and refined ``ref_levels`` times, on the topological
  :class:`~lpfem_torch.space.H1Space`;
- a mesh passed in: on a :class:`~lpfem_torch.space.CurvedLatticeSpace` when
  its generator declares an element lattice (the curved half-cylinder tank
  of ``lpfem_torch.cylmesh``, sheared tanks), else on an ``H1Space``;

each on the operator :func:`~lpfem_torch.operators.laplace_operator` picks
for it under ``apply_mode`` (``"assembled"``: the solve on the assembled
:class:`~lpfem_torch.operators.AssembledLaplace` of the ``"fused"``
operator, lpfem's ``PF_linear_par`` configuration; float64 or float32
only), with Jacobi / Chebyshev / p-multigrid preconditioning, relaxation zones, the
wave by modes, period or wavelength, and ``dtype`` float64, float32 or mixed
(float64 state and outer residual, float32 inner solve; with
``hi_apply="ds"`` on a Kronecker lattice the outer loop in double-single
arithmetic and the volume potential carried as a
:class:`~lpfem_torch.ds.DS` pair). Anything else raises ``ValueError`` with
the reason, as lpfem's.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import resolve_device, state_dtypes
from .analytic import AiryWave
from .configs import Config
from .ds import DS, ds_from_f64, ds_to_f64
from .mesh import Mesh, load_gmsh, load_mfem
from .multigrid import ChebyshevSmoother, PMultigrid, estimate_lmax
from .operators import (APPLY_MODES, AssembledLaplace, laplace_operator,
                        nodal_z_derivative)
from .profiling import reset, sync
from .space import CurvedLatticeSpace, H1Space, LatticeSpace, SurfaceSpace
from .surface import (FreeSurfaceOperator, RelaxationZones, SolveCarry,
                      SolveStats, cabs_weight, cgen_weight)
from .timestep import rk4_run, rk4_step

__all__ = ["Problem", "build_mesh", "build_wave"]

_TANKS = ("periodic_tank", "finite_tank")


def _check_supported(cfg: Config, mesh: Mesh | None) -> None:
    if mesh is None and cfg.mesh_kind not in _TANKS + ("mfem", "gmsh"):
        raise ValueError(f"unknown mesh_kind {cfg.mesh_kind!r}")
    if (mesh is None and cfg.mesh_kind in ("mfem", "gmsh")
            and cfg.mesh_file is None):
        raise ValueError(f"mesh_kind={cfg.mesh_kind!r} needs mesh_file")
    if cfg.hi_apply not in ("auto", "ds", "f64"):
        raise ValueError(f"unknown hi_apply {cfg.hi_apply!r}")
    if cfg.hi_apply == "ds" and cfg.dtype != "mixed":
        # before any assembly; the operator half of lpfem's rule is the
        # FreeSurfaceOperator's
        raise ValueError("hi_apply='ds' needs dtype='mixed' on a separable "
                         "lattice with the top-plane essential set")
    if cfg.apply_mode not in APPLY_MODES + ("assembled",):
        raise ValueError(f"unknown apply_mode {cfg.apply_mode!r}")
    if cfg.apply_mode == "assembled" and cfg.dtype == "mixed":
        raise ValueError("apply_mode='assembled' + dtype='mixed' is not "
                         "supported (the mixed inner solve is the PA "
                         "path); use float64 or float32")
    if cfg.wave_by not in ("modes", "period", "wavelength"):
        raise ValueError(f"unknown wave_by {cfg.wave_by!r}")
    if cfg.precond not in ("jacobi", "chebyshev", "pmg"):
        raise ValueError(f"unknown precond {cfg.precond!r}")


def build_mesh(cfg: Config) -> Mesh:
    """The mesh of ``mesh_kind="mfem"`` or ``"gmsh"``: the file, refined
    ``ref_levels`` times (``lpfem.problem.build_mesh``,
    ``lpfem/problem.py:28-41``; the generated tanks need no mesh here)."""
    m = (load_gmsh if cfg.mesh_kind == "gmsh" else load_mfem)(cfg.mesh_file)
    for _ in range(cfg.ref_levels):
        m = m.uniform_refine()
    return m


def build_wave(cfg: Config, bbmin, bbmax) -> AiryWave:
    """The configured Airy wave on a tank with bounding box (bbmin, bbmax)
    (``lpfem.problem.build_wave``, ``lpfem/problem.py:44-65``)."""
    h = float(bbmax[2] - bbmin[2])
    z_top = float(bbmax[2])
    if cfg.wave_by == "modes":
        Lx = float(bbmax[0] - bbmin[0])
        return AiryWave.from_modes(H=cfg.H, m=cfg.wave_m, Lx=Lx, h=h,
                                   g=cfg.g, theta=cfg.theta, z_top=z_top)
    if cfg.wave_by == "period":
        return AiryWave.from_period(H=cfg.H, T=cfg.wave_T, h=h, g=cfg.g,
                                    theta=cfg.theta, z_top=z_top)
    k = 2.0 * np.pi / cfg.wave_lambda
    if cfg.kh_override is not None:
        # the flagship convention (``Solvers/PF_linear_par_partial.cpp:
        # 297-302``): k from lambda, kh pinned, so the Airy fields use the
        # effective depth h_eff = kh / k
        return AiryWave(H=cfg.H, k=k, h=cfg.kh_override / k, g=cfg.g,
                        theta=cfg.theta, z_top=z_top)
    return AiryWave(H=cfg.H, k=k, h=h, g=cfg.g, theta=cfg.theta, z_top=z_top)


class Problem:
    """A fully assembled LPF wave problem on one device."""

    def __init__(self, cfg: Config, device="cuda", lmax=None,
                 mesh: Mesh | None = None, build_precond: bool = True):
        """``device``: where every tensor lives (no global default; a missing
        GPU raises). ``lmax``: per-level smoother lambda_max for the
        p-multigrid (parity runs inject the reference's). ``mesh``: a mesh
        to run on instead of the configured one. ``build_precond=False``
        skips the configured preconditioner (its solves run Jacobi): the
        host-side set-up of ``ShardedProblem.from_config``, which builds its
        own."""
        _check_supported(cfg, mesh)
        self.cfg = cfg
        self.device = resolve_device(device)
        # a fresh record of spans and syncs (lpfem_torch.profiling): one
        # problem's run is not read in the next one's
        reset()
        self.mixed = cfg.dtype == "mixed"
        self.dtype, op_dtype = state_dtypes(cfg.dtype)
        if mesh is None and cfg.mesh_kind in _TANKS:
            self.space = LatticeSpace.from_config(cfg)
        else:
            mesh = build_mesh(cfg) if mesh is None else mesh
            space_cls = (CurvedLatticeSpace if mesh.elem_lattice is not None
                         else H1Space)
            self.space = space_cls(mesh, cfg.order)
        self.surf = SurfaceSpace(self.space)
        self.ess = torch.as_tensor(self.surf.surf_to_vol, device=self.device)
        bbmin, bbmax = self.space.bounding_box()
        self.wave = build_wave(cfg, bbmin, bbmax)
        # apply_mode="assembled" (``lpfem/problem.py:86-106``): the fused
        # operator keeps the geometric and preconditioning roles, the solve
        # runs on its assembled matrix
        assembled = cfg.apply_mode == "assembled"
        mode = "fused" if assembled else cfg.apply_mode
        self.op = laplace_operator(self.space, op_dtype, self.device,
                                   q=cfg.quad, mode=mode)
        self.op_hi = (laplace_operator(self.space, torch.float64,
                                       self.device, q=cfg.quad, mode=mode)
                      if self.mixed else None)
        self.op_solve = AssembledLaplace(self.op) if assembled else None
        self.dt = float(cfg.t_final_periods * self.wave.T / cfg.nsteps)
        self.t_final = float(cfg.t_final_periods * self.wave.T)

        self.relax = None
        if cfg.relax:
            X = self.surf.node_coords[:, 0]
            lam = self.wave.wavelength
            cgen = cgen_weight(X, float(bbmin[0]),
                               float(bbmin[0]) + cfg.Ng * lam)
            cabs = cabs_weight(X, float(bbmax[0]) - cfg.Ns * lam,
                               float(bbmax[0]), p=cfg.abs_power)
            self.relax = RelaxationZones.build(
                self.surf, self.wave, tau=self.dt, cgen=cgen, cabs=cabs,
                n_ramp=cfg.n_ramp, dtype=self.dtype, device=self.device)

        precond_fn = None
        if not build_precond:
            pass
        elif cfg.precond == "pmg":
            precond_fn = PMultigrid(self.op, smooth_degree=cfg.cheb_degree,
                                    h_coarsen_min_dofs=cfg.h_coarsen_min_dofs,
                                    lmax=lmax)
        elif cfg.precond == "chebyshev":
            diag = self.op.diag()
            diag[self.ess] = 1.0
            inv_diag = 1.0 / diag
            apply_c = self.op.constrained_apply_top
            lm = lmax[0] if lmax is not None else estimate_lmax(apply_c,
                                                                inv_diag)
            precond_fn = ChebyshevSmoother(apply_c, inv_diag, lm,
                                           degree=cfg.cheb_degree)
        self.precond = precond_fn
        self.fso = FreeSurfaceOperator(
            self.op, self.surf, g=cfg.g, cg_rtol_sq=cfg.cg_rtol_sq,
            cg_atol_sq=cfg.cg_atol_sq, cg_max_iter=cfg.cg_max_iter,
            precond_fn=precond_fn, op_hi=self.op_hi,
            ir_max_outer=cfg.ir_max_outer,
            ir_inner_rtol_sq=cfg.ir_inner_rtol_sq, relax=self.relax,
            hi_apply=cfg.hi_apply, op_solve=self.op_solve)
        self.last_solver_stats = None
        self._last_ok = None

    # ----------------------------------------------------------- initial data
    def initial_state(self, t: float = 0.0):
        """(y0, phi0): surface state [eta; phi_fs] and volume-potential warm
        start — zero with the top plane set to phi_fs (the reference's ICs,
        ``Solvers/PF_linear_par_partial.cpp:365-414``)."""
        w = self.wave
        eta0 = self.surf.project(lambda x, y, z: w.eta(x, y, t))
        pfs0 = self.surf.project(lambda x, y, z: w.phi_fs(x, y, t))
        y0 = torch.tensor(np.concatenate([eta0, pfs0]), dtype=self.dtype,
                          device=self.device)
        phi0 = torch.zeros(self.space.n_dofs, dtype=self.dtype,
                           device=self.device)
        phi0[self.ess] = y0[self.surf.n_dofs:]
        return y0, phi0

    def zero_state(self):
        """(y, phi) of zeros (``lpfem/problem.py:172-175``)."""
        return (torch.zeros(2 * self.surf.n_dofs, dtype=self.dtype,
                            device=self.device),
                torch.zeros(self.space.n_dofs, dtype=self.dtype,
                            device=self.device))

    def step_fn(self):
        """One RK4 step ``(t, y, phi) -> (y, phi)`` (``lpfem/problem.py:
        178-185``); on the double-single path the returned ``phi`` is a DS
        pair whatever ``phi`` was."""
        fso, dt = self.fso, self.dt

        def step(t, y, phi):
            y, aux = rk4_step(fso, t, dt, y, SolveCarry(phi, SolveStats()))
            return y, aux.phi

        return step

    # ------------------------------------------------------------------- run
    def run(self, n_steps: int | None = None, t0: float = 0.0, state=None,
            record=None):
        """RK4 loop. Returns (t, y, phi). ``record(t, y, aux)`` is called
        after every step (lpfem's per-step record hook). After the run
        ``last_solver_stats`` holds the solver telemetry; an unconverged
        stage emits a ``RuntimeWarning`` (MFEM's "No convergence!").

        On the double-single path the carry ``phi`` is a DS pair: a float
        ``phi`` (the initial state) is split once here, and a DS pair passed
        back in ``state`` (a resumed run) goes through unchanged, bit for
        bit (``lpfem/problem.py:208-213``)."""
        if n_steps is None:
            n_steps = self.cfg.nsteps
        y0, phi0 = state if state is not None else self.initial_state(t0)
        if self.fso._ds_op is not None and not isinstance(phi0, DS):
            phi0 = ds_from_f64(phi0.to(torch.float64))
        aux0 = SolveCarry(phi0, SolveStats())
        (t, y, aux), ok = rk4_run(self.fso, y0, aux0, t0, self.dt, n_steps,
                                  record=record)
        self._last_ok = ok
        self.last_solver_stats = aux.stats
        if aux.stats.unconverged:
            warnings.warn(
                "Laplace CG did not converge in at least one RK4 stage "
                f"(worst solve used {aux.stats.max_iters} iterations; "
                "threshold not met — raise cg_max_iter / ir_max_outer or "
                "loosen cg_rtol_sq)", RuntimeWarning, stacklevel=2)
        return t, y, aux.phi

    def check_state(self, y: torch.Tensor, phi: torch.Tensor) -> None:
        """Raise if the run diverged (the freeze guard tripped) or the
        returned state is non-finite: two host reads
        (``problem.check_state`` in the record of
        ``lpfem_torch.profiling``)."""
        if self._last_ok is False:
            raise FloatingPointError(
                "time integration diverged: a non-finite RK4 stage was "
                "detected and the run stopped at the last finite step")
        if isinstance(phi, DS):
            phi = ds_to_f64(phi)
        for name, v in (("free-surface state [eta; phi_fs]", y),
                        ("volume potential", phi)):
            sync("problem.check_state")
            if not bool(torch.isfinite(v).all()):
                raise FloatingPointError(f"non-finite values in {name}")

    # ----------------------------------------------------------------- errors
    def eta_error_inf(self, y: torch.Tensor, t: float,
                      quad: bool = True) -> float:
        """Max-norm error of eta against the analytic wave at time t — the
        dynamic-accuracy metric of
        ``Convergence_and_Scaling/convergence-parallel.cpp:249-281``.
        ``quad=True`` (default, as lpfem) takes the max over the surface
        elements' integration points (MFEM ``ComputeMaxError``,
        :meth:`~lpfem_torch.space.SurfaceSpace.max_error_quad`);
        ``quad=False`` the nodal max."""
        eta = y[:self.surf.n_dofs].detach().to("cpu", torch.float64).numpy()
        w = self.wave
        if quad:
            return self.surf.max_error_quad(
                eta, lambda x, yy, z: w.eta(x, yy, t))
        ex = self.surf.project(lambda x, yy, z: w.eta(x, yy, t))
        return float(np.max(np.abs(eta - ex)))

    def w_error_inf(self, phi, t: float) -> float:
        """Max-norm error of the nodal vertical velocity dphi/dz
        (:func:`~lpfem_torch.operators.nodal_z_derivative`, MFEM's
        ``GetDerivative``) against the Airy wave's at time t, over every
        dof (``lpfem/problem.py:287-295``); a DS ``phi`` is recombined to
        float64 first, as lpfem's."""
        if isinstance(phi, DS):
            phi = ds_to_f64(phi)
        w = nodal_z_derivative(self.space, phi).detach().to(
            "cpu", torch.float64).numpy()
        wv = self.wave
        ex = self.space.project(lambda x, y, z: wv.w_vel(x, y, z, t))
        return float(np.max(np.abs(w - ex)))
