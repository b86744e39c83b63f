"""Typed configuration + presets reproducing each reference program.

The reference hard-codes every parameter in 21 separate ``main()``s and is
reconfigured by editing constants and recompiling (e.g. the strong/weak mode
flag ``Convergence_and_Scaling/ss.cpp:125``; the commented wave-parameter
variants ``Solvers/PF_linear_par_partial.cpp:298-341``). Here each program is
a named preset of one dataclass; ``lpfem_torch.problem.Problem`` assembles a
run from it.

Field names, defaults and presets are those of ``lpfem.configs`` (the JAX
reference), so that a configuration drives either package, minus the
TPU-only ``mixed_inner_precision`` (the MXU's product precision; the port
keeps full-float32 products always, ``lpfem_torch/__init__.py``). The
comments that mention the TPU describe the reference's behaviour.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

__all__ = ["Config", "PRESETS", "preset"]


@dataclass
class Config:
    name: str = "custom"
    # ---- mesh ----
    mesh_kind: str = "periodic_tank"     # periodic_tank | finite_tank | mfem | gmsh
    nx: int = 3
    ny: int = 1
    nz: int = 1
    Lx: float = 1.0
    Ly: float = 0.1
    Lz: float = 1.0 / (2 * np.pi)
    mesh_file: str | None = None
    ref_levels: int = 0
    # ---- discretization ----
    order: int = 2
    quad: int | None = None              # default order+1 GL points
    apply_mode: str = "pallas"           # pallas | fused | sumfact | assembled
                                         # (pallas auto-falls-back to fused
                                         #  off-TPU or in f64; assembled runs
                                         #  the CG solve on the ELL SpMV of
                                         #  the fully assembled matrix, the
                                         #  PF_linear_par configuration)
    dtype: str = "float64"
    # ---- wave ----
    H: float = 0.005
    g: float = 9.81
    wave_by: str = "modes"               # modes | period | wavelength
    wave_m: float = 2.0                  # modes across Lx    (periodic tanks)
    wave_T: float = 1.13392 / 3          # seconds            (wave_by=period)
    wave_lambda: float = 1.0             # meters             (wave_by=wavelength)
    kh_override: float | None = None     # flagship pins kh=1 with k=2pi
    theta: float = 0.0
    # ---- time integration ----
    nsteps: int = 500
    t_final_periods: float = 1.0
    # ---- linear solver ----
    cg_rtol_sq: float = 1e-24            # on r.z (squared), MFEM convention
    cg_atol_sq: float = 0.0              # absolute floor on r.z (stops warm-
                                         # started solves from chasing ever-
                                         # smaller relative targets)
    cg_max_iter: int = 400
    ir_max_outer: int = 4                # dtype="mixed": max iterative-
                                         # refinement passes of the outer
                                         # f64 residual loop (the stationary
                                         # p-sweep needed 8 at p>=8)
    ir_inner_rtol_sq: float = 1e-8       # dtype="mixed": inner f32 CG
                                         # threshold on r.z per pass; must
                                         # stay well above the f32 floor
                                         # (~1e-10) — see solvers.pcg_ir
    hi_apply: str = "auto"               # dtype="mixed" outer arithmetic:
                                         # ds = double-single (two-f32,
                                         # lpfem_torch.ds; needs a separable
                                         # lattice), f64 = float64; auto =
                                         # float64 (lpfem picks ds only on
                                         # a TPU, where f64 is emulated)
    precond: str = "jacobi"              # jacobi | chebyshev | pmg
    cheb_degree: int = 3                 # smoother degree (chebyshev / pmg)
    h_coarsen_min_dofs: int = 20000      # pmg: h-coarsen below p=1 while the
                                         # bottom level is larger than this
    # ---- distributed runtime ----
    shard_exchange: str = "auto"         # auto | ppermute | psum: interface
                                         # halo exchange as neighbor ppermute
                                         # (slab partitions; O(|S|/ndev) per-
                                         # device traffic) or global psum
    # ---- relaxation zones ----
    relax: bool = False
    Ng: float = 2.0                      # generation zone length, wavelengths
    Ns: float = 2.0                      # absorption zone length, wavelengths
    n_ramp: float = 3.0                  # generation ramp, periods
    abs_power: float = 5.0               # Cabs = xi^p


PRESETS: dict[str, Config] = {}


def _register(cfg: Config) -> Config:
    PRESETS[cfg.name] = cfg
    return cfg


def preset(name: str, **overrides) -> Config:
    return replace(PRESETS[name], **overrides)


# ``Solvers/PF_linear_periodic.cpp``: serial periodic standing-wave tank,
# order 2, wave-tank.mesh (3x1x1 periodic), m=2 modes, H=0.005, RK4 500
# steps over one period, GS+PCG(400, 1e-24).
_register(Config(
    name="pf_linear_periodic", mesh_kind="periodic_tank", nx=3, ny=1, nz=1,
    order=2, H=0.005, wave_by="modes", wave_m=2.0,
    nsteps=500, t_final_periods=1.0, cg_rtol_sq=1e-24, cg_max_iter=400,
))

# ``Solvers/PF_linear_periodic_par.cpp``: parallel periodic variant, order 4,
# PARTIAL assembly + Jacobi, CG rel 1e-12 maxit 2000, 60 steps over 2T.
_register(Config(
    name="pf_linear_periodic_par", mesh_kind="periodic_tank", nx=3, ny=1, nz=1,
    order=4, H=0.005, wave_by="modes", wave_m=2.0,
    nsteps=60, t_final_periods=2.0, cg_rtol_sq=1e-24, cg_max_iter=2000,
))

# ``Solvers/PF_linear_serial.cpp``: finite tank with relaxation zones,
# order 5 + 1 refinement, wave by period T=1.13392/3, H=0.05, 800 steps over
# 8T, Ng=2, Ns=2, ramp 3T, PCG(400, 1e-24).
_register(Config(
    name="pf_linear_serial", mesh_kind="finite_tank", nx=36, ny=1, nz=1,
    Lx=12.0, Ly=1.0, ref_levels=1, order=5, H=0.05,
    wave_by="period", wave_T=1.13392 / 3,
    nsteps=800, t_final_periods=8.0, cg_rtol_sq=1e-24, cg_max_iter=400,
    relax=True, Ng=2.0, Ns=2.0, n_ramp=3.0,
))

# ``Solvers/PF_linear_par.cpp``: MPI full assembly + BoomerAMG-CG, order 4,
# wave by wavelength lambda=2 (``:289-298``), CG rel 1e-12 maxit 1000.
_register(Config(
    name="pf_linear_par", mesh_kind="finite_tank", nx=36, ny=1, nz=1,
    Lx=12.0, Ly=1.0, order=4, H=0.01,
    wave_by="wavelength", wave_lambda=2.0,
    nsteps=180, t_final_periods=5.0, cg_rtol_sq=1e-24, cg_max_iter=1000,
    relax=True, Ng=2.5, Ns=4.0, n_ramp=3.0,
))

# ``Solvers/PF_linear_par_partial.cpp`` (FLAGSHIP): MPI partial assembly +
# Jacobi-CG, order 4, wave-tank-finite.mesh, lambda=1 with kh pinned to 1
# (``:297-302``), H=0.01, 180 steps over 5T, Ng=2.5, Ns=4, ramp 3T,
# CG rel 1e-12 maxit 1000.
_register(Config(
    name="pf_linear_par_partial", mesh_kind="finite_tank", nx=36, ny=1, nz=1,
    Lx=12.0, Ly=1.0, order=4, H=0.01,
    wave_by="wavelength", wave_lambda=1.0, kh_override=1.0,
    nsteps=180, t_final_periods=5.0, cg_rtol_sq=1e-24, cg_max_iter=1000,
    relax=True, Ng=2.5, Ns=4.0, n_ramp=3.0,
))

# ``Convergence_and_Scaling/ss.cpp``: scaling harness base — wave-tank-big
# (512 hexes) + parallel refinement, 10 RK4 steps, maxit 300 and
# ``SetRelTol(1e-8)`` (``ss.cpp:90-93``) — which in MFEM's CGSolver
# semantics means convergence on r.z <= rz0 * (1e-8)^2 = rz0 * 1e-16
# (see lpfem.solvers docstring). An f32 solve cannot reach that floor;
# the faithful protocol runs dtype="mixed" (f64 state + residuals, exact-f32
# inner operator) — bench.py's default. strongscaling.cpp's long-run variant
# overrides to cg_rtol_sq=1e-24 (SetRelTol(1e-12), ``strongscaling.cpp:87``).
_register(Config(
    name="scaling_base", mesh_kind="periodic_tank", nx=32, ny=2, nz=8,
    order=4, H=0.005, wave_by="modes", wave_m=2.0,
    nsteps=10, t_final_periods=1.0, cg_rtol_sq=1e-16, cg_max_iter=300,
))
