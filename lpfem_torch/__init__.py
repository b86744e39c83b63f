"""lpfem_torch — linear potential-flow FEM in PyTorch, for NVIDIA Hopper.

A port of ``lpfem`` (the JAX package beside it, which stays the reference)
to PyTorch with hand-written CUDA kernels. Module names mirror ``lpfem`` so a
reader can find each counterpart:

    configs    the reference's Config / presets, minus a TPU-only field
    elements   GLL Lagrange basis / quadrature tables (NumPy)
    analytic   Airy wave, dispersion, McCamy-Fuchs series
    mesh       hex mesh record, refinement, Cartesian tank generators, MFEM
               mesh files
    cylmesh    the curved half-cylinder diffraction tank generator
    space      LatticeSpace (Cartesian tank), CurvedLatticeSpace (declared
               element lattice), H1Space (topological numbering of any
               mesh), SurfaceSpace (the free surface)
    geometry   metric / Jacobian tables of the elements (NumPy, f64)
    convert    lpfem state (a double-single potential too) / smoother
               tables <-> this package's layout
    ds         double-single (two-float32) arithmetic and the double-single
               Kronecker apply (SeparableDS)
    kernels    CUDA kernels + their plain-PyTorch versions
    operators  banded Kronecker Laplace (SeparableLattice), fused affine
               lattice Laplace (AffineLatticeLaplace), element-form Laplace
               (ElementLaplace), the rule that picks one, free-surface trace
    solvers    PCG and mixed-precision iterative refinement, with a float64
               or a double-single outer loop (host loops), and the
               stationary drivers' refinement loop (pcg_refined)
    multigrid  Chebyshev-Jacobi smoother and p/h-multigrid V-cycle
    surface    free-surface right-hand side, relaxation zones
    timestep   RK4 with the non-finite freeze guard and a record hook
    problem    Config (+ mesh) -> operators -> time loop
    shard      the sharded solver: z-slab / owner-major partitions, the halo
               exchange, B1's and B2's shard modes, the sharded
               p-multigrid and RK4 loop, shards stacked on one device or
               one per rank of a process group (GroupComm)
    dist       shards as processes: the rank launcher (run_ranks), the
               rank's group (rank_group), the rank program (run_spec)
    io         VTU / PVD output, data files, checkpoints (NumPy)
    profiling  spans and their record (stream markers, host-sync counts),
               torch.profiler trace, finite-state check
    bench      the headline benchmark (``python -m lpfem_torch.bench``)
    entry      one RK4 step of the flagship model, ``(fn, example_args)``;
               ``dryrun_multichip``, the sharded step against the unsharded
    experiments.diffraction    the wave-cylinder diffraction study
    experiments.leaning_tank   the periodic tank meshed with sheared elements
    experiments.solve_profile  per-component times of one RK4 stage
    experiments.apply_bench    the constrained apply's time
    experiments.laplace_conv   stationary Laplace p- and h-convergence
    experiments.pf_conv        time-dependent p- and h-convergence
    experiments.pf_run         any preset, with ParaView output and
                               checkpoint / resume
    experiments.scaling        strong / weak scaling over the shard count
                               (--processes: the shards as gloo ranks)
    experiments.cold_iters     the cold solve's iterations against the
                               smoother bounds (lambda_max) it is given

Device and dtype policy: every constructor takes an explicit ``device``;
``dtype="mixed"`` keeps the state and the outer residual in float64 and runs
the inner solve (operator, preconditioner) in float32. With
``hi_apply="ds"`` (Kronecker lattices only) the outer residual runs in
double-single arithmetic instead, no float64 anywhere in the solve, and the
volume potential is carried as a ``ds.DS`` pair; ``"auto"`` keeps float64.
The package never imports ``jax`` or ``lpfem``.
"""

import torch

# Full-f32 products everywhere: the multigrid transfers and the dense coarse
# inverse are f32 matmuls, and TF32 (about three decimal digits) would cap the
# inner correction exactly like the TPU's bf16 matmul default does for the
# reference (``mixed_inner_precision``, a TPU-only field of lpfem's Config).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and no
    GPU is present (the main path has no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA GPU "
                           "is available")
    return dev


def state_dtypes(dtype: str) -> tuple[torch.dtype, torch.dtype]:
    """(state/outer dtype, inner operator dtype) for ``Config.dtype``."""
    if dtype == "mixed":
        return torch.float64, torch.float32
    if dtype in ("float64", "float32"):
        dt = getattr(torch, dtype)
        return dt, dt
    raise ValueError(f"unknown dtype {dtype!r}")


# after the policy helpers: problem.py imports them from here
from .configs import PRESETS, Config, preset  # noqa: E402
from .problem import Problem  # noqa: E402

__all__ = ["Config", "PRESETS", "preset", "Problem", "resolve_device",
           "state_dtypes"]
