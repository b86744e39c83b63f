"""Dynamic (time-dependent) potential-flow convergence studies.

Counterpart of ``experiments/pf_conv.py`` (the JAX package's driver):

- p-convergence of the full RK4 solver over one period:
  ``||eta - eta_ex||_inf`` at t = T, p = 1..8, 150 steps
  (``Convergence_and_Scaling/convergence-parallel-partial.cpp:150-305``);
- h-convergence at fixed order, also measuring ``||w - w_ex||_inf``
  (``convergence-parallel-partial-hconv.cpp:142-351``).

``--shard n`` runs each case through :class:`~lpfem_torch.shard.
ShardedProblem` over n shards (the reference's mpirun form,
``convergence-parallel.cpp:269-276``): the metrics must match the
single-shard table to round-off. lpfem's ``--chunk`` (the TPU watchdog's
program split) is not needed here: the time loop runs on the host. Tables
go to ``chiprun_out/`` (``--out`` to choose), never ``data/``.

    python -m lpfem_torch.experiments.pf_conv --mode p --max-order 8
    python -m lpfem_torch.experiments.pf_conv --mode h --order 4 --refs 2
"""

from __future__ import annotations

import argparse
import time

__all__ = ["run_case", "main"]


def run_case(args, order: int, mesh=None) -> dict:
    """One run of ``pf_linear_periodic`` at ``order`` over ``args.nsteps``
    RK4 steps (``experiments/pf_conv.py:66-95``): the eta error at the
    quadrature points and the nodal w error at the final time, the surface
    dofs and the wall of the time loop."""
    from ..configs import preset
    from ..problem import Problem
    from ..profiling import block_until_ready

    cfg = preset("pf_linear_periodic", nx=args.nx, nz=args.nz, order=order,
                 nsteps=args.nsteps, cg_max_iter=2000, dtype=args.dtype,
                 precond=args.precond if order > 1 else "jacobi")
    shard = getattr(args, "shard", 0)
    prob = Problem(cfg, args.device, mesh=mesh, build_precond=not shard)
    t0 = time.perf_counter()
    if shard:
        import torch

        from ..shard import ShardedProblem
        sprob = ShardedProblem(prob, shard)
        t, y, phi_st = sprob.run()
        block_until_ready(y)
        wall = time.perf_counter() - t0
        sprob.check_state(y, phi_st)
        phi = torch.as_tensor(sprob.phi_global(phi_st)).to(prob.device)
    else:
        t, y, phi = prob.run()
        block_until_ready(y)
        wall = time.perf_counter() - t0
        prob.check_state(y, phi)
    return dict(dofs=prob.surf.n_dofs, eta_err=prob.eta_error_inf(y, t),
                w_err=prob.w_error_inf(phi, t), wall=wall)


def main(argv=None) -> str:
    """Run the study; returns the table's path."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["h", "p"], default="p")
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--refs", type=int, default=2)
    ap.add_argument("--max-order", type=int, default=8)
    ap.add_argument("--min-order", type=int, default=1,
                    help="first order of the p sweep (resume/extend an "
                         "existing append-only table)")
    ap.add_argument("--nx", type=int, default=8)
    ap.add_argument("--nz", type=int, default=2)
    ap.add_argument("--nsteps", type=int, default=150)
    ap.add_argument("--precond", default="pmg")
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32", "mixed"])
    ap.add_argument("--shard", type=int, default=0,
                    help="run each case through the sharded runner over n "
                         "shards (0: the single-device Problem)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..io import DataFile

    if args.mode == "p":
        out = args.out or "chiprun_out/pf-parallel-pconv-eta.txt"
        df = DataFile(out, "order surf_dofs eta_err_inf w_err_inf wall_s")
        for p in range(args.min_order, args.max_order + 1):
            r = run_case(args, p)
            df.append(p, r["dofs"], r["eta_err"], r["w_err"], r["wall"])
            print(f"p={p:2d} eta_err={r['eta_err']:.3e} w_err={r['w_err']:.3e} "
                  f"wall={r['wall']:.1f}s")
    else:
        out = args.out or f"chiprun_out/pf-parallel-hconv-w{args.order}.txt"
        df = DataFile(out, "ref order surf_dofs eta_err_inf w_err_inf wall_s")
        from ..mesh import make_wave_tank
        mesh = make_wave_tank(args.nx, 1, args.nz)
        for ref in range(args.refs + 1):
            r = run_case(args, args.order, mesh=mesh)
            df.append(ref, args.order, r["dofs"], r["eta_err"], r["w_err"],
                      r["wall"])
            print(f"ref={ref} eta_err={r['eta_err']:.3e} w_err={r['w_err']:.3e} "
                  f"wall={r['wall']:.1f}s")
            if ref < args.refs:
                mesh = mesh.uniform_refine()
    return out


if __name__ == "__main__":
    main()
