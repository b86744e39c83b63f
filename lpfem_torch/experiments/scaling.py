"""Strong / weak scaling over the shard count, on one device.

Counterpart of ``experiments/scaling.py`` (the JAX package's driver), the
reference's protocol (``Convergence_and_Scaling/ss.cpp``, ``ws.cpp``,
``strongscaling.cpp`` + ``ss.sh`` / ``ws.sh``): 10 RK4 steps (40 Laplace
solves), orders {3, 4}, a warm-up step excluded, the wall of each repeat
ending in a device synchronisation, the median over ``--repeats``. Shard
counts sweep :class:`~lpfem_torch.shard.ShardedProblem`'s stacked shards
on one device, where lpfem sweeps a device mesh: the rows check the
shard-count invariance of the physics and time the sharded path's
overheads, not a speed-up across devices.

- strong: the fixed tank (``scaling_base``, 32 x 2 x 8 hexes + ``--par-ref``
  refinements), shards ``--shards``;
- weak: the mesh family 32/64/64/128 x 2 x 8/8/16/16 paired with shards
  1/2/4/8 (``ws.cpp:116-128``).

With ``--processes`` each row's shards run as the ranks of a gloo process
group on the device (``lpfem_torch.dist.run_ranks``: one process per shard,
the exchange through the host), the twin of lpfem's mesh of devices; rank
0 reports the row. The stacked mode stays the default.

Each row: the dofs, the median wall, dof x solves per second, the inner CG
iterations of a cold solve (zero warm start), whether every timed stage
converged, the exchange (``ppermute``-style neighbour shifts or ``psum``)
and its interface size, and the halo bytes one apply moves. lpfem's
``--virtual-devices`` and ``--chunk`` (TPU plumbing) and its modelled
inter-chip times are not ported. The table goes to
``chiprun_out/<mode>-scaling-torch.txt`` unless ``--out`` is given.

    python -m lpfem_torch.experiments.scaling --mode strong --shards 1 2 4 \\
        --orders 4 --par-ref 2 --precond pmg --repeats 1
    python -m lpfem_torch.experiments.scaling --mode weak --device cpu
    python -m lpfem_torch.experiments.scaling --shards 2 3 --orders 2 \\
        --processes --device cpu --steps 1 --repeats 1
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

__all__ = ["WEAK_MESHES", "run_row", "main"]

WEAK_MESHES = {1: (32, 2, 8), 2: (64, 2, 8), 4: (64, 2, 16), 8: (128, 2, 16)}
RANK_TIMEOUT_S = 1800.0          # a row's ranks (--processes)


def run_row(args, order: int, ns: int, comm=None) -> dict:
    """One row: build the sharded problem, a cold solve, a warm-up step,
    then ``args.repeats`` timed runs of ``args.steps`` RK4 steps; over the
    process group of ``comm`` (a ``shard.GroupComm``) where given."""
    import numpy as np

    from ..configs import preset
    from ..problem import Problem
    from ..profiling import block_until_ready
    from ..shard import ShardedProblem

    if args.mode == "weak":
        near = min(WEAK_MESHES, key=lambda k: abs(k - ns))
        nx, ny, nz = WEAK_MESHES.get(ns, WEAK_MESHES[near])
        par_ref = 0
    else:
        nx, ny, nz = WEAK_MESHES[1]
        par_ref = args.par_ref
    kw = dict(order=order, nx=nx, ny=ny, nz=nz, ref_levels=par_ref,
              dtype=args.dtype, precond=args.precond,
              cg_rtol_sq=args.rtol_sq, cg_max_iter=args.max_iter,
              nsteps=args.steps)
    if args.cheb_degree is not None:
        kw["cheb_degree"] = args.cheb_degree
    cfg = preset("scaling_base", **kw)
    t0 = time.perf_counter()
    prob = Problem(cfg, args.device, build_precond=False)
    sprob = ShardedProblem(prob, ns, comm=comm)
    setup = time.perf_counter() - t0
    y0, phi0 = sprob.initial_state()
    ns_surf = sprob.NSurf
    _, cold = sprob.solve_laplace(y0[ns_surf:], phi0)
    block_until_ready(sprob.run(n_steps=1, state=(y0, phi0))[1])   # warm-up

    walls = []
    for _ in range(args.repeats):
        t1 = time.perf_counter()
        t, y, phi = sprob.run(n_steps=args.steps, state=(y0, phi0))
        block_until_ready(y)
        walls.append(time.perf_counter() - t1)
    sprob.check_state(y, phi)
    stats = sprob.last_solver_stats
    med = statistics.median(walls)
    n = prob.space.n_dofs
    itemsize = np.dtype("float32" if args.dtype == "mixed"
                        else args.dtype).itemsize
    lv = sprob.fine
    if lv.exchange == "ppermute":
        halo_bytes = 2 * max(lv.Wf, lv.Ww) * itemsize
    else:
        halo_bytes = 2 * (lv.NS + 1) * itemsize
    return dict(mode=args.mode, order=order, par_ref=par_ref, shards=ns,
                dofs=n, dtype=args.dtype, rtol_sq=args.rtol_sq,
                precond=args.precond, setup_s=setup, median_wall_s=med,
                dof_solves_per_s=n * 4 * args.steps / med,
                cold_iters=cold.iters, cold_converged=cold.converged,
                converged=not stats.unconverged,
                total_iters=stats.total_iters, exchange=lv.exchange,
                NS=lv.NS, halo_B_per_apply=halo_bytes, walls=walls,
                layout="window" if sprob.pt.win is not None else "compact",
                eta_abs_max=float(y[:ns_surf].abs().max()),
                processes=comm is not None)


def _rank_argv(args, order: int, ns: int) -> list[str]:
    """The rank program's command line for one row."""
    argv = ["-m", "lpfem_torch.experiments.scaling", "--as-rank",
            "--mode", args.mode, "--shards", str(ns), "--orders", str(order),
            "--steps", str(args.steps), "--par-ref", str(args.par_ref),
            "--repeats", str(args.repeats), "--rtol-sq", repr(args.rtol_sq),
            "--max-iter", str(args.max_iter), "--dtype", args.dtype,
            "--precond", args.precond, "--device", args.device]
    if args.cheb_degree is not None:
        argv += ["--cheb-degree", str(args.cheb_degree)]
    return argv


def run_row_ranks(args, order: int, ns: int) -> dict:
    """One row over ``ns`` ranks (``lpfem_torch.dist.run_ranks``); rank 0
    prints the row as the last line of its output."""
    from ..dist import run_ranks
    outs = run_ranks(_rank_argv(args, order, ns), ns, RANK_TIMEOUT_S)
    return json.loads(outs[0].strip().splitlines()[-1])


def _rank(args) -> None:
    from ..dist import rank_group
    with rank_group() as comm:
        row = run_row(args, args.orders[0], args.shards[0], comm)
        if comm.rank == 0:
            print(json.dumps(row), flush=True)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["strong", "weak"], default="strong")
    ap.add_argument("--shards", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--orders", type=int, nargs="+", default=[3, 4])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--par-ref", type=int, default=0,
                    help="extra refinements (strong mode)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--rtol-sq", type=float, default=1e-16,
                    help="CG threshold on r.z relative to rz0 (MFEM "
                         "SetRelTol(t) == t^2 here: ss.cpp's SetRelTol(1e-8) "
                         "-> 1e-16)")
    ap.add_argument("--max-iter", type=int, default=300,
                    help="CG maxit (ss.cpp 300; strongscaling.cpp 2000)")
    ap.add_argument("--dtype", default="mixed",
                    choices=["mixed", "float32", "float64"])
    ap.add_argument("--precond", default="jacobi",
                    choices=["jacobi", "chebyshev", "pmg"],
                    help="ss.cpp uses partial assembly + Jacobi")
    ap.add_argument("--cheb-degree", type=int, default=None,
                    help="smoother degree (default: the preset's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--processes", action="store_true",
                    help="run each row's shards as ranks of a gloo group")
    ap.add_argument("--as-rank", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.as_rank:
        _rank(args)
        return []

    from ..io import DataFile

    out = args.out or f"chiprun_out/{args.mode}-scaling-torch.txt"
    df = DataFile(out, "mode order par_ref shards dofs dtype rtol_sq precond "
                       "layout median_wall_s dof_solves_per_s cold_iters "
                       "converged exchange NS halo_B_per_apply runs...")
    rows = []
    for order in args.orders:
        for ns in args.shards:
            r = (run_row_ranks(args, order, ns) if args.processes
                 else run_row(args, order, ns))
            rows.append(r)
            df.append(r["mode"], order, r["par_ref"], ns, r["dofs"],
                      args.dtype, args.rtol_sq, args.precond, r["layout"],
                      r["median_wall_s"], r["dof_solves_per_s"],
                      r["cold_iters"], int(r["converged"]), r["exchange"],
                      r["NS"], r["halo_B_per_apply"], *r["walls"])
            print(f"{args.mode} order={order} shards={ns} dofs={r['dofs']} "
                  f"layout={r['layout']} median={r['median_wall_s']:.3f}s "
                  f"cold_iters={r['cold_iters']} converged={r['converged']} "
                  f"exchange={r['exchange']} NS={r['NS']} "
                  f"halo_B/apply={r['halo_B_per_apply']} "
                  f"processes={r['processes']} setup={r['setup_s']:.2f}s",
                  flush=True)
    print(f"table -> {out}")
    return rows


if __name__ == "__main__":
    main()
