"""Per-component timing of one RK4 stage of the ss.cpp tank.

Counterpart of ``experiments/solve_profile.py`` (the JAX package's driver
for this path), with its arguments and its items, each the median over
``--repeats`` runs of ``--iters`` calls enqueued back to back, timed with
CUDA events on the GPU (the host clock on the CPU):

- the constrained operator apply (the inner CG's operator);
- in mixed precision: the float64 constrained apply and a float64
  axpy + dot (the float64 outer loop's work), and, on a Kronecker lattice,
  the double-single constrained apply (kernel B4) and the double-single
  sub + add + dot (the ``hi_apply="ds"`` outer loop's work);
- the p-multigrid V-cycle;
- the free-surface z-derivative (the trace);
- one warm-started Laplace solve at the configured tolerance;
- one full RK4 step (4 solves and the surface ODEs).

The solve and the step run the outer loop that ``--hi-apply`` picks
(``Config.hi_apply``; ``auto`` keeps float64 off a TPU). It prints and
returns the times; it writes no file.

    python -m lpfem_torch.experiments.solve_profile --refs 2 --dtype mixed \\
        --rtol-sq 1e-16 [--hi-apply ds] [--device cpu]
"""

from __future__ import annotations

import argparse
import statistics
import time

__all__ = ["main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--refs", type=int, default=2)
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--precond", default="pmg")
    ap.add_argument("--cheb-degree", type=int, default=5)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--rtol-sq", type=float, default=1e-8,
                    help="CG tolerance on r.z (1e-16 = the ss.cpp protocol)")
    ap.add_argument("--hi-apply", default="auto",
                    choices=("auto", "ds", "f64"),
                    help="outer arithmetic of the mixed solve and step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ..configs import preset
    from ..ds import DS, SeparableDS, ds_add_f32, ds_from_f64, ds_sub
    from ..operators import SeparableLattice
    from ..problem import Problem

    cfg = preset("scaling_base", order=args.order, ref_levels=args.refs,
                 precond=args.precond, cheb_degree=args.cheb_degree,
                 dtype=args.dtype, cg_rtol_sq=args.rtol_sq, cg_max_iter=300,
                 hi_apply=args.hi_apply)
    prob = Problem(cfg, device=args.device)
    dev = prob.device
    fso = prob.fso
    ns = prob.surf.n_dofs
    y0, phi0 = prob.initial_state()
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"dofs={prob.space.n_dofs} order={args.order} refs={args.refs} "
          f"dtype={args.dtype} precond={args.precond} "
          f"outer={'ds' if fso._ds_op is not None else 'f64'} "
          f"device={where}")
    out = {}

    def timed(name, fn, *xs, iters=args.iters):
        fn(*xs)                                     # warm-up
        walls = []
        for _ in range(args.repeats):
            if dev.type == "cuda":
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(iters):
                    fn(*xs)
                b.record()
                b.synchronize()
                walls.append(a.elapsed_time(b) / iters)
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn(*xs)
                walls.append(1e3 * (time.perf_counter() - t0) / iters)
        out[name] = statistics.median(walls)
        print(f"{name:>24}: {out[name]:8.3f} ms")

    x = phi0
    timed("constrained apply", prob.op.constrained_apply_top,
          x.to(prob.op.dtype))
    if fso.op_hi is not None:
        timed("f64 constrained apply", fso.op_hi.constrained_apply_top, x)
        timed("f64 axpy+dot", lambda v: v + torch.dot(v, v) * 1e-30 * v, x)
        if isinstance(fso.op_hi, SeparableLattice):
            dsop = fso._ds_op or SeparableDS(fso.op_hi)
            xd = DS(x.to(torch.float32),
                    torch.zeros_like(x, dtype=torch.float32))
            timed("DS constrained apply", dsop.constrained_apply_top, xd)
            timed("DS sub+add+dot", lambda v: ds_add_f32(
                ds_sub(v, DS(v.hi * 0.5, v.lo * 0.5)),
                v.hi * torch.dot(v.hi, v.hi) * 1e-30), xd)
    if args.precond == "pmg":
        timed("V-cycle", fso._precond, x.to(prob.op.dtype))
    timed("z-derivative", fso.zderiv.top_trace, x)

    phi_seed = ds_from_f64(phi0) if fso._ds_op is not None else phi0
    phi_warm, _ = fso.solve_laplace(y0[ns:], phi_seed)
    timed("laplace solve (warm)", fso.solve_laplace, y0[ns:], phi_warm,
          iters=max(4, args.iters // 4))
    step = prob.step_fn()
    timed("full RK4 step", step, 0.0, y0, phi_seed,
          iters=max(2, args.iters // 8))
    return out


if __name__ == "__main__":
    main()
