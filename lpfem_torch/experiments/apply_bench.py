"""Operator-apply microbenchmark on one device.

Counterpart of ``experiments/apply_bench.py`` (the JAX package's driver),
its row (1): the constrained Laplace apply (the CG hot op) of the float32
operator at bench scale (``scaling_base`` + ``--refs`` refinements), on the
operator ``Problem`` picks (the Kronecker kernel B1 on this tank),
``--iters`` applies chained back to back and timed with CUDA events (the
host clock on the CPU), median of ``--repeats``.

Rows (2) and (3), as lpfem's: the same apply through
:class:`~lpfem_torch.shard.ShardedLevel` over ``--shards`` stacked shards
(the exchange and the operator's shard mode), on the z-slab window layout
(B1's shard mode, one launch over every window) and on the compact
owner-major layout (per-shard E-vectors through B3a). lpfem's
``--cylinder`` tiers are not ported. It prints the times and writes no
file.

    python -m lpfem_torch.experiments.apply_bench --refs 1 [--iters 100]
"""

from __future__ import annotations

import argparse

__all__ = ["main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--refs", type=int, default=1)
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--ny", type=int, default=2)
    ap.add_argument("--nz", type=int, default=8)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    import numpy as np

    from ..bench import chained_ms
    from ..configs import preset
    from ..problem import Problem
    from ..shard import Partition, ShardComm, ShardedLevel

    cfg = preset("scaling_base", order=args.order, ref_levels=args.refs,
                 nx=args.nx, ny=args.ny, nz=args.nz, dtype="float32",
                 precond="jacobi")
    prob = Problem(cfg, args.device)
    dev = prob.device
    n = prob.space.n_dofs
    op, ess = prob.op, prob.ess
    print(f"dofs={n} order={args.order} refs={args.refs} "
          f"backend={dev.type} operator={type(op).__name__}")

    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(n, generator=gen, dtype=torch.float64).to(
        device=dev, dtype=torch.float32)
    t1 = chained_ms(lambda v: op.constrained_apply(v, ess), x, dev,
                    n=args.iters, repeats=args.repeats) / 1e3
    print(f"single apply [{type(op).__name__}]: {t1 * 1e3:.4f} ms "
          f"({n * 4 * 2 / t1 / 1e9:.1f} GB/s eff)")
    out = {"single_ms": t1 * 1e3, "device": dev.type,
           "operator": type(op).__name__}
    ess_np = prob.surf.surf_to_vol
    comm = ShardComm(args.shards)
    for layout, label in (("auto", "window"), ("compact", "compact")):
        pt = Partition(prob.space, args.shards, layout=layout)
        if layout == "auto" and pt.win is None:
            print("window layout unavailable; skipping")
            continue
        lv = ShardedLevel(op, pt, ess_np, comm, dev)
        x_st = torch.as_tensor(pt.stack_dof(
            x.cpu().numpy().astype(np.float64))).to(device=dev,
                                                     dtype=torch.float32)
        t = chained_ms(lv.apply_c, x_st, dev, n=args.iters,
                       repeats=args.repeats) / 1e3
        print(f"sharded[{label}/{lv.mode}] x{args.shards}: {t * 1e3:.4f} ms "
              f"({t / t1:.2f}x single), exchange {lv.exchange}")
        out[f"sharded_{label}_ms"] = t * 1e3
    return out


if __name__ == "__main__":
    main()
