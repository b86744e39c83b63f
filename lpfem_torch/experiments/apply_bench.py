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
owner-major layout (per-shard E-vectors through B3a; ``--skip-compact``
leaves it out).

``--cylinder`` times instead the float32 apply on the half-cylinder tank
(``--n-theta``, ``--n-r``, ``--cyl-nz``; curved elements, B3b) on the
three numberings an imported mesh can land on, as lpfem's
(``experiments/apply_bench.py:40-95``): the declared element lattice, the
recovered z-extrusion (the lattice stripped: the extruded column
renumbering), and the raw topological numbering (no detection: the plain
``x[elem_dofs]`` gather). The port's transfer is the same index gather and
fold on all three; the numbering sets its locality. It prints the times and
writes no file.

    python -m lpfem_torch.experiments.apply_bench --refs 1 [--iters 100]
    python -m lpfem_torch.experiments.apply_bench --cylinder
"""

from __future__ import annotations

import argparse

__all__ = ["main", "cylinder_main"]


def cylinder_main(args) -> dict:
    """The three tiers on the half-cylinder tank; ns per dof of each."""
    import torch

    import numpy as np

    from .. import resolve_device
    from ..bench import chained_ms
    from ..cylmesh import make_half_cylinder_tank
    from ..mesh import Mesh
    from ..operators import laplace_operator
    from ..space import H1Space

    dev = resolve_device(args.device)
    m = make_half_cylinder_tank(n_theta=args.n_theta, n_r=args.n_r,
                                nz=args.cyl_nz, geom_order=args.order,
                                dr_max=0.25)
    m2 = Mesh(m.verts, m.elems, m.corner_coords, m.bdr_quads, m.bdr_attrs,
              m.periodic, m.geom_nodes, m.geom_order,
              periodic_axes=m.periodic_axes)          # the lattice stripped
    rng = np.random.default_rng(0)
    out = {"device": dev.type}
    for label, mesh, structured in (("lattice", m, True),
                                    ("column", m2, True),
                                    ("gather", m2, False)):
        sp = H1Space(mesh, args.order, structured=structured)
        if label == "lattice" and sp.struct is None:
            raise RuntimeError("the declared lattice was not taken")
        if label == "column" and sp.extruded is None:
            raise RuntimeError("the z-extrusion was not recovered")
        if label == "gather" and (sp.struct is not None
                                  or sp.extruded is not None):
            raise RuntimeError("the raw numbering was not kept")
        op = laplace_operator(sp, torch.float32, dev)
        x = torch.tensor(rng.standard_normal(sp.n_dofs),
                         dtype=torch.float32, device=dev)
        t = chained_ms(op.apply, x, dev, n=args.iters,
                       repeats=args.repeats) / 1e3
        per_dof = t / sp.n_dofs * 1e9
        print(f"{label:>8}: {t * 1e3:.4f} ms  ({per_dof:.3f} ns/dof, "
              f"dofs={sp.n_dofs}, {type(op).__name__})")
        out[f"{label}_ms"] = t * 1e3
        out[f"{label}_ns_per_dof"] = per_dof
    print(f"column vs lattice per-dof ratio: "
          f"{out['column_ns_per_dof'] / out['lattice_ns_per_dof']:.2f}x; "
          f"gather vs lattice: "
          f"{out['gather_ns_per_dof'] / out['lattice_ns_per_dof']:.2f}x")
    return out


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
    ap.add_argument("--skip-compact", action="store_true",
                    help="skip the compact-layout sharded row")
    ap.add_argument("--cylinder", action="store_true",
                    help="time the three numberings of an imported mesh on "
                         "the half-cylinder tank instead")
    ap.add_argument("--n-theta", type=int, default=96)
    ap.add_argument("--n-r", type=int, default=16)
    ap.add_argument("--cyl-nz", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.cylinder:
        return cylinder_main(args)

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
    layouts = (("auto", "window"),) + (
        () if args.skip_compact else (("compact", "compact"),))
    for layout, label in layouts:
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
