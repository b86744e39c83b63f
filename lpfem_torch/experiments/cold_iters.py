"""The cold solve's inner CG iterations on the ss.cpp tank against the
smoother bounds the p-multigrid is given.

The bench twin's cold solve (``lpfem_torch.bench.bench_once``: the ss.cpp
protocol's settings, ``scaling_base`` refined ``--refs`` times, order 4,
mixed, r.z <= rz0*1e-16, maxit 300, p-multigrid with Chebyshev degree 4)
from the initial state, once per set of per-level lambda_max: each
``--lmax`` list (e.g. the JAX reference's, read off its smoothers), and the
port's own power iteration from each of ``--seeds`` (seed 0 is what the
port runs). The reference's count is 8 at refs 1-3
(``data/bench-scales.txt``). One row per run goes to
``chiprun_out/cold-iters-refs<refs>.txt`` unless ``--out`` is given.

    python -m lpfem_torch.experiments.cold_iters --refs 3 --seeds 0 1 2 3 \\
        --lmax 2.394,2.390,3.054,3.060,3.039
    python -m lpfem_torch.experiments.cold_iters --refs 0 --device cpu
"""

from __future__ import annotations

import argparse
import time

__all__ = ["cold_row", "main"]


def _config(refs: int):
    from ..configs import preset
    return preset("scaling_base", order=4, ref_levels=refs, nx=32, ny=2,
                  nz=8, precond="pmg", cheb_degree=4, dtype="mixed",
                  cg_rtol_sq=1e-16, cg_max_iter=300)


def cold_row(refs: int, device, lmax=None, seed: int | None = None) -> dict:
    """One cold solve: the p-multigrid given ``lmax``, or estimating it
    from ``seed``; returns the bounds, the inner iterations and whether
    the solve converged."""
    from ..multigrid import estimate_lmax
    from ..problem import Problem

    cfg = _config(refs)
    t0 = time.perf_counter()
    prob = Problem(cfg, device, lmax=lmax)
    if seed:
        lmax = [estimate_lmax(lv.apply_c, lv.inv_diag, seed=seed)
                for lv in prob.precond.levels]
        prob = Problem(cfg, device, lmax=lmax)
    setup = time.perf_counter() - t0
    y0, phi0 = prob.initial_state()
    _, info = prob.fso.solve_laplace(y0[prob.surf.n_dofs:], phi0)
    return dict(refs=refs, dofs=prob.space.n_dofs,
                source="given" if seed is None else f"seed {seed}",
                lmax=list(prob.precond.lmax), cg_iters=int(info.iters),
                converged=bool(info.converged), setup_s=setup)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--refs", type=int, default=3)
    ap.add_argument("--seeds", type=int, nargs="*", default=[0])
    ap.add_argument("--lmax", action="append", default=[],
                    help="comma-separated per-level lambda_max (repeatable)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..io import DataFile

    dev = resolve_device(args.device)
    out = args.out or f"chiprun_out/cold-iters-refs{args.refs}.txt"
    df = DataFile(out, "refs dofs source cg_iters converged lmax...")
    runs = [dict(lmax=[float(v) for v in s.split(",")]) for s in args.lmax]
    runs += [dict(seed=s) for s in args.seeds]
    rows = []
    for run in runs:
        r = cold_row(args.refs, dev, **run)
        rows.append(r)
        df.append(r["refs"], r["dofs"], r["source"].replace(" ", "_"),
                  r["cg_iters"], int(r["converged"]), *r["lmax"])
        print(f"refs={r['refs']} dofs={r['dofs']} {r['source']}: "
              f"lmax={r['lmax']} cold iterations={r['cg_iters']} "
              f"converged={r['converged']} setup={r['setup_s']:.2f}s",
              flush=True)
    print(f"table -> {out}")
    return rows


if __name__ == "__main__":
    main()
