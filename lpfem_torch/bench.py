"""Headline benchmark: the reference's strong-scaling protocol on one GPU.

Counterpart of ``bench.py`` (the JAX package's, at the repository root).
Protocol (``Convergence_and_Scaling/ss.cpp:90-93,254-286`` + ``ss.sh``): 10
RK4 steps = 40 Laplace solves on the periodic big wave tank
(``preset("scaling_base")``, refined ``--refs`` times), order 4, mixed
precision (float64 state and outer residual, float32 inner CG), r.z <=
rz0 * 1e-16 (MFEM ``SetRelTol(1e-8)``), maxit 300, p-multigrid with
Chebyshev-4 smoothing. One warm-up step is excluded (``ss.cpp:254``); the
wall of each repeat ends in a device synchronisation, and the median over
``--repeats`` is reported.

Metric: dofs x Laplace solves per wall second (``laplace_dof_throughput``).
Also reported: whether every timed stage's solve converged and the timed
inner CG iterations, the inner CG iterations of a cold solve (zero warm
start) at the protocol tolerance, the chained constrained-apply time (30 applies
back to back, CUDA events), the host set-up seconds, the peak device memory
(``torch.cuda.max_memory_allocated``) and the process's peak resident set.
Like ``bench.py`` it prints one JSON line, with ``backend: "cuda"`` and the
card's name and power limit (nvidia-smi) in ``detail``. It has no
``vs_baseline``: the repository's ``BENCH_r*.json`` records are TPU runs of
the JAX package, not earlier runs on this card, and the twin reads none of
them.

Not ported: ``bench.py``'s ``--chunk`` and its re-exec on a wedged TPU (TPU
plumbing), and the double-single outer loop, which ``bench.py`` has no flag
for either.

    python -m lpfem_torch.bench [--order 4] [--refs 2] [--dtype mixed]
    python -m lpfem_torch.bench --scales 1,2,3,4
    python -m lpfem_torch.bench --refs 0 --order 2 --steps 2 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import statistics
import subprocess
import time

__all__ = ["parser", "bench_once", "card", "chained_ms", "main"]

N_APPLY = 30          # chained constrained applies per timing


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--refs", type=int, default=2,
                    help="2 = 2.18M dofs, the ss.cpp big-tank + 1 parallel "
                         "refinement protocol scale")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dtype", default="mixed",
                    help="mixed (faithful: f64 residuals + exact-f32 inner "
                         "operator, reaches the rz0*1e-16 floor) | float32 "
                         "| float64")
    ap.add_argument("--rtol-sq", type=float, default=1e-16,
                    help="CG convergence threshold on r.z relative to rz0 "
                         "(MFEM SetRelTol(t) == t^2 here; ss.cpp's "
                         "SetRelTol(1e-8) -> 1e-16)")
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--ny", type=int, default=2)
    ap.add_argument("--nz", type=int, default=8)
    ap.add_argument("--precond", default="pmg",
                    choices=["jacobi", "chebyshev", "pmg"])
    ap.add_argument("--cheb-degree", type=int, default=4,
                    help="smoother degree for chebyshev/pmg")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timing repeats; median reported")
    ap.add_argument("--no-secondary", action="store_true",
                    help="skip the f32 @ rtol_sq=1e-8 secondary measurement")
    ap.add_argument("--scales", default=None,
                    help="comma list of refs (e.g. 1,2,3,4): run the "
                         "protocol at each scale and write "
                         "chiprun_out/bench-scales-<device>.txt")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the benchmark) | cpu (a check of the code "
                         "path; its times are the CPU's)")
    return ap


def card(device) -> tuple[str, str | None]:
    """(name, power limit) of the card behind ``device`` (nvidia-smi's
    ``power.limit``), or ("cpu", None)."""
    import torch
    if device.type != "cuda":
        return "cpu", None
    idx = (device.index if device.index is not None
           else torch.cuda.current_device())
    out = subprocess.run(
        ["nvidia-smi", f"--id={idx}", "--query-gpu=power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return torch.cuda.get_device_name(idx), out


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def chained_ms(fn, x, device, n: int = N_APPLY, repeats: int = 3) -> float:
    """Median over ``repeats`` chains of ``n`` calls ``v = fn(v)`` from
    ``x`` of the ms per call, after one chain of warm-up: CUDA events on the
    GPU, the host clock on the CPU."""
    import torch

    def chain():
        v = x
        for _ in range(n):
            v = fn(v)

    chain()
    _sync(device)
    per = []
    for _ in range(repeats):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            chain()
            b.record()
            b.synchronize()
            per.append(a.elapsed_time(b) / n)
        else:
            t0 = time.perf_counter()
            chain()
            per.append((time.perf_counter() - t0) * 1e3 / n)
    return statistics.median(per)


def bench_once(args, refs: int, dtype: str | None = None,
               rtol_sq: float | None = None, lmax=None) -> dict:
    """One protocol measurement at ``refs`` refinements (``bench.py:43-134``):
    the wall of ``args.steps`` RK4 steps (median of ``args.repeats``, after
    one warm-up step), whether every stage's solve converged, the timed
    inner CG iterations (the last repeat's total) and max|y| at the end
    (the protocol's dt = T/10 is past RK4's stability limit, so the state
    grows: at refs 4 the last step's inner solves leave float32's range and
    stop unconverged), the inner CG iterations of the cold solve, the
    chained constrained-apply time, set-up seconds and peak memory.
    ``lmax``: the p-multigrid's smoother lambda_max per level (parity runs
    inject lpfem's)."""
    import torch

    from . import Problem, preset, resolve_device

    dev = resolve_device(args.device)
    dtype = dtype or args.dtype
    rtol_sq = rtol_sq if rtol_sq is not None else args.rtol_sq
    cfg = preset("scaling_base", order=args.order, ref_levels=refs,
                 nx=args.nx, ny=args.ny, nz=args.nz, precond=args.precond,
                 cheb_degree=args.cheb_degree,
                 dtype=dtype, cg_rtol_sq=rtol_sq, cg_max_iter=300)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    prob = Problem(cfg, dev, lmax=lmax)
    y0, phi0 = prob.initial_state()
    _sync(dev)
    setup_s = time.perf_counter() - t0
    n_dofs = prob.space.n_dofs
    ns = prob.surf.n_dofs

    prob.run(n_steps=1, state=(y0, phi0))          # warm-up (excluded)
    _sync(dev)
    walls = []
    unconverged = False
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        _, y, _ = prob.run(n_steps=args.steps, state=(y0, phi0))
        _sync(dev)
        walls.append(time.perf_counter() - t0)
        unconverged |= prob.last_solver_stats.unconverged
    timed_iters = prob.last_solver_stats.total_iters
    dt_wall = statistics.median(walls)
    n_solves = 4 * args.steps

    # the cold solve (zero warm start apart from the surface values) at the
    # protocol tolerance: for dtype=mixed the TOTAL inner float32 iterations
    # of the outer loop, the count ss.cpp reports
    _, info = prob.fso.solve_laplace(y0[ns:], phi0)

    ess = prob.ess
    apply_ms = chained_ms(lambda v: prob.op.constrained_apply(v, ess),
                          phi0.to(prob.op.dtype), dev)

    return dict(refs=refs, n_dofs=int(n_dofs), wall_s=dt_wall,
                value=n_dofs * n_solves / dt_wall, n_solves=n_solves,
                cg_iters=int(info.iters), cold_converged=bool(info.converged),
                unconverged_steps=unconverged, timed_inner_iters=timed_iters,
                max_abs_y=float(y.abs().max()), apply_ms=apply_ms,
                dtype=dtype, rtol_sq=rtol_sq,
                walls=[round(w, 4) for w in walls],
                setup_s=setup_s,
                peak_device_mem_bytes=(torch.cuda.max_memory_allocated(dev)
                                       if dev.type == "cuda" else None),
                peak_rss_bytes=resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss * 1024)


def _scales(args, dev_type: str) -> str:
    from .io import DataFile
    out = f"chiprun_out/bench-scales-{dev_type}.txt"
    if os.path.exists(out):
        os.remove(out)
    df = DataFile(out, "refs dofs dtype rtol_sq wall_s dof_solves_per_s "
                       "cg_iters apply_ms steps_converged timed_inner_iters "
                       "setup_s peak_device_mem_bytes")
    for refs in [int(s) for s in args.scales.split(",")]:
        r = bench_once(args, refs)
        df.append(r["refs"], r["n_dofs"], r["dtype"], r["rtol_sq"],
                  round(r["wall_s"], 4), round(r["value"], 1),
                  r["cg_iters"], round(r["apply_ms"], 4),
                  int(not r["unconverged_steps"]), r["timed_inner_iters"],
                  round(r["setup_s"], 3),
                  (r["peak_device_mem_bytes"]
                   if r["peak_device_mem_bytes"] is not None else float("nan")))
        mem = (f"{r['peak_device_mem_bytes'] / 2 ** 30:.3f} GiB device"
               if r["peak_device_mem_bytes"] is not None else "device n/a")
        print(f"refs={refs} dofs={r['n_dofs']} wall={r['wall_s']:.4f}s "
              f"walls={r['walls']} -> {r['value'] / 1e6:.2f}M dof*solves/s "
              f"iters={r['cg_iters']} converged={r['cold_converged']} "
              f"(steps: all converged {not r['unconverged_steps']}, "
              f"max|y| {r['max_abs_y']:.3e} at the end) "
              f"apply={r['apply_ms']:.4f}ms setup={r['setup_s']:.2f}s "
              f"peak {mem}, {r['peak_rss_bytes'] / 2 ** 30:.3f} GiB host",
              flush=True)
    return out


def main(argv=None) -> dict | str:
    """Run the benchmark; returns the JSON record (or the table's path with
    ``--scales``)."""
    from . import resolve_device

    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    name, power = card(dev)
    print(f"device: {name}, power limit {power}", flush=True)
    if args.scales:
        return _scales(args, dev.type)

    r = bench_once(args, args.refs)
    sec = None
    if not args.no_secondary:
        s = bench_once(args, args.refs, dtype="float32", rtol_sq=1e-8)
        sec = {"value": round(s["value"], 1), "wall_s": round(s["wall_s"], 4),
               "cg_iters": s["cg_iters"],
               "unconverged_steps": s["unconverged_steps"],
               "dtype": "float32",
               "rtol_sq": 1e-8,
               "note": "non-faithful softened protocol (rounds 1-3 headline)"}
    rec = {
        "metric": "laplace_dof_throughput",
        "value": round(r["value"], 1),
        "unit": "dof*solves/s",
        "detail": {
            "protocol": "ss.cpp faithful: SetRelTol(1e-8) -> r.z<=rz0*1e-16"
                        if (args.rtol_sq == 1e-16 and args.dtype == "mixed")
                        else f"dtype={args.dtype} rtol_sq={args.rtol_sq}",
            "n_dofs": r["n_dofs"], "order": args.order, "refs": args.refs,
            "steps": args.steps, "laplace_solves": r["n_solves"],
            "wall_s": round(r["wall_s"], 4), "dtype": r["dtype"],
            "rtol_sq": r["rtol_sq"],
            "precond": args.precond,
            "cg_iters": r["cg_iters"],
            "apply_ms": round(r["apply_ms"], 4),
            "walls": r["walls"],
            "unconverged_steps": r["unconverged_steps"],
            "timed_inner_iters": r["timed_inner_iters"],
            "secondary_f32": sec,
            "backend": dev.type,
            "device": name,
            "power_limit": power,
            "setup_s": round(r["setup_s"], 3),
            "peak_device_mem_bytes": r["peak_device_mem_bytes"],
            "peak_rss_bytes": r["peak_rss_bytes"],
        },
    }
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
