"""Stationary Laplace convergence studies.

Counterpart of ``experiments/laplace_conv.py`` (the JAX package's driver):

- h-convergence: order 4, refinements 0..N, ``||phi - phi_ex||_inf`` + L2 vs
  dofs (``Convergence_and_Scaling/laplace-parallel-hconv.cpp:28-228``);
- p-convergence: p = 1..10 on a fixed mesh
  (``Convergence_and_Scaling/laplace-parallel-pconv.cpp:21-219``).

Problem: project the analytic Airy potential on the free surface (attr 2),
solve the zero-Neumann Laplace problem, compare to the exact volume
potential (``Solvers/laplace_solver.cpp`` validation). The x-periodic box
tank runs on the Kronecker operator (kernel B1) at every order, the
p-multigrid levels too.

Tables go to ``chiprun_out/`` (``--out`` to choose), never ``data/``, which
holds the JAX package's results to compare with.

    python -m lpfem_torch.experiments.laplace_conv --mode p --max-order 10
    python -m lpfem_torch.experiments.laplace_conv --mode h --order 4 --refs 3
"""

from __future__ import annotations

import argparse
import time

import numpy as np

__all__ = ["run_case", "main"]


def run_case(mesh, order, wave, rtol_sq, max_iter, precond="pmg",
             dtype="float64", max_outer=8, inner_precision="highest",
             device="cuda", lmax=None):
    """One stationary solve (``experiments/laplace_conv.py:26-86``).
    ``dtype``:
    - float64: everything double (the MFEM configuration)
    - float32: everything single
    - mixed:   float32 operator + preconditioner, float64 outer residuals
               (:func:`~lpfem_torch.solvers.pcg_refined`)

    ``inner_precision`` is lpfem's TPU matrix-unit knob; the port keeps
    full-float32 products everywhere (TF32 off), which is its "highest", the
    only value accepted. ``lmax``: the p-multigrid's per-level smoother
    lambda_max (parity runs inject lpfem's)."""
    import torch

    from .. import resolve_device
    from ..multigrid import PMultigrid
    from ..operators import laplace_operator
    from ..profiling import block_until_ready
    from ..solvers import pcg, pcg_refined
    from ..space import H1Space, SurfaceSpace

    if inner_precision != "highest":
        raise ValueError("inner_precision: the port keeps exact float32 "
                         "products (TF32 off), lpfem's 'highest'; the other "
                         "values select the TPU's reduced-precision matrix "
                         "unit passes")
    dev = resolve_device(device)
    sp = H1Space(mesh, order)
    jt = torch.float32 if dtype == "float32" else torch.float64
    op = laplace_operator(sp, torch.float32 if dtype == "mixed" else jt, dev)
    surf = SurfaceSpace(sp, attr=2)
    ess = torch.as_tensor(surf.surf_to_vol, device=dev)
    phi_fs = torch.tensor(surf.project(lambda x, y, z: wave.phi(x, y, z)),
                          dtype=jt, device=dev)

    if precond == "pmg" and order > 1:
        pre = PMultigrid(op, lmax=lmax)
    else:
        diag = op.diag()
        diag[ess] = 1.0
        inv_diag = 1.0 / diag
        pre = lambda r: r * inv_diag    # noqa: E731

    op64 = None
    if dtype == "mixed":
        op64 = laplace_operator(sp, torch.float64, dev)
        B, x0 = op64.constrained_rhs(torch.zeros(sp.n_dofs, dtype=jt,
                                                 device=dev), phi_fs, ess)
        t0 = time.perf_counter()
        res = pcg_refined(lambda v: op64.constrained_apply(v, ess),
                          lambda v: op.constrained_apply(v, ess), B, x0,
                          precond_lo=pre, rtol_sq=rtol_sq,
                          inner_max_iter=max_iter, max_outer=max_outer)
    else:
        B, x0 = op.constrained_rhs(torch.zeros(sp.n_dofs, dtype=jt,
                                               device=dev), phi_fs, ess)
        t0 = time.perf_counter()
        res = pcg(lambda v: op.constrained_apply(v, ess), B, x0,
                  precond_fn=pre, rtol_sq=rtol_sq, max_iter=max_iter)
    block_until_ready(res.x)
    wall = time.perf_counter() - t0

    phi_ex = sp.project(lambda x, y, z: wave.phi(x, y, z))
    x = res.x.detach().cpu().numpy()
    err_inf = float(np.max(np.abs(x - phi_ex)))
    l2op = op if dtype != "mixed" else op64
    err_l2 = float(l2op.l2_error(res.x.to(l2op.dtype),
                                 lambda x, y, z: wave.phi(x, y, z)))
    return dict(dofs=sp.n_dofs, iters=int(res.iters), err_inf=err_inf,
                err_l2=err_l2, wall=wall)


def main(argv=None) -> str:
    """Run the study; returns the table's path."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["h", "p"], default="p")
    ap.add_argument("--order", type=int, default=4, help="order for h-mode")
    ap.add_argument("--refs", type=int, default=3, help="max refinements (h-mode)")
    ap.add_argument("--max-order", type=int, default=10, help="p-mode sweep top")
    ap.add_argument("--nx", type=int, default=8)
    ap.add_argument("--nz", type=int, default=2)
    ap.add_argument("--modes", type=float, default=2.0)
    ap.add_argument("--rtol-sq", type=float, default=1e-24)
    ap.add_argument("--max-iter", type=int, default=2000)
    ap.add_argument("--precond", default="pmg")
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32", "mixed"])
    ap.add_argument("--max-outer", type=int, default=8,
                    help="mixed: refinement passes (each gains the inner "
                         "solve's digits; high p needs more)")
    ap.add_argument("--inner-precision", default="highest",
                    choices=["highest"],
                    help="lpfem's TPU matrix-unit precision of the float32 "
                         "inner operator; the port's products are exact "
                         "float32 (TF32 off), so only 'highest'")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..analytic import AiryWave
    from ..io import DataFile
    from ..mesh import make_wave_tank

    base = make_wave_tank(args.nx, 1, args.nz)
    bbmin, bbmax = base.bounding_box()
    wave = AiryWave.from_modes(H=0.005, m=args.modes, Lx=1.0,
                               h=bbmax[2] - bbmin[2], z_top=bbmax[2])

    def case(mesh, p):
        return run_case(mesh, p, wave, args.rtol_sq, args.max_iter,
                        args.precond, dtype=args.dtype,
                        max_outer=args.max_outer,
                        inner_precision=args.inner_precision,
                        device=args.device)

    if args.mode == "p":
        out = args.out or "chiprun_out/laplace-pconv-phi.txt"
        df = DataFile(out, "order dofs err_inf err_l2 iters wall_s")
        for p in range(1, args.max_order + 1):
            r = case(base, p)
            df.append(p, r["dofs"], r["err_inf"], r["err_l2"], r["iters"], r["wall"])
            print(f"p={p:2d} dofs={r['dofs']:8d} err_inf={r['err_inf']:.3e} "
                  f"err_l2={r['err_l2']:.3e} iters={r['iters']} wall={r['wall']:.2f}s")
    else:
        out = args.out or "chiprun_out/laplace-hconv-phi.txt"
        df = DataFile(out, "ref order dofs err_inf err_l2 iters wall_s")
        mesh = base
        for ref in range(args.refs + 1):
            r = case(mesh, args.order)
            df.append(ref, args.order, r["dofs"], r["err_inf"], r["err_l2"],
                      r["iters"], r["wall"])
            print(f"ref={ref} dofs={r['dofs']:8d} err_inf={r['err_inf']:.3e} "
                  f"err_l2={r['err_l2']:.3e} iters={r['iters']} wall={r['wall']:.2f}s")
            if ref < args.refs:
                mesh = mesh.uniform_refine()
    return out


if __name__ == "__main__":
    main()
