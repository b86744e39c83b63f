"""Wave-cylinder diffraction study + McCamy-Fuchs validation, on the GPU.

The port of ``experiments/diffraction.py`` (the reference's
``Solvers/cylinder-diffraction.cpp`` and ``cylinder-exact.cpp``) at its
defaults:

- the polar half-cylinder tank of :mod:`lpfem_torch.cylmesh` (``n_theta=96``,
  ``dr_max=0.25``, grading 1.4, ``nz=1``, exact order-4 geometry): 4,224
  curved hexes, 340,725 dofs at order 4;
- order 4, lambda = 1, kh = 1, H = 0.01; RK4 525 steps over 15 T (the
  reference's dt, 35 steps per period); float64, r.z <= rz0 * 1e-24, maxit
  600, p-multigrid with Chebyshev degree 3 (``--dtype mixed``: float32
  inner CG, r.z <= rz0 * 1e-10 with the absolute floor 1e-20);
- three relaxation zones: generation 2.5 lambda, x-absorption 4 lambda,
  lateral y-absorption 3 lambda relaxing toward the incident wave
  (``--lateral zero`` damps toward zero, as the reference does);
- the eta envelope (max over the last period, times 2/H) on the rim nodes
  (``extract_rim``), written with the analytic McCamy-Fuchs envelope, and
  the deviation from both it and the JAX result ``data/cylinder-diffraction.
  txt`` (interpolated in theta).

``--gmsh file`` runs on an imported Gmsh v2.2 mesh instead (the
reference's ``Meshes/mesh_cylinder_half.msh``,
``cylinder-diffraction.cpp:225``): order-``--order`` geometry by
``SetCurvature`` with the rim (boundary attribute 3) snapped onto the
cylinder at (``--cx``, ``--cy``) (``:259-264``); the topological numbering
and B3b carry it. ``--apply-mode`` picks the operator's apply mode
(``pallas`` | ``fused`` | ``sumfact``). The ParaView snapshot of the
envelope and the final eta goes to ``ParaView/cylinder_envelope.vtu``
beside ``--out`` (``cylinder-diffraction.cpp:729-743``).

``--shard n`` runs the time loop through :class:`~lpfem_torch.shard.
ShardedProblem` over n shards (the reference runs this study under MPI):
on this tank (one element layer) the partition is compact x-slabs by
element centroid, and each shard's curved elements go through B3b.

Not ported: ``--chunk`` (a TPU watchdog workaround).

Usage (from the root of a checkout, on a machine with a CUDA GPU):
  python -m lpfem_torch.experiments.diffraction
  python -m lpfem_torch.experiments.diffraction --dtype mixed
  python -m lpfem_torch.experiments.diffraction --quick --device cpu
  python -m lpfem_torch.experiments.diffraction --quick --shard 4 --device cpu
  python -m lpfem_torch.experiments.diffraction --gmsh tank.msh --cy 0
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..analytic import mccamy_fuchs_envelope
from ..configs import Config
from ..cylmesh import make_half_cylinder_tank
from ..io import write_vtu_surface
from ..mesh import cylinder_projector, load_gmsh, set_curvature
from ..problem import Problem
from ..surface import RelaxationZones, cabs_weight, cgen_weight

__all__ = ["extract_rim", "study_mesh", "gmsh_mesh", "build_problem",
           "envelope", "compare_envelopes"]


def extract_rim(X, cx, cy, radius, tol, values):
    """Rim trace (theta, value) from surface node coords + nodal field.

    Keeps nodes with ``|r - radius| <= tol`` and ``theta >= 0``, sorted by
    theta with duplicate angles removed — the reference's extraction loop
    (``cylinder-diffraction.cpp:479-498,563-591``) minus its loose 5e-3
    band: with an exact-rim mesh (polar ring / curvature-snapped Gmsh) a
    tight ``tol`` keeps ONLY the r=a ring, excluding first-interior GLL
    nodes (~1.1e-3 off the rim at p=4) whose smaller envelope values show
    up as paired-point spikes in eta(theta).
    """
    X = np.asarray(X)
    r = np.hypot(X[:, 0] - cx, X[:, 1] - cy)
    theta = np.arctan2(X[:, 1] - cy, X[:, 0] - cx)
    keep = (np.abs(r - radius) <= tol) & (theta >= 0)
    th, vals = theta[keep], np.asarray(values)[keep]
    order_i = np.argsort(th)
    th, vals = th[order_i], vals[order_i]
    uniq = np.concatenate([[True], np.diff(th) > 1e-10])
    return th[uniq], vals[uniq]


def study_mesh(*, order: int = 4, n_theta: int = 96, n_r: int = 16,
               dr_max: float = 0.25, nz: int = 1, Lx: float = 12.0,
               Ly: float = 6.0, cx: float = 4.0, radius: float = 0.5):
    """The study's tank (default: 4,224 curved hexes, exact order-4
    geometry; ``experiments/diffraction.py:156-161``)."""
    return make_half_cylinder_tank(Lx=Lx, Ly=Ly, h=1.0 / (2.0 * np.pi),
                                   cx=cx, a=radius, n_theta=n_theta, n_r=n_r,
                                   nz=nz, geom_order=order,
                                   grading=1.4 if dr_max else 1.25,
                                   dr_max=dr_max or None)


def gmsh_mesh(path: str, *, order: int = 4, cx: float = 4.0,
              cy: float = 0.0, radius: float = 0.5):
    """An imported Gmsh tank with order-``order`` geometry, its rim
    (attribute 3) snapped onto the cylinder (``experiments/diffraction.py:
    148-154``)."""
    mesh = load_gmsh(path)
    set_curvature(mesh, order, {3: cylinder_projector(cx, cy, radius)})
    return mesh


def build_problem(device, *, order: int = 4, nsteps: int = 525,
                  periods: float = 15.0, n_theta: int = 96, n_r: int = 16,
                  dr_max: float = 0.25, nz: int = 1, Lx: float = 12.0,
                  Ly: float = 6.0, cx: float = 4.0, radius: float = 0.5,
                  H: float = 0.01, precond: str = "pmg",
                  cheb_degree: int = 3, lateral: str = "incident",
                  dtype: str = "float64", rtol_sq: float | None = None,
                  apply_mode: str = "pallas", lmax=None,
                  mesh=None) -> Problem:
    """The study's :class:`Problem` with its three relaxation zones
    (``experiments/diffraction.py:147-189``). ``mesh``: the tank, built
    once by :func:`study_mesh` with the same arguments or imported by
    :func:`gmsh_mesh` (reused, not changed)."""
    if mesh is None:
        mesh = study_mesh(order=order, n_theta=n_theta, n_r=n_r,
                          dr_max=dr_max, nz=nz, Lx=Lx, Ly=Ly, cx=cx,
                          radius=radius)
    if rtol_sq is None:
        rtol_sq = 1e-24 if dtype == "float64" else 1e-10
    # absolute residual floor for the float32 inner solves: the envelope
    # needs ||r|| ~ 1e-8 of the O(1e-2) boundary data
    atol_sq = 0.0 if dtype == "float64" else 1e-20
    cfg = Config(name="cylinder_diffraction", order=order, H=H,
                 wave_by="wavelength", wave_lambda=1.0, kh_override=1.0,
                 nsteps=nsteps, t_final_periods=periods,
                 cg_rtol_sq=rtol_sq, cg_atol_sq=atol_sq, cg_max_iter=600,
                 dtype=dtype, apply_mode=apply_mode, precond=precond,
                 cheb_degree=cheb_degree)
    prob = Problem(cfg, device=device, mesh=mesh, lmax=lmax)
    lam = prob.wave.wavelength
    bbmin, bbmax = mesh.bounding_box()
    X = prob.surf.node_coords
    cgen = cgen_weight(X[:, 0], float(bbmin[0]), float(bbmin[0]) + 2.5 * lam)
    cabs = cabs_weight(X[:, 0], float(bbmax[0]) - 4.0 * lam, float(bbmax[0]))
    cabsy = cabs_weight(X[:, 1], float(bbmax[1]) - 3.0 * lam, float(bbmax[1]))
    if lateral == "incident":
        # open-sea lateral boundary: relax toward the incident wave, so only
        # the scattered field is absorbed
        gen_w, abs_w = cgen + cabsy, cabs
    elif lateral == "zero":
        gen_w, abs_w = cgen, cabs + cabsy
    else:
        raise ValueError(f"unknown lateral target {lateral!r}")
    prob.relax = RelaxationZones.build(prob.surf, prob.wave, tau=prob.dt,
                                       cgen=gen_w, cabs=abs_w, n_ramp=3.0,
                                       dtype=prob.dtype, device=prob.device)
    prob.fso.relax = prob.relax
    return prob


def envelope(prob: Problem, ts, etas, t_end: float) -> np.ndarray:
    """The nodal max of eta over the last period times 2/H at every
    surface dof (``cylinder-diffraction.cpp:415-429``)."""
    sel = np.asarray(ts) >= t_end - prob.wave.T - 1e-12
    return np.max(np.asarray(etas)[sel], axis=0) * (2.0 / prob.cfg.H)



def compare_envelopes(th, vals, ka: float, jax_table=None) -> dict:
    """Deviation of a rim envelope from the McCamy-Fuchs series (tabulated
    at 181 angles and interpolated, as ``experiments/diffraction.py:255-272``
    does) and, given ``jax_table [n, 2]`` (the JAX package's rim file),
    from it interpolated in theta, with that file's own deviation from the
    series beside it."""
    th_e = np.linspace(0, np.pi, 181)
    env_e = mccamy_fuchs_envelope(th_e, ka)

    def mf_dev(t, v):
        ref = np.interp(t, th_e, env_e)
        return np.abs(v - ref) / np.abs(ref), np.abs(v - ref) / np.max(
            np.abs(ref))

    rel_pw, rel_nm = mf_dev(th, vals)
    out = dict(mf_mean_rel_dev=float(np.mean(rel_pw)),
               mf_max_rel_dev=float(np.max(rel_pw)),
               mf_max_at_theta=float(th[np.argmax(rel_pw)]),
               mf_mean_norm_dev=float(np.mean(rel_nm)),
               mf_max_norm_dev=float(np.max(rel_nm)))
    if jax_table is not None:
        jx = np.asarray(jax_table)
        diff = np.abs(vals - np.interp(th, jx[:, 0], jx[:, 1]))
        i = int(np.argmax(diff))
        out.update(jax_max_abs_diff=float(diff[i]),
                   jax_mean_abs_diff=float(np.mean(diff)),
                   jax_max_at_theta=float(th[i]), port_there=float(vals[i]),
                   jax_there=float(np.interp(th[i], jx[:, 0], jx[:, 1])),
                   mf_there=float(np.interp(th[i], th_e, env_e)),
                   jax_file_mf_mean_rel_dev=float(np.mean(
                       mf_dev(jx[:, 0], jx[:, 1])[0])))
    return out


def _write_table(path: str, header: str, rows) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("# " + header + "\n")
        for a, v in rows:
            f.write(f"{float(a):.16g} {float(v):.16g}\n")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--nsteps", type=int, default=525)
    ap.add_argument("--periods", type=float, default=15.0)
    ap.add_argument("--n-theta", type=int, default=96)
    ap.add_argument("--n-r", type=int, default=16,
                    help="radial layers (ignored when --dr-max is set)")
    ap.add_argument("--dr-max", type=float, default=0.25,
                    help="cap on radial layer width in wavelengths; 0 "
                         "disables (pure geometric grading)")
    ap.add_argument("--nz", type=int, default=1)
    ap.add_argument("--gmsh", default=None,
                    help="load a Gmsh v2.2 mesh instead")
    ap.add_argument("--Lx", type=float, default=12.0)
    ap.add_argument("--Ly", type=float, default=6.0)
    ap.add_argument("--cx", type=float, default=4.0)
    ap.add_argument("--cy", type=float, default=0.0,
                    help="cylinder centre y (4.0 for the reference's half "
                         "mesh)")
    ap.add_argument("--radius", type=float, default=0.5)
    ap.add_argument("--H", type=float, default=0.01)
    ap.add_argument("--precond", default="pmg")
    ap.add_argument("--apply-mode", default="pallas",
                    choices=["pallas", "fused", "sumfact"])
    ap.add_argument("--cheb-degree", type=int, default=3)
    ap.add_argument("--rim-tol", type=float, default=1e-9,
                    help="|r-a| tolerance of the rim-node extraction")
    ap.add_argument("--lateral", choices=["incident", "zero"],
                    default="incident")
    ap.add_argument("--quick", action="store_true",
                    help="small smoke setup (order 2, 12x6 polar cells, 3 T)")
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32", "mixed"])
    ap.add_argument("--rtol-sq", type=float, default=None,
                    help="CG tolerance on r.z; default 1e-24 (float64) / "
                         "1e-10 (float32, mixed)")
    ap.add_argument("--shard", type=int, default=0,
                    help="run the time loop through the sharded runner over "
                         "n shards (0: the single-device Problem)")
    ap.add_argument("--out", default="chiprun_out/cylinder-diffraction-torch.txt")
    ap.add_argument("--out-exact",
                    default="chiprun_out/cylinder_boundary-torch.txt")
    ap.add_argument("--compare", default="data/cylinder-diffraction.txt",
                    help="the JAX package's rim envelope to compare with "
                         "(read only; '' skips)")
    args = ap.parse_args(argv)
    if args.quick:
        args.order = 2 if args.order == 4 else args.order
        args.nsteps = 60 if args.nsteps == 525 else args.nsteps
        args.periods = 3.0 if args.periods == 15.0 else args.periods
        args.n_theta, args.n_r, args.dr_max = 12, 6, 0.0

    from ..kernels import pa_apply
    device = torch.device(args.device)
    card = "cpu"
    if device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=60,
                              check=True).stdout.strip()
        print(card)
    t_setup = time.perf_counter()
    mesh = (gmsh_mesh(args.gmsh, order=args.order, cx=args.cx, cy=args.cy,
                      radius=args.radius) if args.gmsh else None)
    prob = build_problem(device, order=args.order, nsteps=args.nsteps,
                         periods=args.periods, n_theta=args.n_theta,
                         n_r=args.n_r, dr_max=args.dr_max, nz=args.nz,
                         Lx=args.Lx, Ly=args.Ly, cx=args.cx,
                         radius=args.radius, H=args.H, precond=args.precond,
                         cheb_degree=args.cheb_degree, lateral=args.lateral,
                         dtype=args.dtype, rtol_sq=args.rtol_sq,
                         apply_mode=args.apply_mode, mesh=mesh)
    runner = prob
    if args.shard:
        from ..shard import ShardedProblem
        runner = ShardedProblem(prob, args.shard)
    setup_s = time.perf_counter() - t_setup
    wave, ns = prob.wave, prob.surf.n_dofs
    print(f"mesh: {prob.space.mesh.n_elems} hexes; dofs vol="
          f"{prob.space.n_dofs} surf={ns}; T={wave.T:.4f} dt={prob.dt:.4f}; "
          f"setup {setup_s:.1f} s on {device}")

    ts, etas = [], []
    t0_wall = time.perf_counter()
    every = max(1, args.nsteps // 20)

    def record(t, y, aux):
        ts.append(t)
        etas.append(y[:ns].clone())
        if len(ts) % every == 0 or len(ts) == args.nsteps:
            print(f"step {len(ts)}/{args.nsteps} t={t:.3f} max|eta|="
                  f"{float(y[:ns].abs().max()):.4f} "
                  f"[{time.perf_counter() - t0_wall:.0f}s]", flush=True)

    launches0 = pa_apply.LAUNCHES
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t, y, phi = runner.run(n_steps=args.nsteps, record=record)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0_wall
    runner.check_state(y, phi)
    stats = runner.last_solver_stats
    print(f"run: {wall:.1f}s t_final={t:.3f}; {stats.n_solves} solves, "
          f"{stats.total_iters} inner CG iterations (max {stats.max_iters}), "
          f"{stats.syncs} host syncs, {pa_apply.LAUNCHES - launches0} "
          f"pa_apply_element launches, unconverged={stats.unconverged}")

    etas_np = torch.stack(etas).cpu().numpy()
    env = envelope(prob, ts, etas_np, t)
    th, vals = extract_rim(prob.surf.node_coords, args.cx, args.cy,
                           args.radius, args.rim_tol, env)
    _write_table(args.out, "theta(rad) eta", zip(th, vals))
    print(f"extracted {len(th)} rim points -> {args.out}")
    # the ParaView snapshot (cylinder-diffraction.cpp:729-743), beside --out
    pv_dir = os.path.join(os.path.dirname(args.out) or ".", "ParaView")
    os.makedirs(pv_dir, exist_ok=True)
    vtu = os.path.join(pv_dir, "cylinder_envelope.vtu")
    write_vtu_surface(vtu, prob.surf, {"eta_env": env, "eta_final": y[:ns]})
    print(f"wrote {vtu}")

    ka = wave.k * args.radius
    th_e = np.linspace(0, np.pi, 181)
    _write_table(args.out_exact, "theta(rad)  eta",
                 zip(th_e, mccamy_fuchs_envelope(th_e, ka)))
    jax_table = (np.loadtxt(args.compare, ndmin=2)
                 if args.compare and os.path.exists(args.compare) else None)
    cmp = compare_envelopes(th, vals, ka, jax_table)
    print(f"rim envelope vs McCamy-Fuchs: pointwise rel dev "
          f"mean {cmp['mf_mean_rel_dev']:.4f} / max "
          f"{cmp['mf_max_rel_dev']:.4f}; normalized-by-max mean "
          f"{cmp['mf_mean_norm_dev']:.4f} / max {cmp['mf_max_norm_dev']:.4f}")
    if jax_table is not None:
        print(f"rim envelope vs {args.compare} (theta-interpolated): max abs "
              f"diff {cmp['jax_max_abs_diff']:.4f} at theta "
              f"{cmp['jax_max_at_theta']:.4f}, mean "
              f"{cmp['jax_mean_abs_diff']:.4f}; that file vs McCamy-Fuchs: "
              f"mean {cmp['jax_file_mf_mean_rel_dev']:.4f}")
    result = dict(
        device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu"), nvidia_smi=card,
        dtype=args.dtype, shards=args.shard, gmsh=args.gmsh,
        apply_mode=args.apply_mode, envelope_vtu=vtu,
        dofs=prob.space.n_dofs,
        surface_dofs=ns,
        hexes=prob.space.mesh.n_elems, steps=len(ts), t_final=t,
        max_abs_eta=float(y[:ns].abs().max()),
        setup_s=setup_s, wall_s=wall, n_solves=stats.n_solves,
        total_inner_iters=stats.total_iters, max_iters=stats.max_iters,
        syncs=stats.syncs, unconverged=stats.unconverged,
        pa_apply_launches=pa_apply.LAUNCHES - launches0,
        peak_mem_bytes=(torch.cuda.max_memory_allocated(device)
                        if device.type == "cuda" else None),
        rim_points=len(th), **cmp)
    summary = os.path.splitext(args.out)[0] + ".json"
    with open(summary, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
