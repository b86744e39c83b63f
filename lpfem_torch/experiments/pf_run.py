"""Run any preset wave-tank simulation with output.

Counterpart of ``experiments/pf_run.py`` (the JAX package's driver): one
driver, preset-selected, with ParaView output every N steps
(``Solvers/PF_linear_par_partial.cpp:492-515``), progress every 10 steps
(``Solvers/PF_linear_par.cpp:481-484``), the wave-parameter banner
(``Solvers/PF_linear_serial.cpp:329-336``), and checkpoint / resume
(``lpfem_torch.io``), and eta streamed to a running GLVis server every N
steps (``--glvis-every``, ``Solvers/PF_linear_serial.cpp:438-487``; with no
server listening it warns once and runs on). ParaView output goes to
``chiprun_out/ParaView`` unless ``--paraview-dir`` says otherwise.

    python -m lpfem_torch.experiments.pf_run --preset pf_linear_periodic
    python -m lpfem_torch.experiments.pf_run --preset pf_linear_par_partial \\
        --paraview-every 10
    python -m lpfem_torch.experiments.pf_run --preset pf_linear_serial \\
        --resume ck.npz
"""

from __future__ import annotations

import argparse
import time

__all__ = ["main"]


def main(argv=None):
    """Run the preset; returns (t, y, phi) at the end."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="pf_linear_par_partial")
    ap.add_argument("--order", type=int, default=None)
    ap.add_argument("--nsteps", type=int, default=None)
    ap.add_argument("--precond", default=None)
    ap.add_argument("--from-rest", action="store_true",
                    help="zero ICs (relaxation zones build the wave)")
    ap.add_argument("--paraview-every", type=int, default=0)
    ap.add_argument("--paraview-dir", default="chiprun_out/ParaView")
    ap.add_argument("--glvis-every", type=int, default=0,
                    help="stream eta to a running GLVis server every N steps "
                         "(Solvers/PF_linear_serial.cpp:438-487)")
    ap.add_argument("--glvis-host", default="localhost")
    ap.add_argument("--glvis-port", type=int, default=19916)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..configs import preset
    from ..ds import DS, ds_to_f64
    from ..glvis import GLVisStream
    from ..io import (ParaViewCollection, load_checkpoint, save_checkpoint,
                      write_vtu, write_vtu_surface)
    from ..problem import Problem

    over = {}
    if args.order is not None:
        over["order"] = args.order
    if args.nsteps is not None:
        over["nsteps"] = args.nsteps
    if args.precond is not None:
        over["precond"] = args.precond
    cfg = preset(args.preset, **over)
    prob = Problem(cfg, args.device)
    w = prob.wave

    # wave banner (PF_linear_serial.cpp:329-336)
    print("Wave parameters:")
    for k, v in [("T", w.T), ("omega", w.omega), ("h", w.h), ("kh", w.kh),
                 ("k", w.k), ("lambda", w.wavelength), ("cwave", w.c),
                 ("H", w.H)]:
        print(f"  {k:7s}= {v:.6g}")
    # dispersion self-check (Convergence_and_Scaling/laplace_convergence.cpp:
    # 51-52): phase speed from dispersion minus omega/k should print ~0
    cs = np.sqrt(prob.cfg.g / w.k * np.tanh(w.kh))
    print(f"  dispersion check (cs - omega/k) = {cs - w.omega / w.k:.3e}")
    print(f"dofs: volume={prob.space.n_dofs} surface={prob.surf.n_dofs} "
          f"dt={prob.dt:.6g} nsteps={cfg.nsteps}")

    step0, t = 0, 0.0
    if args.resume:
        step0, t, y, phi, meta = load_checkpoint(args.resume)
        y = torch.as_tensor(y, device=prob.device)
        phi = torch.as_tensor(phi, device=prob.device)
        print(f"resumed from {args.resume} at step {step0}, t={t:.4f}")
    elif args.from_rest:
        y, phi = prob.zero_state()
    else:
        y, phi = prob.initial_state()

    pv_vol = pv_fs = None
    if args.paraview_every:
        pv_vol = ParaViewCollection(args.paraview_dir, cfg.name + "_vol")
        pv_fs = ParaViewCollection(args.paraview_dir, cfg.name + "_fs")
    glvis = (GLVisStream(args.glvis_host, args.glvis_port)
             if args.glvis_every else None)
    keys_sent = False

    ns = prob.surf.n_dofs
    t_wall0 = time.perf_counter()
    chunk = (args.paraview_every or args.glvis_every or args.checkpoint_every
             or cfg.nsteps)
    step = step0
    while step < cfg.nsteps:
        n = min(chunk, cfg.nsteps - step)
        t, y, phi = prob.run(n_steps=n, t0=t, state=(y, phi))
        t = float(t)
        step += n
        prob.check_state(y, phi)   # failure detection
        if step % 10 < n:
            print(f"Step {step} / {cfg.nsteps}, t = {t:.4f} "
                  f"[{time.perf_counter() - t_wall0:.1f}s]")
        if pv_vol is not None:
            phi_out = ds_to_f64(phi) if isinstance(phi, DS) else phi
            pv_vol.save(step, t, write_vtu, prob.space, {"phi": phi_out})
            pv_fs.save(step, t, write_vtu_surface, prob.surf,
                       {"eta": y[:ns], "phi_fs": y[ns:]})
        if glvis is not None and step % args.glvis_every < n:
            # the view keys ride this process's first send (a resumed run
            # starts past step 0)
            glvis.send(prob.surf, y[:ns], keys=None if keys_sent else "Rjlc")
            keys_sent = True
        if args.checkpoint and step % args.checkpoint_every < n:
            save_checkpoint(args.checkpoint, step=step, t=t, y=y, phi=phi,
                            config=cfg.name)

    eta = y[:ns].detach().cpu().numpy()
    print(f"done: t={t:.4f}  max|eta|={np.max(np.abs(eta)):.4e}  "
          f"wall={time.perf_counter() - t_wall0:.1f}s")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, step=step, t=t, y=y, phi=phi,
                        config=cfg.name)
    if glvis is not None:
        glvis.close()
    return t, y, phi


if __name__ == "__main__":
    main()
