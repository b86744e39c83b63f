"""Matplotlib post-processing, mirroring ``Convergence_and_Scaling/data/*.py``.

A copy of ``experiments/plots.py`` (the JAX package's) for the port's data
tables; it reads text tables only and imports matplotlib lazily, inside each
plot.

- convergence: loglog error vs DOFs with slope guides
  (``data/convergence_plot.py:21-40``)
- scaling: runtime, speedup S(p)=T1/Tp, efficiency gamma_s=T1/(p Tp)
  (``data/ss-plot.py:44-119``, ``data/speedup-plot.py:24-33``,
  ``data/ws-plot.py:30-79``)
- diffraction: polar overlay of numerical vs McCamy-Fuchs rim envelope with
  half-domain mirroring (``data/phase-plot.py:12-56``)

Usage:
  python -m lpfem_torch.experiments.plots convergence data/laplace-pconv-phi.txt
  python -m lpfem_torch.experiments.plots scaling data/strong-scaling.txt
  python -m lpfem_torch.experiments.plots diffraction \
      chiprun_out/cylinder-diffraction-torch.txt \
      chiprun_out/cylinder_boundary-torch.txt
"""

from __future__ import annotations

import argparse
import itertools
import os

import numpy as np


def plot_convergence(path: str, out: str | None = None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = np.loadtxt(path, ndmin=2)
    # columns: (order|ref) dofs err_inf [err_l2 ...]
    x, err = d[:, 1], d[:, 2]
    fig, ax = plt.subplots(figsize=(6, 4.5))
    ax.loglog(x, err, "o-", label="error")
    # slope guide from the last two points
    if len(x) > 2:
        s = np.log(err[-1] / err[-2]) / np.log(x[-1] / x[-2])
        ax.loglog(x, err[-1] * (x / x[-1]) ** s, "k--", lw=0.8,
                  label=f"slope {s:.2f}")
    ax.set_xlabel("DOFs")
    ax.set_ylabel(r"$\|e\|_\infty$")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    fig.tight_layout()
    out = out or path.replace(".txt", ".png")
    fig.savefig(out, dpi=150)
    print("wrote", out)


def plot_scaling(path: str, out: str | None = None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # columns: mode order par_ref shards dofs [precond] median_wall_s ...
    # (precond column added in round 3; handle both layouts)
    rows = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            has_precond = not tok[5].replace(".", "").replace("e", "") \
                .replace("-", "").replace("+", "").isdigit()
            wall_i = 6 if has_precond else 5
            rows.append((int(tok[1]), int(tok[2]), int(tok[3]),
                         float(tok[wall_i])))
    groups = sorted({(o, pr) for o, pr, _, _ in rows})
    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    for order, par_ref in groups:
        rs = np.array([(s, w) for o, pr, s, w in rows
                       if o == order and pr == par_ref])
        idx = np.argsort(rs[:, 0])
        shards, wall = rs[idx, 0], rs[idx, 1]
        t1 = wall[shards == 1][0] if np.any(shards == 1) else wall[0]
        lbl = f"p={order}, ref={par_ref}"
        axes[0].plot(shards, wall, "o-", label=lbl)
        axes[1].plot(shards, t1 / wall, "o-", label=lbl)
        axes[2].plot(shards, t1 / (shards * wall), "o-", label=lbl)
    axes[1].plot(shards, shards, "k--", lw=0.8, label="ideal")
    for ax, title in zip(axes, ["runtime [s]", "speedup $T_1/T_p$",
                                r"efficiency $\gamma_s$"]):
        ax.set_xlabel("shards")
        ax.set_title(title)
        ax.grid(True, alpha=0.3)
        ax.legend()
    fig.tight_layout()
    out = out or path.replace(".txt", ".png")
    fig.savefig(out, dpi=150)
    print("wrote", out)


def plot_diffraction(num_paths, exact_path: str, out: str | None = None):
    """Polar overlay of one or more numerical rim envelopes vs the analytic
    series (``num_paths`` may be a single path or a list — e.g. the
    reference-mesh parity run next to the improved polar-mesh run)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(num_paths, str):
        num_paths = [num_paths]
    ex = np.loadtxt(exact_path, ndmin=2)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="polar")
    # mirror the half-domain (phase-plot.py:12-56)
    markers = itertools.cycle(["b.", "g+", "mx", "c1"])
    for path, mk in zip(num_paths, markers):
        num = np.loadtxt(path, ndmin=2)       # theta eta_norm
        th = np.concatenate([num[:, 0], 2 * np.pi - num[::-1, 0]])
        r = np.concatenate([num[:, 1], num[::-1, 1]])
        label = os.path.splitext(os.path.basename(path))[0]
        ax.plot(th, r, mk, ms=4, label=label)
    th_e = np.concatenate([ex[:, 0], 2 * np.pi - ex[::-1, 0]])
    r_e = np.concatenate([ex[:, 1], ex[::-1, 1]])
    ax.plot(th_e, r_e, "r-", lw=1, label="McCamy-Fuchs")
    ax.legend(loc="lower left", fontsize=8)
    fig.tight_layout()
    out = out or num_paths[0].replace(".txt", ".png")
    fig.savefig(out, dpi=150)
    print("wrote", out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=["convergence", "scaling", "diffraction"])
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.kind == "convergence":
        plot_convergence(args.paths[0], args.out)
    elif args.kind == "scaling":
        plot_scaling(args.paths[0], args.out)
    else:
        # last positional path is the analytic series; at least one
        # numerical series must precede it
        if len(args.paths) < 2:
            ap.error("kind=diffraction needs >=2 paths: "
                     "<numerical.txt>... <exact.txt>")
        plot_diffraction(args.paths[:-1], args.paths[-1], args.out)


if __name__ == "__main__":
    main()
