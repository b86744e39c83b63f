"""The comparison that decides ``correct``.

After the window, with the program's state freed, the plain reference
(``reference/``) is built from the cell's parameters and judges the
window's sampled answers:

- ``dofs``: the program's volume has as many dofs as the reference's;
- ``layout``: every surface node and every volume dof the program reports
  (all of them, or a seeded sample of a million on a larger space) lies on
  a node of the reference's numbering, one to one on the surface; the
  value is the largest distance, against a billionth of the tank's size;
- ``unconverged``: the window's Laplace solves that stopped short of the
  configuration's tolerance, against 0;
- ``nonfinite``: trajectories the program's own guard stopped on a
  non-finite state, against 0;
- ``y_gap.early`` and ``y_gap.late``: for each sampled step, the reference
  takes the program's input state ``[eta; phi_fs]`` and makes one RK4 step
  of its own (four exact Laplace solves, the top trace, the surface
  equations); the value is the largest
  ``max|y_program - y_reference| / max|y_reference|`` over the sampled
  steps among a trajectory's first ``early_steps`` (whose solves start far
  from their answers, so the tolerance leaves the widest gap) and over the
  others (warm-started: the gap falls to round-off, and a precision lost
  there shows against a limit of its own). It covers the RK4 update, the
  right-hand side, the solve at the configuration's tolerance and the
  trace dphi/dz;
- ``phi_gap.early`` and ``phi_gap.late``: the same for the potential of the
  step's last stage, which the program returns with its state: the Laplace
  solve itself.

A group with no sampled step (a window shorter than a trajectory's early
steps) reads 0: no answer of it was due.

The reference follows the program step by step from the program's own
states (RK4 at the configurations' dt amplifies round-off by orders of
magnitude a step, so two valid trajectories part after a few steps); the
start of each trajectory is the benchmark's own seeded state, and a
sampled step at a trajectory's start is checked from it.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from . import reference

__all__ = ["check"]


def _gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    a = a.to(ref.device, torch.float64)
    den = float(ref.abs().max())
    return float((a - ref).abs().max()) / den if den > 0 else math.inf


def check(cell, params: dict, layout: dict, samples: list, ctx: dict,
          device, log=print, detail: list | None = None) -> tuple[dict, bool]:
    """(checks, correct): each number compared with its limit, ``checks``
    ordered as listed above; ``detail`` collects each sample's gaps."""
    t0 = time.perf_counter()
    ref = reference.make(cell.config, params, device)
    n = layout["n_dofs"]
    checks = {"dofs": {"value": abs(n - ref.n_dofs), "limit": 0}}

    s_idx, s_dist = ref.surface_index(layout["surf_xy"])
    v_idx, v_dist = ref.volume_index(layout["vol_xyz"])
    one_to_one = (len(s_idx) == ref.n_surf
                  and len(np.unique(s_idx)) == ref.n_surf)
    full = len(layout["vol_idx"]) == n
    if not full and not np.array_equal(v_idx, layout["vol_idx"]):
        one_to_one = False          # a sample must show the same numbering
    if full and len(np.unique(v_idx)) != n:
        one_to_one = False
    checks["layout"] = {"value": max(s_dist, v_dist) if one_to_one
                        else math.inf, "limit": 1e-9 * ref.size}
    checks["unconverged"] = {"value": int(ctx["failed"]), "limit": 0}
    checks["nonfinite"] = {"value": int(ctx.get("diverged", False)),
                           "limit": 0}

    groups = ("early", "late")
    gaps = {(g, q): math.inf for g in groups for q in ("y_gap", "phi_gap")}
    if checks["dofs"]["value"] == 0 and one_to_one:
        ns = ref.n_surf
        s_t = torch.as_tensor(s_idx, device=ref.device)
        perm = torch.as_tensor(v_idx, device=ref.device) if full else None
        gaps = dict.fromkeys(gaps, 0.0)
        for s in samples:
            y_in = s.y_in.to(ref.device, torch.float64)
            y_ref = torch.empty_like(y_in)
            y_ref[s_t] = y_in[:ns]
            y_ref[ns + s_t] = y_in[ns:]
            yr, phir = ref.step(s.t, y_ref)
            yr = torch.cat([yr[s_t], yr[ns + s_t]])
            gy = _gap(s.y_out, yr)
            gp = _gap(s.phi_out, phir if perm is None else phir[perm])
            g = "early" if s.j < cell.early_steps else "late"
            gaps[g, "y_gap"] = max(gaps[g, "y_gap"], gy)
            gaps[g, "phi_gap"] = max(gaps[g, "phi_gap"], gp)
            if detail is not None:
                detail.append({"step": s.step, "j": s.j, "t": s.t,
                               "y_gap": gy, "phi_gap": gp,
                               "max_y": float(yr.abs().max())})
    lim = cell.limits
    for q in ("y_gap", "phi_gap"):
        for g in groups:
            name = f"{q}.{g}"
            checks[name] = {"value": gaps[g, q], "limit": lim.get(name)}
    correct = bool(samples) and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    log(f"reference check of {len(samples)} sampled steps "
        f"{time.perf_counter() - t0:.3f} s")
    return checks, correct
