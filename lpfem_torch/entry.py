"""Entry point: one RK4 step of the flagship model on the card.

Counterpart of ``__graft_entry__.entry`` (``__graft_entry__.py:14-33``):
``entry()`` returns ``(fn, example_args)`` for one RK4 step of
``preset("pf_linear_par_partial", nx=12, order=2, nsteps=4,
cg_max_iter=200)`` (finite wave tank, relaxation zones, Jacobi-CG).
``fn(t, y, phi)`` returns ``(y, phi)`` after the step.

``dryrun_multichip(n_shards)`` is the twin of
``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:66-141``): one
sharded RK4 step over ``n_shards`` shards stacked on one device, against
the single-device step.
"""

from __future__ import annotations

__all__ = ["small_config", "entry", "dryrun_multichip"]


def small_config():
    """The flagship configuration at entry size
    (``__graft_entry__._small_cfg``)."""
    from .configs import preset
    return preset("pf_linear_par_partial", nx=12, order=2, nsteps=4,
                  cg_max_iter=200)


def entry(device="cuda"):
    """(fn, example_args): one RK4 step of the flagship model on ``device``
    and its arguments ``(t, y0, phi0)``."""
    import torch

    from .problem import Problem

    prob = Problem(small_config(), device)
    y0, phi0 = prob.initial_state()
    step = prob.step_fn()

    def fn(t, y, phi):
        return step(t, y, phi)

    return fn, (torch.tensor(0.0, dtype=prob.dtype, device=prob.device),
                y0, phi0)


def dryrun_multichip(n_shards: int, device="cuda") -> dict:
    """One sharded RK4 step of two configurations against the
    single-device step, 1e-8 on max|y| (lpfem's mpirun rank-count
    invariance, ``Convergence_and_Scaling/ss.sh``):

    1. the flagship (finite tank, relaxation zones, one element layer, so
       the partition is compact x-slabs), order 2, p-multigrid;
    2. order 4 on the z-slab window layout, p-multigrid with h-levels below
       p = 1, mixed precision.

    Returns the two differences; raises on a failure."""
    import numpy as np

    from .configs import preset
    from .problem import Problem
    from .shard import ShardedProblem

    out = {}
    prob = Problem(preset("pf_linear_par_partial", nx=max(12, 2 * n_shards),
                          order=2, nsteps=4, cg_max_iter=200,
                          precond="pmg"), device)
    sprob = ShardedProblem(prob, n_shards)
    _, y, phi = sprob.run(n_steps=1)
    sprob.check_state(y, phi)
    _, y1, _ = prob.run(n_steps=1)
    err = float((y1 - y).abs().max())
    if not err < 1e-8:
        raise AssertionError(f"sharded step diverges from single-device: "
                             f"{err}")
    print(f"dryrun_multichip({n_shards}) flagship: ok, "
          f"max |sharded - single| = {err:.3e}")
    out["flagship"] = err

    cfg2 = preset("scaling_base", nx=8, ny=2, nz=2 * n_shards, order=4,
                  nsteps=4, cg_rtol_sq=1e-24, cg_max_iter=400,
                  precond="pmg", h_coarsen_min_dofs=0, dtype="mixed")
    prob2 = Problem(cfg2, device)
    sprob2 = ShardedProblem(prob2, n_shards)
    if sprob2.pt.win is None:
        raise AssertionError("window layout did not engage")
    if sprob2.pmg is None or len(sprob2.pmg.levels) <= 3:
        raise AssertionError("pmg h-levels below p=1 did not engage")
    if sprob2.fine_hi is None:
        raise AssertionError("mixed precision did not engage")
    _, y2, phi2 = sprob2.run(n_steps=1)
    sprob2.check_state(y2, phi2)
    _, y1b, _ = prob2.run(n_steps=1)
    err2 = float((y1b - y2).abs().max())
    if not err2 < 1e-8:
        raise AssertionError(f"order-4 pmg+mixed sharded step diverges: "
                             f"{err2}")
    print(f"dryrun_multichip({n_shards}) order-4 pmg(h)+mixed zslab: ok, "
          f"max |sharded - single| = {err2:.3e}")
    out["zslab_pmg_mixed"] = err2
    out["levels"] = [f"{lv.mode}/{'window' if lv.pt.win else 'compact'}"
                     for lv in sprob2.pmg.levels]
    assert np.isfinite(err) and np.isfinite(err2)
    return out
