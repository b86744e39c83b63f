"""Entry point: one RK4 step of the flagship model on the card.

Counterpart of ``__graft_entry__.entry`` (``__graft_entry__.py:14-33``):
``entry()`` returns ``(fn, example_args)`` for one RK4 step of
``preset("pf_linear_par_partial", nx=12, order=2, nsteps=4,
cg_max_iter=200)`` (finite wave tank, relaxation zones, Jacobi-CG).
``fn(t, y, phi)`` returns ``(y, phi)`` after the step.

lpfem's ``dryrun_multichip`` (the sharded step on an n-device mesh) waits
for the sharding port (ROADMAP A6).
"""

from __future__ import annotations

__all__ = ["small_config", "entry"]


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
