"""Classic RK4 over the free-surface state.

Counterpart of ``lpfem.timestep`` (MFEM's ``RK4Solver::Step``,
``Solvers/PF_linear_serial.cpp:339,491``): stage times (t, t+dt/2, t+dt/2,
t+dt), ``y += dt/6 (k1 + 2 k2 + 2 k3 + k4)``. The right-hand side is
``f(t, y, aux) -> (dy, aux)``; ``aux`` (the volume potential) threads through
the stages in order, as the CG warm start. The reference's ``lax.scan``
loops are host loops here.
"""

from __future__ import annotations

from typing import Callable

import torch

from .profiling import span, step, sync

__all__ = ["rk4_step", "rk4_run"]

_A = (0.0, 0.5, 0.5, 1.0)
_W = (1.0 / 6.0, 2.0 / 6.0, 2.0 / 6.0, 1.0 / 6.0)


def _leaves(aux):
    if isinstance(aux, torch.Tensor):
        return [aux]
    if isinstance(aux, (tuple, list)):
        return [t for a in aux for t in _leaves(a)]
    return []


def rk4_step(f: Callable, t: float, dt: float, y: torch.Tensor, aux):
    """One classic RK4 step. Each stage needs only the previous stage's k
    (the tableau is strictly subdiagonal): ``y_i = y + dt*a_i*k_{i-1}``."""
    k = torch.zeros_like(y)
    acc = torch.zeros_like(y)
    for ai, wi in zip(_A, _W):
        k, aux = f(t + ai * dt, y + (dt * ai) * k, aux)
        acc = acc + wi * k
    return y + dt * acc, aux


def rk4_run(f: Callable, y0: torch.Tensor, aux0, t0: float, dt: float,
            n_steps: int, guard: bool = True,
            record: Callable | None = None,
            all_finite: Callable | None = None):
    """``n_steps`` RK4 steps. Returns ``((t, y, aux), ok)``.

    With ``guard=True`` each step's state (``y`` and every tensor in ``aux``)
    is checked for finiteness — one host read per step (counted in the
    record of ``lpfem_torch.profiling`` as ``timestep.guard``). Once a step
    produces a non-finite value the run stops at the last finite
    ``(t, y, aux)`` and ``ok`` is False, as the reference's in-scan freeze
    does. Spans: ``timestep.step`` (the step and its guard, not
    ``record``) and ``timestep.guard``.

    ``record(t, y, aux)`` is called after every completed step, the hook
    of lpfem's scan (which stacks what it returns; here the callback keeps
    what it needs). ``all_finite`` maps this process's finiteness flag to
    the flag of every process that holds a part of the state (the sharded
    run over a process group: one rank's NaN stops every rank at the same
    step).
    """
    t, y, aux, ok = float(t0), y0, aux0, True
    for _ in range(n_steps):
        with step(y.device):
            y_new, aux_new = rk4_step(f, t, dt, y, aux)
            if guard:
                with span("timestep.guard"):
                    fin = torch.isfinite(y_new).all()
                    for leaf in _leaves(aux_new):
                        fin = fin & torch.isfinite(leaf).all()
                    if all_finite is not None:
                        fin = all_finite(fin)
                    sync("timestep.guard")
                    ok = bool(fin)
        if not ok:
            break
        y, aux, t = y_new, aux_new, t + dt
        if record is not None:
            record(t, y, aux)
    return (t, y, aux), ok
