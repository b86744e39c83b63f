"""A run whose timed path is broken underneath reports ``correct`` false.

Each test drives the whole run (build, warm-up, window, check) at a tiny
size on the CPU, with one fault planted in the program: a step that returns
its state unchanged; half of the surface state left out of the update; one
answer of the free-surface trace altered where it is produced. (The cells
run on one card, so no exchange between chips can be left out.)"""


import pytest
import torch

from benchmark.checks.tiny import CELLS, tiny_cell
from benchmark.harness import run_cell

SEED = 2 ** 35 + 11


def _run(name):
    return run_cell(tiny_cell(name), SEED, 0.5, False, torch.device("cpu"),
                    log=lambda m: None)


def _unchanged(monkeypatch):
    from lpfem_torch import timestep
    orig = timestep.rk4_step

    def step(f, t, dt, y, aux):
        _, aux = orig(f, t, dt, y, aux)
        return y.clone(), aux

    monkeypatch.setattr(timestep, "rk4_step", step)


def _half_left_out(monkeypatch):
    from lpfem_torch import timestep
    orig = timestep.rk4_step

    def step(f, t, dt, y, aux):
        y_new, aux = orig(f, t, dt, y, aux)
        half = y.shape[0] // 4          # half of eta's entries
        y_new[:half] = y[:half]
        return y_new, aux

    monkeypatch.setattr(timestep, "rk4_step", step)


def _altered(monkeypatch):
    from lpfem_torch import operators
    orig = operators.NodalZDerivative.top_trace

    def top_trace(self, x):
        w = orig(self, x).clone()
        w[w.shape[0] // 3] *= 1.001
        return w

    monkeypatch.setattr(operators.NodalZDerivative, "top_trace", top_trace)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    assert _run(name)["correct"] is True


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _altered])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    rec = _run(name)
    assert rec["correct"] is False
    assert max(c["value"] for k, c in rec["checks"].items()
               if "_gap." in k) > 1e-8
