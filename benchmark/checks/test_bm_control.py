"""The control fails the comparison where the program passes it: at a tiny
size on the CPU, the program as each configuration states it reads below
the limits, and its control, the program's own path one precision lower
(float32), reads above them, on the late (warm-started) steps too. The
same readings at the cells' own size come from ``benchmark/control.py`` on
the card."""


import pytest
import torch

from benchmark.checks.tiny import CELLS, tiny_cell
from benchmark.control import GAPS, readings

SEEDS = [2 ** 33 + 1, 2 ** 33 + 2]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name):
    cell = tiny_cell(name)
    lim = cell.limits
    dev = torch.device("cpu")
    for r in readings(cell, SEEDS, dev, log=lambda m: None):
        assert all(r[g] <= lim[g] for g in GAPS)
        assert r["unconverged"] == 0
    for r in readings(cell, SEEDS, dev, control=True, log=lambda m: None):
        assert any(r[g] > lim[g] for g in GAPS if g.endswith(".late"))
