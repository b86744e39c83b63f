"""What the benchmark loads: nothing of the JAX stack anywhere, nothing of
the program in the reference. Top-level names are compared whole, since the
port's name ``lpfem_torch`` begins with the JAX package's ``lpfem``."""

import functools
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import FORBIDDEN, forbidden_modules

ROOT = Path(__file__).resolve().parents[2]

_PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_RUN = """
import torch
from benchmark.checks.tiny import tiny_cell
from benchmark.harness import run_cell
for name in {cells!r}:
    for trace in (False, True):
        run_cell(tiny_cell(name), 7, 0.5, trace, torch.device("cpu"),
                 log=lambda m: None)
import benchmark.run, benchmark.control
"""

_REFERENCE = """
import torch
from benchmark import reference
from benchmark.reference import basis, cylinder, tank
from benchmark.checks.tiny import tiny_cell
from benchmark.harness import program_params
for name in {cells!r}:
    cell = tiny_cell(name)
    params, _ = program_params(cell)
    ref = reference.make(cell.config, params, "cpu")
    y = torch.rand(2 * ref.n_surf, dtype=torch.float64)
    ref.step(0.0, y)
"""


@functools.lru_cache(maxsize=None)
def _top_level(body: str) -> list:
    out = subprocess.run([sys.executable, "-c", _PROBE.format(
        root=str(ROOT), body=body)], capture_output=True, text=True,
        timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _cells():
    from benchmark.checks.tiny import CELLS
    return CELLS


def test_forbidden_compares_whole_names(monkeypatch):
    base = set(forbidden_modules())
    for name in ("lpfem_torch", "lpfem_torch.problem", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "lpfem.problem", sys)
    assert set(forbidden_modules()) == base | {"lpfem"}


def test_a_run_loads_nothing_of_the_jax_stack():
    loaded = _top_level(_RUN.format(cells=_cells()))
    assert "lpfem_torch" in loaded
    assert not [m for m in loaded if m in FORBIDDEN]


@pytest.mark.parametrize("name", ["lpfem_torch", "lpfem", "jax", "jaxlib",
                                  "flax"])
def test_the_reference_loads_nothing_of_the_program(name):
    loaded = _top_level(_REFERENCE.format(cells=_cells()))
    assert name not in loaded
