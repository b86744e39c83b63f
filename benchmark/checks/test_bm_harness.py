"""The command path end to end at a tiny size on the CPU; the card-only
part (the command itself on a CUDA device) skips here."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.checks.tiny import CELLS, tiny_cell
from benchmark.harness import run_cell

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_reaches_the_result_line(name, trace):
    cell = tiny_cell(name)
    rec = run_cell(cell, 2 ** 40 + 3, 1.0, bool(trace), torch.device("cpu"),
                   log=lambda m: None)
    assert list(rec)[:5] == KEYS and list(rec)[-1] == "checks"
    assert rec["correct"] is True
    assert rec["attempted"] > 0 and rec["failed"] == 0
    want = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in want}
    assert set(rec["metrics"]) <= names
    if not trace:
        assert set(rec["metrics"]) == names
    else:
        # the CPU has no device trace: only the program's counters read
        assert {"timestep.host_syncs_per_step",
                "solvers.inner_iters_per_solve"} <= set(rec["metrics"])
        assert rec["breakdown"]["device_ops"] == []
    json.dumps(rec)


def test_same_seed_same_inputs():
    from benchmark.harness import draw
    ranges = tiny_cell(CELLS[0]).traffic["initial"]
    assert draw(2 ** 40 + 3, ranges) == draw(2 ** 40 + 3, ranges)
    assert draw(2 ** 40 + 3, ranges) != draw(2 ** 40 + 4, ranges)


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal path is not taken")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_command_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark runs on the card only")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900,
        env={**os.environ})
    assert out.returncode == 0, out.stderr[-4000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(rec)[:5] == KEYS and rec["device"]["platform"] == "gpu"
