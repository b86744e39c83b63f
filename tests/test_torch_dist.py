"""Shards as processes (``lpfem_torch.dist``, ``shard.GroupComm``) on the CPU:
gloo ranks against lpfem's ``ShardedProblem`` and against the port's stacked
shards, and the launcher's cleanup.

- The z-slab p-multigrid tank of ``tests/test_torch_shard.py`` cut to 4
  element layers, float64, over 2 and 3 ranks (``dist.run_spec``: one
  process per shard, ``from_config`` on every rank, each keeping its row)
  with lpfem's smoother lambda_max injected (``convert.smoother_lmax``),
  from the initial state, one step: ``y`` and the global potential within 1e-10
  relative of lpfem's run over a mesh of as many devices and of the
  port's stacked run, and the running maximum of the CG iterations equal to
  both after every step. The ranks run while the test computes the
  references.
- The same tank in mixed precision over 3 ranks for one step, lambda_max
  from the ranks' power iteration through the sharded operators, against
  the stacked run given the same bounds: ``y`` and ``phi`` within 1e-10
  relative, each step's maximum within one inner iteration per outer pass
  (the float32 dots sum per rank, then across ranks); and ``pf_linear_par``
  under ``apply_mode="assembled"`` over 2 ranks (each rank's partial
  assembly, the ELL level, on the flagship's compact slabs), float64, with
  equal iterations.
- ``run_ranks``: a rank that sleeps past the deadline, a rank that exits 1
  while its sibling sleeps, and a rank that ignores SIGTERM are all reaped
  (``RankError`` raised, no child of the test process left in ``/proc``).
- ``kernels._build.build_libraries`` with a stub compiler that fails for one
  source while the other compile sleeps: the error is raised after both
  are reaped.
- ``experiments.scaling --processes`` against the stacked row.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest

from lpfem.configs import preset as lp_preset
from lpfem.problem import Problem as LProblem
from lpfem.shard import ShardedProblem as LShardedProblem
from lpfem.shard import make_device_mesh
from lpfem.solvers import jacobi_preconditioner as lp_jacobi

import lpfem_torch
import torch
from lpfem_torch import convert, dist
from lpfem_torch.kernels import _build
from lpfem_torch.shard import ShardedProblem
from lpfem_torch.solvers import jacobi_preconditioner

KW = dict(nx=4, ny=2, nz=4, order=2, precond="pmg", cg_rtol_sq=1e-24,
          cg_max_iter=400)


def _stacked(kw, ndev, lmax, steps, name="scaling_base"):
    st = ShardedProblem.from_config(lpfem_torch.preset(name, **kw), ndev,
                                    device="cpu", lmax=lmax)
    its = []
    _, y, phi = st.run(n_steps=steps,
                       record=lambda t, y, aux: its.append(
                           aux.stats.max_iters))
    return y.numpy(), st.phi_global(phi), np.array(its), st


def _ranks(kw, ndev, lmax, steps, tmp_path, name="scaling_base"):
    res = dist.run_spec({"preset": name, "config": kw,
                         "steps": steps, "device": "cpu", "lmax": lmax},
                        ndev, tmp_path, timeout=240)
    its = [r["max_iters_per_step"] for r in res["ranks"]]
    assert all(i == its[0] for i in its)          # one decision on every rank
    assert not res["ranks"][0]["unconverged"]
    return res["y"], res["phi"], np.array(its[0]), res["ranks"]


def _close(a, ref, what):
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(a - ref)) < 1e-10 * scale, what


@pytest.mark.parametrize("ndev", [2, 3])
def test_ranks_match_lpfem_and_stacked(ndev, tmp_path):
    lp = LProblem(lp_preset("scaling_base", **KW))
    sl = LShardedProblem(lp, mesh=make_device_mesh(ndev))
    lmax = convert.smoother_lmax(sl.pmg)
    with ThreadPoolExecutor(1) as pool:
        ranks_run = pool.submit(_ranks, KW, ndev, lmax, 1, tmp_path)
        (t_l, y_l, ph_l), its_l = sl.run(
            n_steps=1, state=lp.initial_state(),
            record=lambda t, y, aux: aux[1].max_iters)
        y_s, ph_s, its_s, st = _stacked(KW, ndev, lmax, 1)
        y_r, ph_r, its_r, ranks = ranks_run.result()
    assert st.pt.win is not None and len(st.pmg.levels) == 2
    assert ranks[0]["collectives"]["fwd"] > 0       # the neighbour shifts ran
    s2v = np.asarray(lp.surf.surf_to_vol)
    y_lc, _ = convert.state_from_lpfem(np.asarray(y_l), np.zeros(0), s2v,
                                       st.prob.space.dof_dims)
    ph_lc = st.phi_global(np.asarray(ph_l))          # the same partition
    _close(y_r, y_lc, "y vs lpfem")
    _close(ph_r, ph_lc, "phi vs lpfem")
    _close(y_r, y_s, "y vs stacked")
    _close(ph_r, ph_s, "phi vs stacked")
    np.testing.assert_array_equal(its_r, np.asarray(its_l))
    np.testing.assert_array_equal(its_r, its_s)


@pytest.mark.parametrize("case", ["mixed z-slab", "assembled"])
def test_ranks_match_stacked(case, tmp_path):
    name, kw, ndev = {
        "mixed z-slab": ("scaling_base", dict(KW, dtype="mixed"), 3),
        "assembled": ("pf_linear_par", dict(apply_mode="assembled",
                                            dtype="float64"), 2),
    }[case]
    y_r, ph_r, its_r, ranks = _ranks(kw, ndev, None, 1, tmp_path, name)
    y_s, ph_s, its_s, st = _stacked(kw, ndev, ranks[0]["lmax"], 1, name)
    _close(y_r, y_s, "y")
    _close(ph_r, ph_s, "phi")
    if case == "assembled":
        assert st.fine.mode == "ell" and st.pmg is None
        np.testing.assert_array_equal(its_r, its_s)
    else:
        assert np.all(np.abs(its_r - its_s) <= st.prob.cfg.ir_max_outer)


# ------------------------------------------------------------- the launcher
def _no_children():
    left = dist.live_descendants()
    assert left == [], left


@pytest.mark.parametrize("case", ["hung", "failed", "ignores SIGTERM"])
def test_run_ranks_reaps(case):
    code = {
        "hung": "import os, time; time.sleep(0 if os.environ['RANK'] == '0' "
                "else 60)",
        "failed": "import os, sys, time; sys.exit(1) "
                  "if os.environ['RANK'] == '1' else time.sleep(60)",
        "ignores SIGTERM": "import os, signal, time; signal.signal("
                           "signal.SIGTERM, signal.SIG_IGN); "
                           "print('up', flush=True); time.sleep(60)",
    }[case]
    t0 = time.monotonic()
    with pytest.raises(dist.RankError) as err:
        dist.run_ranks(["-c", code], 2, timeout=1.0, grace=0.5)
    assert time.monotonic() - t0 < 20
    assert ("exited 1" in str(err.value)) == (case == "failed")
    _no_children()


def test_run_ranks_outputs_and_environment():
    outs = dist.run_ranks(["-c", "import os; print(os.environ['RANK'], "
                                 "os.environ['WORLD_SIZE'], "
                                 "os.environ['OMP_NUM_THREADS'])"], 3,
                          timeout=60)
    assert [o.split() for o in outs] == [[str(r), "3", "1"] for r in range(3)]
    _no_children()


def test_build_failure_reaps_sibling_compiles(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "bad.cu").write_text("bad")
    (src / "slow.cu").write_text("slow")
    stub = tmp_path / "nvcc"
    stub.write_text("#!/bin/sh\ncase \"$*\" in *bad.cu) exit 1;; esac\n"
                    "sleep 60\n")
    stub.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(stub))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="nvcc failed for csrc/bad.cu"):
        _build.build_libraries(["bad", "slow"])
    assert time.monotonic() - t0 < 30
    _no_children()
    assert not list((tmp_path / "build").glob("*"))


# ------------------------------------------------------------------- A1
def test_jacobi_preconditioner_matches_lpfem():
    rng = np.random.default_rng(0)
    diag = rng.uniform(0.5, 2.0, 257)
    r = rng.standard_normal(257)
    ref = np.asarray(lp_jacobi(jnp.asarray(diag))(jnp.asarray(r)))
    got = jacobi_preconditioner(torch.as_tensor(diag))(torch.as_tensor(r))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-15, atol=0)
    assert "jacobi_preconditioner" in lpfem_torch.solvers.__all__


def test_scaling_processes_matches_stacked_row(tmp_path):
    """``scaling --processes``: a float64 row over 2 gloo ranks against the
    same row with stacked shards (the cold iterations equal, the final eta
    within 1e-10 relative)."""
    from lpfem_torch.experiments import scaling
    argv = ["--shards", "2", "--orders", "2", "--steps", "1", "--repeats",
            "1", "--device", "cpu", "--rtol-sq", "1e-24", "--dtype",
            "float64"]
    rows = [scaling.main(argv + ["--out", str(tmp_path / f"{k}.txt"), *x])[0]
            for k, x in (("stacked", []), ("ranks", ["--processes"]))]
    stacked, ranks = rows
    assert ranks["processes"] and not stacked["processes"]
    assert ranks["cold_iters"] == stacked["cold_iters"]
    assert ranks["converged"] and ranks["exchange"] == stacked["exchange"]
    assert abs(ranks["eta_abs_max"] - stacked["eta_abs_max"]) <= \
        1e-10 * stacked["eta_abs_max"]
    _no_children()
