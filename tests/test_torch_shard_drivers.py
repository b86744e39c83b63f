"""The port's sharded path against the port's single-device path, and the
entry points that run it, on the CPU (plain versions of the kernels).

- ``entry.dryrun_multichip(n, device="cpu")`` at 3 and 4 shards: the
  flagship on compact x-slabs and order 4 on the z-slab window with
  p-multigrid h-levels and mixed precision, one RK4 step each against the
  single-device step (it raises above 1e-8; here max|y| differences below
  1e-10, the bound of ``tests/test_shard.py``: 1e-10 times max(max|y|, 1)).
- ``ShardedProblem.from_config`` (set-up on the host, lambda_max through
  the sharded operators) against the single-device ``Problem`` with the
  same lambda_max, 3 RK4 steps at ``cg_rtol_sq`` 1e-24: 1e-10 as above.
- The drivers' sharded paths with ``--device cpu``: ``pf_conv --shard 4``
  (its metrics within 1e-10 relative of ``--shard 0``'s),
  ``diffraction --quick --shard 3`` (the rim envelope within 1e-10 of the
  single-device run's), ``scaling`` over 1 and 3 shards at ``--rtol-sq``
  1e-24 (the same cold iterations, every stage converged, the final
  max|eta| within 1e-10 relative; at the protocol's 1e-16 two valid runs
  differ by ~3e-7), ``apply_bench``'s sharded rows.
- ``ShardedProblem`` refuses ``apply_mode="assembled"`` with ``dtype=
  "mixed"`` (as lpfem's ``Problem``) and ``hi_apply="ds"``.
"""

import json

import numpy as np
import pytest

import lpfem_torch
from lpfem_torch.entry import dryrun_multichip
from lpfem_torch.experiments import apply_bench, diffraction, pf_conv, scaling
from lpfem_torch.shard import ShardedProblem


@pytest.mark.parametrize("n_shards", [3, 4])
def test_dryrun_multichip_on_cpu(n_shards):
    out = dryrun_multichip(n_shards, device="cpu")
    assert out["flagship"] < 1e-10 and out["zslab_pmg_mixed"] < 1e-10
    assert len(out["levels"]) > 3


def test_from_config_matches_single_device():
    cfg = lpfem_torch.preset("scaling_base", nx=4, ny=2, nz=8, order=2,
                             nsteps=3, precond="pmg", cg_rtol_sq=1e-24,
                             cg_max_iter=400)
    sp = ShardedProblem.from_config(cfg, 4, device="cpu")
    assert sp.pt.win is not None and sp.pmg is not None
    assert sp.fine.invd.device.type == "cpu"
    prob = lpfem_torch.Problem(cfg, device="cpu", lmax=sp.pmg.lmax)
    _, y1, phi1 = prob.run()
    _, y2, phi2 = sp.run()
    sp.check_state(y2, phi2)
    scale = max(float(y1.abs().max()), 1.0)
    assert float((y1 - y2).abs().max()) < 1e-10 * scale
    assert np.max(np.abs(phi1.numpy() - sp.phi_global(phi2))) < 1e-10


def test_pf_conv_shard_matches_single(tmp_path):
    rows = {}
    for shard in (0, 4):
        out = tmp_path / f"p{shard}.txt"
        pf_conv.main(["--mode", "p", "--min-order", "2", "--max-order", "2",
                      "--nx", "8", "--nz", "1", "--nsteps", "6",
                      "--shard", str(shard), "--device", "cpu",
                      "--out", str(out)])
        rows[shard] = np.loadtxt(out, ndmin=2)[0]
    # order, surface dofs, eta error, w error (the wall differs)
    np.testing.assert_array_equal(rows[0][:2], rows[4][:2])
    np.testing.assert_allclose(rows[4][2:4], rows[0][2:4], rtol=1e-10)


def test_diffraction_shard_matches_single(tmp_path):
    res = {}
    for shard in (0, 3):
        out = tmp_path / f"rim{shard}.txt"
        res[shard] = diffraction.main([
            "--quick", "--nsteps", "8", "--periods", "0.25", "--device",
            "cpu", "--shard", str(shard), "--out", str(out),
            "--out-exact", str(tmp_path / "exact.txt"), "--compare", ""])
        res[shard]["rim"] = np.loadtxt(out, ndmin=2)
    assert res[3]["shards"] == 3 and not res[3]["unconverged"]
    a, b = res[0]["rim"], res[3]["rim"]
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    assert np.max(np.abs(a[:, 1] - b[:, 1])) < 1e-10 * np.max(np.abs(a[:, 1]))
    summary = json.loads((tmp_path / "rim3.json").read_text())
    assert summary["shards"] == 3


def test_scaling_rows_on_cpu(tmp_path):
    out = tmp_path / "strong.txt"
    rows = scaling.main(["--mode", "strong", "--shards", "1", "3",
                         "--orders", "2", "--steps", "2", "--repeats", "1",
                         "--precond", "pmg", "--rtol-sq", "1e-24",
                         "--device", "cpu", "--out", str(out)])
    assert [r["shards"] for r in rows] == [1, 3]
    assert all(r["layout"] == "window" and r["converged"] for r in rows)
    assert rows[0]["cold_iters"] == rows[1]["cold_iters"]
    assert abs(rows[0]["eta_abs_max"] - rows[1]["eta_abs_max"]) \
        < 1e-10 * rows[0]["eta_abs_max"]
    assert np.loadtxt(out, ndmin=2, usecols=(1, 3)).tolist() == [[2, 1],
                                                                 [2, 3]]


def test_apply_bench_sharded_rows_on_cpu():
    r = apply_bench.main(["--refs", "0", "--order", "2", "--iters", "2",
                          "--repeats", "1", "--shards", "3", "--device",
                          "cpu"])
    assert r["sharded_window_ms"] > 0 and r["sharded_compact_ms"] > 0


@pytest.mark.parametrize("override,error,reason", [
    (dict(apply_mode="assembled", dtype="mixed"), ValueError, "assembled"),
    (dict(hi_apply="ds", dtype="mixed"), NotImplementedError, "ds")])
def test_sharded_problem_refuses_unported(override, error, reason):
    cfg = lpfem_torch.preset("scaling_base", nx=4, ny=2, nz=8, order=2,
                             **override)
    with pytest.raises(error, match=reason):
        ShardedProblem.from_config(cfg, 4, device="cpu")
