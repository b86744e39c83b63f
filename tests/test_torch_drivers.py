"""The port's entry points against the JAX package's on the CPU.

- ``lpfem_torch.bench``: ``bench_once`` at refs = 0, order 2, 2 steps, one
  repeat has the cold-solve iteration count of ``bench.bench_once`` (lpfem's
  smoother lambda_max injected); its JSON line has ``bench.py``'s keys, its
  ``detail`` those of ``bench.py:224-245`` plus the card, memory and
  convergence keys; ``--scales`` writes its table (``bench.py``'s columns,
  then convergence, set-up and memory) only under ``chiprun_out/`` of the
  working directory.
- ``experiments.laplace_conv``: the p-table it writes agrees with the
  committed ``data/laplace-pconv-phi.txt`` (lpfem's float64 run) at p = 1, 2.
- ``experiments.pf_conv`` at p = 2 for 4 steps: the table of lpfem's driver
  within 1e-10, and so is the table of its ``--shard 2`` run.
- ``experiments.pf_run``: a run resumed from a checkpoint ends bit for bit
  where the uninterrupted run does; ParaView output is written.
- ``entry``: one step of ``fn``: the state y within 1e-12 of max|y| of
  lpfem's ``entry()``; the volume potential phi, a CG iterate converged to
  r.z <= rz0*1e-24 (a relative residual of 1e-12), within 1e-11 of
  max|phi| (the two summation orders leave 1.3e-12 of max|phi| between the
  two iterates).
- importing every module of ``lpfem_torch`` in a fresh interpreter loads
  neither ``jax`` nor ``lpfem``.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import bench as lp_bench
import __graft_entry__ as lp_entry
from experiments import pf_conv as lp_pf_conv
from lpfem.configs import preset as lp_preset
from lpfem.problem import Problem as LProblem

import lpfem_torch
import lpfem_torch.io
from lpfem_torch import bench, convert
from lpfem_torch.entry import entry, small_config
from lpfem_torch.experiments import apply_bench, laplace_conv, pf_conv, pf_run

ROOT = Path(__file__).resolve().parent.parent
BENCH_ARGS = ["--refs", "0", "--order", "2", "--steps", "2", "--repeats", "1",
              "--device", "cpu"]
EXTRA_DETAIL = {"device", "power_limit", "setup_s", "peak_device_mem_bytes",
                "peak_rss_bytes", "unconverged_steps", "timed_inner_iters"}


def test_bench_once_matches_lpfem(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)          # no BENCH_r*.json for lpfem to read
    args = bench.parser().parse_args(BENCH_ARGS)
    args.chunk = 0                       # lpfem's TPU program split: off
    ref = lp_bench.bench_once(args, 0)
    cfg = lp_preset("scaling_base", order=2, ref_levels=0, precond="pmg",
                    cheb_degree=4, dtype="mixed", cg_rtol_sq=1e-16,
                    cg_max_iter=300)
    lmax = convert.smoother_lmax(LProblem(cfg).fso._precond)
    got = bench.bench_once(args, 0, lmax=lmax)
    assert got["n_dofs"] == ref["n_dofs"] == 5440
    assert got["cg_iters"] == ref["cg_iters"] > 0
    assert got["cold_converged"] and not got["unconverged_steps"]
    assert got["timed_inner_iters"] >= 4 * 2
    assert got["value"] == got["n_dofs"] * 4 * 2 / got["wall_s"]
    assert got["peak_device_mem_bytes"] is None and got["peak_rss_bytes"] > 0

    # the JSON line: lpfem's keys (its main on the result above) and ours
    monkeypatch.setattr(lp_bench, "bench_once", lambda *a, **k: ref)
    monkeypatch.setattr(sys, "argv", ["bench.py"] + BENCH_ARGS[:-2]
                        + ["--no-secondary"])
    capsys.readouterr()
    lp_bench.main()
    lp_rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rec = bench.main(BENCH_ARGS + ["--no-secondary"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    # lpfem's keys but its comparison with the previous TPU round
    assert rec.keys() == lp_rec.keys() - {"vs_baseline"}
    assert set(rec["detail"]) == (set(lp_rec["detail"])
                                  - {"vs_baseline_basis"}) | EXTRA_DETAIL
    assert rec["metric"] == "laplace_dof_throughput"
    assert rec["detail"]["backend"] == "cpu"
    assert rec["detail"]["cg_iters"] == ref["cg_iters"]
    assert rec["detail"]["unconverged_steps"] is False
    assert rec["detail"]["timed_inner_iters"] >= 4 * 2
    assert rec["detail"]["secondary_f32"] is None


def test_bench_scales_write_only_under_chiprun_out(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    out = bench.main(["--scales", "0", "--order", "2", "--steps", "1",
                      "--repeats", "1", "--device", "cpu"])
    assert out == "chiprun_out/bench-scales-cpu.txt"
    files = sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*")
                   if p.is_file())
    assert files == ["chiprun_out/bench-scales-cpu.txt"]
    lines = (tmp_path / out).read_text().splitlines()
    # bench.py's columns, then convergence, set-up and memory
    assert lines[0] == ("# refs dofs dtype rtol_sq wall_s dof_solves_per_s "
                        "cg_iters apply_ms steps_converged timed_inner_iters "
                        "setup_s peak_device_mem_bytes")
    cols = lines[1].split()
    assert cols[:4] == ["0", "5440", "mixed", "1e-16"] and len(cols) == 12
    assert cols[8] == "1" and int(cols[9]) >= 4 and cols[11] == "nan"


def test_laplace_conv_table_matches_committed_data(tmp_path):
    out = str(tmp_path / "pconv.txt")
    assert laplace_conv.main(["--mode", "p", "--max-order", "2", "--out", out,
                              "--device", "cpu"]) == out
    got = np.loadtxt(out, ndmin=2)
    ref = np.loadtxt(ROOT / "data" / "laplace-pconv-phi.txt", ndmin=2)[:2]
    np.testing.assert_array_equal(got[:, :2], ref[:, :2])    # order, dofs
    np.testing.assert_allclose(got[:, 2:4], ref[:, 2:4], rtol=1e-9, atol=0)


def test_pf_conv_matches_lpfem(monkeypatch, tmp_path):
    common = ["--mode", "p", "--min-order", "2", "--max-order", "2",
              "--nsteps", "4"]
    lp_out, out = str(tmp_path / "lp.txt"), str(tmp_path / "pt.txt")
    monkeypatch.setattr(sys, "argv", ["pf_conv"] + common + ["--out", lp_out])
    lp_pf_conv.main()
    pf_conv.main(common + ["--out", out, "--device", "cpu"])
    ref, got = np.loadtxt(lp_out, ndmin=2), np.loadtxt(out, ndmin=2)
    np.testing.assert_array_equal(got[:, :2], ref[:, :2])    # order, dofs
    assert np.max(np.abs(got[:, 2:4] - ref[:, 2:4])) <= 1e-10
    # the sharded runner (the reference's mpirun form) gives the same table
    sh_out = str(tmp_path / "pt-shard2.txt")
    pf_conv.main(common + ["--shard", "2", "--out", sh_out,
                           "--device", "cpu"])
    got2 = np.loadtxt(sh_out, ndmin=2)
    np.testing.assert_array_equal(got2[:, :2], ref[:, :2])
    assert np.max(np.abs(got2[:, 2:4] - ref[:, 2:4])) <= 1e-10


def test_pf_run_resume_is_bit_for_bit(tmp_path, monkeypatch):
    common = ["--preset", "pf_linear_periodic", "--nsteps", "40",
              "--checkpoint-every", "20", "--device", "cpu"]
    pv = str(tmp_path / "pv")
    full, half = str(tmp_path / "full.npz"), str(tmp_path / "half.npz")
    save = lpfem_torch.io.save_checkpoint

    def save_and_keep_step_20(path, **kw):
        # the checkpoint an interrupted run would have left
        save(path, **kw)
        if kw["step"] == 20:
            save(half, **kw)

    monkeypatch.setattr(lpfem_torch.io, "save_checkpoint",
                        save_and_keep_step_20)
    t, y, phi = pf_run.main(common + ["--checkpoint", full,
                                      "--paraview-every", "20",
                                      "--paraview-dir", pv])
    monkeypatch.setattr(lpfem_torch.io, "save_checkpoint", save)
    res = str(tmp_path / "res.npz")
    t2, y2, phi2 = pf_run.main(common + ["--resume", half,
                                         "--checkpoint", res])
    assert t2 == t
    assert torch.equal(y2, y) and torch.equal(phi2, phi)
    a, b = np.load(full), np.load(res)
    for k in ("step", "t", "y", "phi"):
        np.testing.assert_array_equal(a[k], b[k])
    assert int(np.load(half)["step"]) == 20 and int(a["step"]) == 40
    for name in ("pf_linear_periodic_vol", "pf_linear_periodic_fs"):
        d = Path(pv) / name
        assert sorted(p.name for p in d.iterdir()) == [
            f"{name}.pvd", f"{name}_000020.vtu", f"{name}_000040.vtu"]


def test_entry_step_matches_lpfem():
    lfn, largs = lp_entry.entry()
    ly, lphi = (np.asarray(v) for v in lfn(*largs))
    fn, args = entry("cpu")
    assert args[0].dtype == torch.float64 and float(args[0]) == 0.0
    y, phi = fn(*args)
    lp = LProblem(lp_entry._small_cfg())
    dims = lpfem_torch.Problem(small_config(), "cpu").space.dof_dims
    yc, phic = convert.state_from_lpfem(ly, lphi,
                                        np.asarray(lp.surf.surf_to_vol), dims)
    assert np.max(np.abs(y.numpy() - yc)) <= 1e-12 * np.max(np.abs(yc))
    assert np.max(np.abs(phi.numpy() - phic)) <= 1e-11 * np.max(np.abs(phic))


def test_apply_bench_single_row():
    r = apply_bench.main(["--refs", "0", "--order", "2", "--iters", "3",
                          "--repeats", "2", "--device", "cpu"])
    assert r["operator"] == "SeparableLattice" and r["single_ms"] > 0


def test_every_module_imports_without_jax_or_lpfem():
    code = ("import importlib, pkgutil, sys, lpfem_torch\n"
            "for m in pkgutil.walk_packages(lpfem_torch.__path__, "
            "'lpfem_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "need = {'lpfem_torch.bench', 'lpfem_torch.entry', "
            "'lpfem_torch.io', 'lpfem_torch.profiling', "
            "'lpfem_torch.experiments.laplace_conv', "
            "'lpfem_torch.experiments.pf_conv', "
            "'lpfem_torch.experiments.pf_run', "
            "'lpfem_torch.experiments.apply_bench', 'lpfem_torch.shard', "
            "'lpfem_torch.experiments.scaling'}\n"
            "missing = need - set(sys.modules)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'lpfem')]\n"
            "print(bad, missing); sys.exit(1 if bad or missing else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
