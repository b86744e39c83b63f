"""Shards as the ranks of a ``torch.distributed`` process group: the
launcher, the rank's set-up, and a rank program that runs a sharded problem.

Counterpart of lpfem's ``shard_map`` over a device mesh
(``lpfem/shard.py``) with one process per shard, each holding its row of the
sharded tables (``shard.GroupComm``). The backend is gloo: every collective
is staged through host tensors, so the ranks may share one card (each with
its own CUDA context) or run on the CPU.

- :func:`run_ranks` starts ``world`` plain ``python`` processes (no
  ``torchrun``, no elastic agent, no ``multiprocessing`` start method, so
  no resource tracker or fork server outlives the caller), each in its own
  process group, with ``RANK``, ``WORLD_SIZE``, ``OMP_NUM_THREADS=1`` and a
  ``FileStore`` path in its environment. It waits on all of them with one
  deadline; on a timeout, a nonzero exit or an exception in the caller it
  terminates every rank still alive (its process group: a compiler it
  started goes too), kills it after a grace period, and waits on each.
  Ranks write their standard output to files, which it returns.
- :func:`rank_group` is the rank's side: ``init_process_group`` with a
  timeout (a stuck collective raises instead of hanging) and a
  ``destroy_process_group`` in a ``finally``.
- ``python -m lpfem_torch.dist SPEC.json`` (launched by :func:`run_spec`)
  builds ``ShardedProblem.from_config`` of the spec's preset over the
  group, runs it and writes each rank's readings (set-up seconds, wall per
  step, iterations per step, B1-shard / B2-shard launches, collectives;
  with ``timing`` the seconds inside them and one shift alone, its
  copies alone and gloo alone) to
  ``<out>/rank<r>.json`` and rank 0's state ``y`` and global potential to
  ``<out>/result.npz``.

    from lpfem_torch.dist import run_spec
    res = run_spec({"preset": "scaling_base", "config": {"nx": 4, "nz": 4,
                    "order": 2}, "steps": 2, "device": "cpu"}, world=2,
                   out="build/ranks")
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

__all__ = ["RankError", "run_ranks", "rank_group", "run_spec",
           "live_descendants"]

_ROOT = Path(__file__).resolve().parent.parent
INIT_ENV = "LPFEM_DIST_INIT"
GRACE_S = 5.0
COLLECTIVE_TIMEOUT_S = 120.0     # a stuck collective raises after this


class RankError(RuntimeError):
    """A rank failed or the ranks passed their deadline (every rank has
    been reaped when this is raised)."""


def live_descendants() -> list[tuple[int, str]]:
    """(pid, command line) of every live descendant of this process, read
    recursively from ``/proc/<pid>/task/*/children``."""
    out, todo = [], [os.getpid()]
    while todo:
        p = todo.pop()
        for kids in Path(f"/proc/{p}/task").glob("*/children"):
            try:
                ids = [int(c) for c in kids.read_text().split()]
            except OSError:                     # the task ended meanwhile
                continue
            for c in ids:
                try:
                    cmd = Path(f"/proc/{c}/cmdline").read_bytes()
                except OSError:
                    continue
                out.append((c, cmd.replace(b"\0", b" ").decode().strip()))
                todo.append(c)
    return out


def _signal_group(proc: subprocess.Popen, sig: int) -> None:
    """``sig`` to the rank's process group (the rank and what it started)."""
    with contextlib.suppress(ProcessLookupError, PermissionError):
        os.killpg(proc.pid, sig)


def _reap(procs: list[subprocess.Popen], grace: float) -> None:
    """Terminate every rank still alive, kill it after ``grace`` seconds,
    wait on each; then kill whatever is left in the ranks' groups."""
    for p in procs:
        if p.poll() is None:
            _signal_group(p, signal.SIGTERM)
    end = time.monotonic() + grace
    for p in procs:
        try:
            p.wait(timeout=max(end - time.monotonic(), 0.0))
        except subprocess.TimeoutExpired:
            _signal_group(p, signal.SIGKILL)
            p.wait()
    for p in procs:
        _signal_group(p, signal.SIGKILL)


def _tail(path: Path, n: int = 4000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def run_ranks(argv: list[str], world: int, timeout: float,
              grace: float = GRACE_S) -> list[str]:
    """Run ``python <argv>`` as ``world`` ranks of one gloo group and return
    each rank's standard output. Raises :class:`RankError` (with the
    failing ranks' standard error) when a rank exits nonzero or the ranks
    are not all done within ``timeout`` seconds; every rank has been reaped
    by then, and on any other exception too."""
    tmp = Path(tempfile.mkdtemp(prefix="lpfem-ranks-"))
    base = dict(os.environ)
    base["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + ([base["PYTHONPATH"]] if base.get("PYTHONPATH")
                        else []))
    base.update({"WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1",
                 INIT_ENV: f"file://{tmp / 'store'}",
                 "GLOO_SOCKET_IFNAME": "lo"})
    procs, files = [], []
    try:
        for r in range(world):
            out = open(tmp / f"rank{r}.out", "w")
            err = open(tmp / f"rank{r}.err", "w")
            files += [out, err]
            procs.append(subprocess.Popen(
                [sys.executable, *argv], env={**base, "RANK": str(r)},
                stdin=subprocess.DEVNULL, stdout=out, stderr=err,
                process_group=0))
        deadline = time.monotonic() + timeout
        while True:
            rcs = [p.poll() for p in procs]
            bad = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            late = time.monotonic() > deadline
            if bad or late:
                alive = [r for r, rc in enumerate(rcs) if rc is None]
                what = (f"rank {bad[0]} exited {rcs[bad[0]]}" if bad else
                        f"ranks {alive} still running after {timeout} s")
                _reap(procs, grace)
                logs = "".join(f"\n--- rank {r} stderr ---\n"
                               f"{_tail(tmp / f'rank{r}.err')}"
                               for r in (bad or range(world)))
                raise RankError(f"{what} (argv {argv}){logs}")
            if all(rc == 0 for rc in rcs):
                break
            time.sleep(0.02)
        return [(tmp / f"rank{r}.out").read_text() for r in range(world)]
    finally:
        _reap(procs, grace)
        for f in files:
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def rank_group(timing: bool = False):
    """The rank's side of :func:`run_ranks`: join the gloo group from the
    environment and yield its :class:`~lpfem_torch.shard.GroupComm`; the
    group is destroyed on the way out, also after an exception."""
    import torch.distributed as dist

    from .shard import GroupComm

    dist.init_process_group(
        "gloo", init_method=os.environ[INIT_ENV],
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        yield GroupComm(timing=timing)
    finally:
        dist.destroy_process_group()


def _counts(zero: bool = False) -> dict:
    from .kernels import lattice_apply, sep_apply
    if zero:
        sep_apply.LAUNCHES_SHARD = 0
        lattice_apply.LAUNCHES_SHARD = 0
    return {"sep_apply_shard": sep_apply.LAUNCHES_SHARD,
            "lattice_affine_apply_shard": lattice_apply.LAUNCHES_SHARD}


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _mesh(spec: dict):
    """The spec's mesh: ``{"fn": "module:function", "kwargs": {...}}``."""
    if not spec.get("mesh"):
        return None
    import importlib
    mod, fn = spec["mesh"]["fn"].split(":")
    return getattr(importlib.import_module(mod), fn)(
        **spec["mesh"].get("kwargs", {}))


def _shift_probe(sp, comm, reps: int = 50) -> dict:
    """Median ms of one ``fwd`` shift of the fine level's interface rows
    alone (from its copy to the host to its copy back), of its two copies
    alone, and of the shift of a host tensor (gloo alone)."""
    import statistics

    import torch
    lv = sp.fine
    n = lv.Wf if lv.exchange == "ppermute" else lv.NS + 1
    x = torch.zeros(1, n, dtype=lv.dtype, device=lv.device)
    xh = x.cpu()
    out = {}
    for name, fn in (("shift_ms", lambda: comm.shift(x, "fwd")),
                     ("staging_ms", lambda: comm._back(comm._to_host(x), x)),
                     ("gloo_ms", lambda: comm.shift(xh, "fwd"))):
        times = []
        for _ in range(reps):
            _sync(lv.device)
            t0 = time.perf_counter()
            fn()
            _sync(lv.device)
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    return out


def rank_main(spec: dict) -> None:
    """The rank program: the spec's sharded run over this process group."""
    import numpy as np

    from . import preset, resolve_device
    from .shard import ShardedProblem

    dev = resolve_device(spec.get("device", "cuda"))
    out = Path(spec["out"])
    with rank_group(timing=spec.get("timing", False)) as comm:
        cfg = preset(spec["preset"], **spec.get("config", {}))
        t0 = time.perf_counter()                  # set-up: mesh to state
        sp = ShardedProblem.from_config(cfg, comm.ndev, device=dev,
                                        lmax=spec.get("lmax"), comm=comm,
                                        mesh=_mesh(spec))
        y0, phi0 = sp.initial_state()
        _sync(dev)
        setup = time.perf_counter() - t0
        iters, walls = [], []
        comm.calls.clear()
        comm.exchange_seconds()
        _counts(zero=True)
        t_step = [time.perf_counter()]

        def record(t, y, aux):
            _sync(dev)
            now = time.perf_counter()
            walls.append(now - t_step[0])
            t_step[0] = now
            iters.append(aux.stats.max_iters)

        _, y, phi = sp.run(n_steps=spec["steps"], state=(y0, phi0),
                           record=record)
        _sync(dev)
        counts = _counts()
        calls = dict(comm.calls)
        exch = comm.exchange_seconds() if comm.timing else None
        sp.check_state(y, phi)
        stats = sp.last_solver_stats
        phi_g = sp.phi_global(phi)
        probe = _shift_probe(sp, comm) if comm.timing else {}
        rank = dict(rank=comm.rank, world=comm.ndev, setup_s=setup,
                    step_walls_s=walls, max_iters_per_step=iters,
                    total_iters=stats.total_iters,
                    unconverged=bool(stats.unconverged), launches=counts,
                    collectives=calls, exchange_s=exch, **probe,
                    lmax=sp.pmg.lmax if sp.pmg is not None else None,
                    dofs=sp.prob.space.n_dofs)
        (out / f"rank{comm.rank}.json").write_text(json.dumps(rank))
        if phi_g is not None:
            np.savez(out / "result.npz", y=y.detach().cpu().numpy(),
                     phi=phi_g)


def run_spec(spec: dict, world: int, out, timeout: float = 600.0) -> dict:
    """Run the rank program on ``spec`` over ``world`` ranks and read what
    they wrote: ``{"ranks": [rank0, ...], "y": ..., "phi": ...}``. ``spec``:
    ``preset`` and ``config`` (its keyword arguments), ``steps``,
    ``device``, and optionally ``lmax``, ``mesh`` (``{"fn":
    "module:function", "kwargs": {...}}``) and ``timing``."""
    import numpy as np

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    for f in [*out.glob("rank*.json"), out / "result.npz"]:
        f.unlink(missing_ok=True)
    spec = {**spec, "out": str(out.resolve())}
    path = out / "spec.json"
    path.write_text(json.dumps(spec))
    run_ranks(["-m", "lpfem_torch.dist", str(path.resolve())], world,
              timeout)
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(world)]
    with np.load(out / "result.npz") as res:
        return {"ranks": ranks, "y": res["y"], "phi": res["phi"]}


if __name__ == "__main__":
    rank_main(json.loads(Path(sys.argv[1]).read_text()))
