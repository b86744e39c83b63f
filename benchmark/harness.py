"""One run of one cell: build the program, warm up, measure a window, check
the window's answers against the plain reference, print the result.

Everything that belongs to one cell is data found by name:

- ``BENCHMARK.json`` names the cell's configuration, traffic and metrics;
- ``configs/<config>.json``: how the program is built (``program``: a preset
  of ``lpfem_torch`` or the diffraction study's ``build_problem``), its
  parameters, the guarantees a run is held to, the control (its own path
  one precision lower) and the wave the initial data follows;
- ``traffic/<traffic>.json``: the run's protocol: the scale it picks, K
  steps a trajectory, the steps of a traced run, how many early and late
  answers the check samples, and the ranges the seed draws the initial
  data from;
- ``cells/<workload>.json``: the limits of the numbers the check compares,
  and how many of a trajectory's first steps count as early;
- ``metrics/<metric>.py``: a reader ``read(ctx) -> float | None`` per metric.

The window runs trajectories of K RK4 steps through ``Problem.run``, each
from the same seeded initial state, and closes at the first step boundary
after ``--seconds`` (``--trace 1``: after the traffic's ``trace_steps``).
Each step ends in the program's own finiteness read, a host sync, after
which ``Problem.run`` calls the benchmark's per-step hook; the hook reads
the clock, keeps answers for the check (input state, output state,
last-stage potential) and closes the window by raising. The answers kept
are the window's first step, a seeded reservoir sample of the other early
steps of a trajectory (its first ``early_steps``, whose solves start far
from their answers) and a seeded reservoir sample of its later steps; the
check holds the two groups to limits of their own.
Every Laplace solve's verdict is counted through a thin wrapper of
``FreeSurfaceOperator.solve_laplace``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lpfem")

__all__ = ["Cell", "load_cell", "program_params", "initial_state", "Window",
           "program_layout", "run_cell", "forbidden_modules"]


# ------------------------------------------------------------------ the cell
@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    early_steps: int
    end_to_end: list
    per_layer: list


def _for_cell(entries, name):
    return [m for m in entries if "workloads" not in m
            or name in m["workloads"]]


def load_cell(name: str, spec: dict | None = None) -> Cell:
    """The cell ``name`` of ``spec`` (default: ``BENCHMARK.json``) with its
    files."""
    if spec is None:
        spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    cell_file = HERE / "cells" / f"{name}.json"
    own = json.loads(cell_file.read_text()) if cell_file.exists() else {}
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=own.get("limits", {}),
                early_steps=int(own.get("early_steps", 1)),
                end_to_end=_for_cell(spec["end_to_end"], name),
                per_layer=_for_cell(spec["per_layer"], name))


def program_params(cell: Cell) -> tuple[dict, dict]:
    """(build parameters, guarantees) of the cell: the configuration's,
    with the traffic's scale. The traffic may change only the
    configuration's ``scale_keys``."""
    c = cell.config
    params, guar = dict(c["params"]), dict(c["guarantees"])
    scale = cell.traffic.get("scale", {})
    bad = set(scale) - set(c.get("scale_keys", []))
    if bad:
        raise ValueError(f"traffic may not change {sorted(bad)}")
    params.update(scale)
    return params, guar


def build_program(cell: Cell, device, params: dict, guar: dict):
    """The program's ``Problem`` for the cell, held to its guarantees."""
    import lpfem_torch

    kind = cell.config["program"]
    if kind == "preset":
        prob = lpfem_torch.Problem(
            lpfem_torch.preset(cell.config["preset"], **params), device)
    elif kind == "diffraction":
        from lpfem_torch.experiments.diffraction import build_problem
        prob = build_problem(device, **params)
    else:
        raise ValueError(f"unknown program {kind!r}")
    for key, want in guar.items():
        if key == "steps_per_period":
            got = prob.wave.T / prob.dt
            ok = abs(got - want) <= 1e-9 * want
        else:
            got = getattr(prob.cfg, key)
            ok = got == want
        if not ok:
            raise ValueError(f"the program runs {key} = {got!r}, the "
                             f"configuration states {want!r}")
    return prob


# ---------------------------------------------------------- the initial data
def wave_numbers(wave: dict) -> tuple[float, float]:
    """(k, omega) of the configuration's wave, from the linear dispersion
    relation omega^2 = g k tanh(k h)."""
    g = float(wave["g"])
    if wave["by"] == "modes":
        k = 2.0 * math.pi * float(wave["m"]) / float(wave["Lx"])
        kh = k * float(wave["depth"])
    elif wave["by"] == "wavelength":
        k = 2.0 * math.pi / float(wave["wavelength"])
        kh = float(wave["kh"])
    else:
        raise ValueError(f"unknown wave {wave['by']!r}")
    return k, math.sqrt(g * k * math.tanh(kh))


def draw(seed: int, ranges: dict) -> dict:
    """The seed's initial-data parameters: each drawn uniformly from its
    range, in the order of the names."""
    rng = np.random.default_rng(seed % 2 ** 63)
    return {k: float(rng.uniform(*ranges[k])) for k in sorted(ranges)}


def surface_values(xy: np.ndarray, wave: dict, amp: float, phase: float):
    """(eta, phi_fs) of the seeded linear wave at the nodes ``xy``:
    amp H/2 cos(k x - phase) and amp H/2 (g / omega) sin(k x - phase)."""
    k, omega = wave_numbers(wave)
    arg = k * xy[:, 0] - phase
    a = amp * 0.5 * float(wave["H"])
    return a * np.cos(arg), a * float(wave["g"]) / omega * np.sin(arg)


def initial_state(prob, cell: Cell, seed: int):
    """(y0, phi0, params): the seeded surface state ``[eta; phi_fs]`` on the
    program's surface nodes, and the volume warm start, zero but for the
    surface values (the program's own convention for a cold start)."""
    import torch

    par = draw(seed, cell.traffic["initial"])
    xy = np.asarray(prob.surf.node_coords)[:, :2]
    eta, pfs = surface_values(xy, cell.config["wave"], par["amplitude"],
                              par["phase"])
    y0 = torch.tensor(np.concatenate([eta, pfs])).to(prob.device, prob.dtype)
    phi0 = torch.zeros(prob.space.n_dofs, dtype=prob.dtype,
                       device=prob.device)
    phi0[prob.ess] = y0[prob.surf.n_dofs:]
    return y0, phi0, par


# ---------------------------------------------------------------- the window
class _Closed(Exception):
    """Raised by the per-step hook to close the window."""


@dataclass
class Sample:
    step: int                   # in the window
    j: int                      # in its trajectory
    t: float
    y_in: object
    y_out: object
    phi_out: object


@dataclass
class Window:
    """Trajectories of ``K`` steps from ``(y0, phi0)`` until ``seconds``
    have passed or ``max_steps`` steps are done, whichever comes first.
    Keeps the first step, ``n_early - 1`` other steps among each
    trajectory's first ``early`` and ``n_late`` among the rest."""
    prob: object
    y0: object
    phi0: object
    K: int
    seed: int
    early: int
    n_early: int
    n_late: int
    seconds: float | None = None
    max_steps: int | None = None
    span: bool = False
    steps: int = 0
    solves: int = 0
    failed: int = 0
    inner_iters: int = 0
    solver_syncs: int = 0
    trajectories: int = 0
    diverged: bool = False
    elapsed: float = 0.0
    samples: list = field(default_factory=list)
    step_s: list = field(default_factory=list)

    def _solve_counter(self, solve):
        from torch.profiler import record_function

        def counted(phi_fs, phi_warm):
            ctx = (record_function("surface.solve_laplace") if self.span
                   else contextlib.nullcontext())
            with ctx:
                phi, info = solve(phi_fs, phi_warm)
            self.solves += 1
            self.failed += int(not info.converged)
            self.inner_iters += int(info.iters)
            self.solver_syncs += int(info.syncs)
            return phi, info

        return counted

    def _keep(self, group: str, make) -> None:
        """Seeded reservoir sampling (algorithm R) within ``group``."""
        kept, cap = self._kept[group], self._cap[group]
        seen = self._seen[group]
        self._seen[group] = seen + 1
        if len(kept) < cap:
            kept.append(make())
        elif cap > 0:
            r = int(self._rng.integers(0, seen + 1))
            if r < cap:
                kept[r] = make()

    def _hook(self, t, y, aux):
        now = time.perf_counter()
        self.step_s.append(now - self._last)
        self._last = now
        n, j = self.steps, self._j
        self.steps += 1
        self._j += 1
        t_in, y_in = self._prev

        def make():
            return Sample(n, j, t_in, y_in, y.clone(), aux.phi.clone())

        if n == 0:
            self._first = make()
        else:
            self._keep("early" if j < self.early else "late", make)
        self._prev = (t, y.clone())
        if ((self.seconds is not None and now - self._t0 >= self.seconds)
                or (self.max_steps is not None
                    and self.steps >= self.max_steps)):
            self.elapsed = now - self._t0
            raise _Closed

    def run(self) -> "Window":
        """Run the window; returns itself with the counts filled in."""
        prob = self.prob
        fso = prob.fso
        self._rng = np.random.default_rng((self.seed + 1) % 2 ** 63)
        self._cap = {"early": self.n_early - 1, "late": self.n_late}
        self._kept = {"early": [], "late": []}
        self._seen = {"early": 0, "late": 0}
        self._first = None
        fso.solve_laplace = self._solve_counter(fso.solve_laplace)
        self._t0 = time.perf_counter()
        try:
            with warnings.catch_warnings():
                # the window counts every unconverged solve itself
                warnings.simplefilter("ignore", RuntimeWarning)
                while True:
                    self._last = time.perf_counter()
                    self._prev = (0.0, self.y0)
                    self._j = 0
                    self.trajectories += 1
                    _, y, phi = prob.run(
                        n_steps=self.K, t0=0.0,
                        state=(self.y0.clone(), self.phi0.clone()),
                        record=self._hook)
                    try:
                        prob.check_state(y, phi)
                    except FloatingPointError:
                        self.diverged = True
                        self.elapsed = time.perf_counter() - self._t0
                        break
        except _Closed:
            pass
        finally:
            del fso.solve_laplace            # the class's method again
        first = [self._first] if self._first is not None else []
        self.samples = sorted(first + self._kept["early"]
                              + self._kept["late"], key=lambda s: s.step)
        return self


# ------------------------------------------------------------------- readers
def load_reader(name: str):
    """``read`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries, ctx: dict) -> dict:
    out = {}
    for m in entries:
        v = load_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


class Census:
    """Counts the calls of the kernel wrappers that the program's operators
    make, by the shape and dtype of each call, while installed (the traced
    window only); ``None`` where the operators no longer call a wrapper of
    that name."""

    TARGETS = {"sep_apply": lambda x, bands, *a, **k: (
                   "sep_apply", (bands[0].shape[0] - 1) // 2,
                   tuple(reversed(x.shape)), x.element_size()),
               "pa_apply_element": lambda u, G6q, B, D: (
                   "pa_apply_element", B.shape[1] - 1, u.shape[0],
                   B.shape[0], u.element_size())}

    def __init__(self):
        self.counts = {}
        self._saved = {}

    def __enter__(self):
        from lpfem_torch import operators
        for name, key in self.TARGETS.items():
            orig = getattr(operators, name, None)
            if orig is None:
                continue
            self._saved[name] = orig

            def wrapped(*a, _orig=orig, _key=key, **k):
                kk = _key(*a, **k)
                self.counts[kk] = self.counts.get(kk, 0) + 1
                return _orig(*a, **k)

            setattr(operators, name, wrapped)
        return self

    def __exit__(self, *exc):
        from lpfem_torch import operators
        for name, orig in self._saved.items():
            setattr(operators, name, orig)
        return False

    def calls(self, kind: str) -> list | None:
        if kind not in self._saved:
            return None
        return [(k[1:], n) for k, n in self.counts.items() if k[0] == kind]


def _launch_counters() -> dict:
    from lpfem_torch.kernels import pa_apply, sep_apply
    return {"sep_apply": dict(getattr(sep_apply, "LAUNCHES_BY_P", {})),
            "pa_apply_element": dict(getattr(pa_apply, "LAUNCHES_BY_P", {}))}


def _delta(after: dict, before: dict) -> dict:
    return {k: {p: n - before[k].get(p, 0) for p, n in v.items()
                if n - before[k].get(p, 0)} for k, v in after.items()}


# volume dofs above which the layout check reads a seeded sample of a
# million: all 17,105,920 of refs 3 take ~1 GB of host coordinates
FULL_LAYOUT_BELOW = 4_000_000


def program_layout(prob, seed: int) -> dict:
    """Where the program puts its values: the surface nodes' (x, y) in its
    surface order, and the (x, y, z) of its volume dofs (all of them, or a
    seeded sample of a million on a larger space), for the check to match
    against the reference's own numbering."""
    n = int(prob.space.n_dofs)
    if n <= FULL_LAYOUT_BELOW:
        idx = np.arange(n)
    else:
        rng = np.random.default_rng((seed + 2) % 2 ** 63)
        idx = np.sort(rng.choice(n, 1_000_000, replace=False))
    return {"n_dofs": n,
            "surf_xy": np.asarray(prob.surf.node_coords)[:, :2].copy(),
            "vol_idx": idx,
            "vol_xyz": np.asarray(prob.space.node_coords)[idx].copy()}


# ------------------------------------------------------------------- the run
def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``lpfem_torch`` is not ``lpfem``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def process_seconds() -> float:
    """Seconds since this process started (``/proc``; 10 ms ticks)."""
    start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                .split()[19])
    up = float(Path("/proc/uptime").read_text().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             log=print) -> dict:
    """One run of ``cell`` on ``device``: the result record (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ..., ``checks``
    last). The caller has checked for the chips."""
    import torch

    from . import compare

    params, guar = program_params(cell)
    t = cell.traffic
    phases = {"start": process_seconds()}
    build_s = 0.0
    if device.type == "cuda":
        from lpfem_torch.kernels import _build
        names = [n for n in cell.config.get("kernel_sources", [])
                 if (_build.CSRC_DIR / f"{n}.cu").exists()]
        t0 = time.perf_counter()
        _build.build_libraries(names)
        build_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(device)
    phases["build"] = build_s
    t0 = time.perf_counter()
    prob = build_program(cell, device, params, guar)
    _sync(device)
    phases["program"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    y0, phi0, par = initial_state(prob, cell, seed)
    _sync(device)
    phases["initial"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        prob.run(n_steps=1, t0=0.0, state=(y0.clone(), phi0.clone()))
    _sync(device)
    phases["warmup"] = time.perf_counter() - t0
    setup_s = process_seconds()
    log(f"set-up {setup_s:.3f} s (build {build_s:.3f} s), "
        f"{prob.space.n_dofs} dofs, initial data {par}, phases "
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))

    K = int(t["steps_per_trajectory"])
    early = cell.early_steps
    n_early, n_late = int(t["check_early"]), int(t["check_late"])

    def window(**kw):
        return Window(prob, y0, phi0, K, seed, early, n_early, n_late,
                      **kw).run()

    dev_sum = cen_sum = census = launches = None
    trace_step_s = None
    if not trace:
        wins = [window(seconds=seconds)]
    else:
        from torch.profiler import ProfilerActivity, profile, record_function

        from .tracing import WINDOW_SPAN, device_summary, summarize
        n_tr = int(t["trace_steps"])
        # pass 0, untraced: the wall of a step as the host runs it when
        # nothing is recorded (tracing slows the host's launches)
        w0 = window(max_steps=n_tr)
        # pass 1: the device's activity alone (no host events, nothing
        # wrapped): busy time, kernels
        if device.type == "cuda":
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                w1 = window(max_steps=n_tr)
            dev_sum = device_summary(prof, w1.elapsed)
            del prof
        else:
            w1 = window(max_steps=n_tr)
        # pass 2: host and device, the census of the kernel wrappers'
        # calls, spans: the rooflines and the idle gaps by host activity
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        before = _launch_counters()
        with Census() as census, profile(activities=acts) as prof:
            with record_function(WINDOW_SPAN):
                w2 = window(max_steps=n_tr, span=True)
        launches = _delta(_launch_counters(), before)
        cen_sum = summarize(prof, w2.elapsed)
        del prof
        wins = [w1, w2, w0]
        trace_step_s = {k: w.elapsed / max(w.steps, 1) for k, w in
                        (("untraced", w0), ("device_pass", w1),
                         ("census_pass", w2))}
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    for win in wins:
        log(f"window {win.elapsed:.3f} s: {win.steps} steps in "
            f"{win.trajectories} trajectories, {win.solves} solves, "
            f"{win.failed} unconverged, {win.inner_iters} inner iterations")

    def total(key):
        return sum(getattr(w, key) for w in wins)

    ctx = dict(cell=cell.name, params=params, n_dofs=int(prob.space.n_dofs),
               setup_s=setup_s, build_s=build_s, elapsed_s=total("elapsed"),
               steps=total("steps"), solves=total("solves"),
               failed=total("failed"), inner_iters=total("inner_iters"),
               solver_syncs=total("solver_syncs"),
               diverged=any(w.diverged for w in wins),
               guard_syncs=total("steps"), device_steps=wins[0].steps,
               trace_step_s=trace_step_s, census=census, launches=launches,
               device_trace=dev_sum, census_trace=cen_sum)
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, ctx)

    # the check: the program's layout and answers against the reference,
    # once the program's state is freed
    layout = program_layout(prob, seed)
    samples = [smp for w in wins for smp in w.samples]
    dtype, step_s = prob.dtype, [v for w in wins for v in w.step_s]
    del prob, wins, win, y0, phi0      # win: the last of the log's loop
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, correct = compare.check(cell, params, layout, samples, ctx,
                                    device, log=log)

    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    rec = {"correct": bool(correct), "attempted": ctx["solves"],
           "failed": ctx["failed"], "metrics": metrics, "device": dev}
    if trace:
        # busy time and device operations from the device pass (on the
        # CPU, which has none, from the census pass: nothing)
        busy = dev_sum if dev_sum is not None else cen_sum
        dev["busy_s"] = busy.busy_s
        dev["window_s"] = busy.window_s
        rec["breakdown"] = {"device_ops": busy.device_ops,
                            "idle_gaps": cen_sum.idle_gaps}
    rec["run"] = {"seed": seed, "steps": ctx["steps"],
                  "elapsed_s": ctx["elapsed_s"], "build_s": build_s,
                  "setup_phases": phases, "trace_step_s": trace_step_s,
                  "initial": par, "state_dtype": str(dtype)[6:],
                  "step_s": [round(v, 4) for v in step_s]}
    rec["checks"] = checks
    return rec
