"""lpfem_torch.profiling: the program's spans, stream markers and sync
counters on the CPU.

- Off (no profiler recording): a span is a shared null context; the record
  stays empty even with ``record_function`` made to raise.
- On, under a CPU profile, over two RK4 steps of a tiny mixed problem with
  the p-multigrid: the counts of the CG iterations, V-cycles and host reads
  against the solves' own ``SolveInfo``; the Chrome trace's nesting; the
  answers bit for bit as with recording off.
- The self-time arithmetic on synthetic nested spans and details (a fake
  clock), with the details' markers off and on.
- ``Record.first``: the first of two traced passes alone.
- ``multigrid.lower``, once a V-cycle: the V-cycle's self time is then the
  top level's stages (a clock that ticks once a reading), and the reader
  ``multigrid.fine_level_share`` reads it, and nothing without the span.
- The benchmark's span readers on tiny traced ``run_cell``s, one record a
  run.
- A sharded run records the same stage, solve and V-cycle spans and the
  level details as a single-device one (the V-cycle is the same code).
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lpfem_torch
from lpfem_torch import profiling, solvers


def _tiny_problem():
    cfg = lpfem_torch.preset("scaling_base", nx=4, nz=1, ref_levels=0,
                             order=2, dtype="mixed", precond="pmg",
                             cheb_degree=1, cg_rtol_sq=1e-10,
                             ir_inner_rtol_sq=1e-3)
    prob = lpfem_torch.Problem(cfg, device="cpu")
    return prob, prob.initial_state()


def test_spans_off_record_nothing(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function called with no profiler")

    # the annotation a span enters, and record_function itself
    monkeypatch.setattr(profiling, "_annotate", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    assert not torch._C._autograd._profiler_enabled()
    assert profiling.span("a") is profiling.span("b") is profiling.step()
    prob, (y0, phi0) = _tiny_problem()
    _, y, phi = prob.run(n_steps=2, state=(y0, phi0))
    prob.check_state(y, phi)
    rec = profiling.record()
    assert rec.table() == {} and rec.syncs == {} and rec.steps == 0
    assert prob.last_solver_stats.n_solves == 8


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Two steps off, then the same two steps under ``profiling.trace``,
    each inner CG's iterations and the V-cycles it ran beside them."""
    prob, (y0, phi0) = _tiny_problem()
    _, y_off, phi_off = prob.run(n_steps=2, state=(y0.clone(), phi0.clone()))
    inner = []
    pcg = solvers.pcg

    def counted(*a, **k):
        v0 = profiling.record().totals("multigrid.vcycle").calls
        res = pcg(*a, **k)
        inner.append((res.iters,
                      profiling.record().totals("multigrid.vcycle").calls
                      - v0))
        return res

    logdir = tmp_path_factory.mktemp("trace")
    solvers.pcg = counted
    try:
        with profiling.trace(str(logdir)):
            _, y_on, phi_on = prob.run(n_steps=2,
                                       state=(y0.clone(), phi0.clone()))
    finally:
        solvers.pcg = pcg
    trace = json.loads((logdir / "trace.json").read_text())
    return dict(rec=profiling.record(), stats=prob.last_solver_stats,
                inner=inner, trace=trace, y=(y_off, y_on),
                phi=(phi_off, phi_on))


def test_counts_match_the_solves(traced):
    rec, stats = traced["rec"], traced["stats"]
    tab = rec.table()
    assert rec.steps == 2 and stats.n_solves == 8
    assert tab["surface.solve"].calls == tab["surface.stage"].calls == 8
    assert tab["solvers.cg_iteration"].calls == stats.total_iters > 0
    # every site's reads: the solves' own count and one guard read a step
    assert rec.syncs["timestep.guard"] == 2
    assert sum(rec.syncs.values()) == stats.syncs + 2
    assert rec.syncs["surface.verdict"] == 8
    # the preconditioner once before each inner CG's loop and once an
    # iteration
    assert traced["inner"] and all(v == it + 1 for it, v in traced["inner"])
    assert tab["multigrid.vcycle"].calls == sum(
        it + 1 for it, _ in traced["inner"])
    assert {k for k in tab if k.startswith("multigrid.")} == {
        "multigrid.vcycle", "multigrid.L0.presmooth",
        "multigrid.L0.residual", "multigrid.L0.restrict",
        "multigrid.L0.prolong", "multigrid.L0.postsmooth",
        "multigrid.lower", "multigrid.coarse"}
    assert tab["multigrid.coarse"].calls == tab["multigrid.vcycle"].calls
    assert tab["multigrid.lower"].calls == tab["multigrid.vcycle"].calls
    assert tab["solvers.ir_pass"].calls > tab["surface.solve"].calls
    details = {"solvers.exit_test", "operators.gather", "operators.fold"} | {
        k for k in tab if k.startswith("multigrid.L")}
    assert rec.device.type == "cpu"
    for k, t in tab.items():
        # on the CPU the markers read the host clock; the details take
        # none unless asked
        assert t.stream == (0.0 if k in details else t.host), k
        assert t.host_self >= 0.0 and t.stream_self >= 0.0
    lines = rec.report().splitlines()
    assert lines[0].split()[:2] == ["span", "calls"]
    assert lines[-1].split() == ["steps", "2"]


def test_trace_nests_the_spans(traced):
    chain = ["multigrid.vcycle", "solvers.cg_iteration", "surface.solve",
             "timestep.step"]
    spans = {k: [] for k in chain}
    for e in traced["trace"]["traceEvents"]:
        if e.get("ph") == "X" and e.get("name") in spans:
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))

    def inside(a, b):
        return b[0] <= a[0] and a[1] <= b[1]

    found = 0
    for v in spans[chain[0]]:
        cur = v
        for outer in chain[1:]:
            up = [o for o in spans[outer] if inside(cur, o)]
            if not up:
                break
            cur = up[0]
        else:
            found += 1
    assert found > 0
    assert len(spans["timestep.step"]) == 2


def test_answers_bit_for_bit_with_recording_on(traced):
    y_off, y_on = traced["y"]
    phi_off, phi_on = traced["phi"]
    assert torch.equal(y_off, y_on) and torch.equal(phi_off, phi_on)


L0_STAGES = ("presmooth", "residual", "restrict", "prolong", "postsmooth")


def test_sharded_run_records_the_vcycle(tmp_path):
    """One step over two stacked shards of a tiny p-multigrid tank with
    h-levels: a V-cycle's coarse solve and descent once each, every level
    above the bottom one its five details once a V-cycle, and the stage and
    solve spans once a stage."""
    from lpfem_torch.shard import ShardedProblem

    cfg = lpfem_torch.preset("scaling_base", nx=8, ny=2, nz=4, order=2,
                             precond="pmg", h_coarsen_min_dofs=0,
                             cg_rtol_sq=1e-16)
    sp = ShardedProblem.from_config(cfg, 2, device="cpu")
    n_lv = len(sp.pmg.levels)
    assert n_lv > 2
    with profiling.trace(str(tmp_path)):
        sp.run(n_steps=1)
    rec = profiling.record()
    tab = rec.table()
    vc = tab["multigrid.vcycle"].calls
    assert rec.steps == 1 and vc > 0
    assert tab["multigrid.coarse"].calls == tab["multigrid.lower"].calls == vc
    assert {k for k in tab if k.startswith("multigrid.L")} == {
        f"multigrid.L{i}.{s}" for i in range(n_lv - 1) for s in L0_STAGES}
    assert all(tab[f"multigrid.L{i}.{s}"].calls == vc
               for i in range(n_lv - 1) for s in L0_STAGES)
    assert tab["surface.stage"].calls == tab["surface.solve"].calls == 4
    assert tab["solvers.cg_iteration"].calls == \
        sp.last_solver_stats.total_iters
    profiling.reset()


def test_vcycle_self_time_is_the_top_level(monkeypatch):
    """``multigrid.lower`` around the descent below the top level, once a
    V-cycle: with the details unmarked (a benchmark run), the V-cycle's
    self stream time is the top level's five stages, to one reading of the
    clock at each of the seven boundaries between the V-cycle's markers
    and its children's (a clock that ticks once a reading), and its
    inclusive time is its self time and the descent's."""
    ticks = iter(range(10 ** 9))
    monkeypatch.setattr(profiling, "_clock", lambda: float(next(ticks)))
    prob, (y0, phi0) = _tiny_problem()
    with profile(activities=[ProfilerActivity.CPU]):
        prob.run(n_steps=1, state=(y0, phi0))
    tab = profiling.record().table()
    vc, low = tab["multigrid.vcycle"], tab["multigrid.lower"]
    assert vc.calls > 0 and low.calls == vc.calls
    assert tab["multigrid.coarse"].calls == vc.calls
    stages = sum(tab[f"multigrid.L0.{s}"].host for s in L0_STAGES)
    assert all(tab[f"multigrid.L0.{s}"].calls == vc.calls
               for s in L0_STAGES)
    assert vc.stream_self == stages + 7 * vc.calls
    assert vc.stream == vc.stream_self + low.stream
    # the descent holds the coarse solve; the CG's self time leaves out the
    # whole V-cycle as before
    assert low.stream >= tab["multigrid.coarse"].stream > 0
    profiling.reset()


@pytest.mark.parametrize("marked", [False, True])
def test_self_time_arithmetic(monkeypatch, marked):
    ticks = iter([0.0, 1.0, 4.0, 5.0, 6.0, 8.0, 10.0, 12.0])
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
    monkeypatch.setattr(profiling, "_details", marked)
    rec = profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("a"):
            with profiling.detail("b"):
                pass
            with profiling.span("c"):
                with profiling.span("d"):
                    profiling.sync("d.read")
    tab = rec.table()
    assert {k: (t.calls, t.host, t.host_self) for k, t in tab.items()} == {
        "a": (1, 12.0, 4.0), "b": (1, 3.0, 3.0), "c": (1, 5.0, 3.0),
        "d": (1, 2.0, 2.0)}
    # the stream clock: the host's on the CPU; an unmarked detail's time
    # stays in its parent's self time
    stream = {k: (t.stream, t.stream_self) for k, t in tab.items()}
    assert stream == {"a": (12.0, 4.0 if marked else 7.0),
                      "b": (3.0, 3.0) if marked else (0.0, 0.0),
                      "c": (5.0, 3.0), "d": (2.0, 2.0)}
    assert rec.syncs == {"d.read": 1} and rec.steps == 0
    profiling.reset()


def test_record_first_is_the_first_pass():
    rec = profiling.reset()
    calls = []
    for n in (2, 3):            # two traced passes of 2 and 3 steps
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(n):
                with profiling.step(torch.device("cpu")):
                    with profiling.span("s"):
                        profiling.sync("r")
        calls.append(rec.totals("s").calls)
    assert rec.steps == 5 and calls == [2, 5]
    first = rec.first(2)
    assert first.steps == 2 and first.totals("s").calls == 2
    assert first.syncs == {"r": 2} and rec.syncs == {"r": 5}
    assert rec.first(5) is rec and rec.first(7) is rec
    assert first.totals("timestep.step").stream <= \
        rec.totals("timestep.step").stream
    profiling.reset()


NEW_READERS = ("multigrid.vcycle_share", "solvers.cg_self_share",
               "operators.gather_fold_share", "timestep.outside_solve_share",
               "timestep.program_syncs_per_step")


def test_readers_on_tiny_traced_runs_one_record_each():
    from benchmark.checks.tiny import tiny_cell
    from benchmark.harness import load_reader, run_cell

    readers = {n: load_reader(n) for n in NEW_READERS}
    for name in ("cylinder_p4.f64", "ss_tank_p4.refs2"):
        # one traced step at order 1: the p-multigrid is its coarse solve
        cell = tiny_cell(name)
        cell.traffic["trace_steps"] = 1
        cell.config["params"]["order"] = 1
        cell.config["guarantees"]["order"] = 1
        rec = run_cell(cell, 2 ** 40 + 3, 1.0, True, torch.device("cpu"),
                       log=lambda m: None)
        got = {n: r({"device_steps": 1}) for n, r in readers.items()}
        record = profiling.record()
        # only this run's census pass (the CPU has no device pass)
        assert record.steps == 1
        assert all(isinstance(v, float) for v in got.values()), got
        for n, v in got.items():
            if n.endswith("_share"):
                assert 0.0 <= v <= 100.0, (n, v)
        # the element path gathers and folds; the lattice path does not
        element = name.startswith("cylinder")
        assert (got["operators.gather_fold_share"] > 0.0) == element
        # no trajectory completes in one step, so no check_state read: the
        # solves' reads and the guard, as the older metric counts them
        assert got["timestep.program_syncs_per_step"] == sum(
            record.syncs.values()) == rec["metrics"][
                "timestep.host_syncs_per_step"]["value"]
        for n in ("multigrid.vcycle_share", "solvers.cg_self_share",
                  "timestep.outside_solve_share",
                  "timestep.program_syncs_per_step"):
            assert rec["metrics"][n]["value"] == got[n]


def test_fine_level_share_reads_the_top_level_alone():
    """``multigrid.fine_level_share`` on a tiny traced run of the order-8
    cell (cut to order 2: levels p = 2 and 1): above 0 and below the whole
    V-cycle's share; nothing on a record without ``multigrid.lower`` (a
    program that lacks the span) or without a record."""
    from benchmark.checks.tiny import tiny_cell
    from benchmark.harness import load_reader, run_cell

    fine = load_reader("multigrid.fine_level_share")
    cell = tiny_cell("tank_p8.f64_refs2")
    cell.traffic["trace_steps"] = 1
    rec = run_cell(cell, 2 ** 40 + 5, 1.0, True, torch.device("cpu"),
                   log=lambda m: None)
    got = rec["metrics"]["multigrid.fine_level_share"]["value"]
    assert got == fine({"device_steps": 1})
    whole = load_reader("multigrid.vcycle_share")({"device_steps": 1})
    assert 0.0 < got < whole <= 100.0

    rec = profiling.reset()
    assert fine({"device_steps": 1}) is None
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.step(torch.device("cpu")):
            with profiling.span("multigrid.vcycle"):
                pass
    assert rec.steps == 1 and fine({"device_steps": 1}) is None
    profiling.reset()
