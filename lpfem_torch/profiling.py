"""Profiling and failure detection.

Counterpart of ``lpfem.profiling``. The reference's only tracing is
``MPI_Barrier`` + ``MPI_Wtime`` around step loops
(``Convergence_and_Scaling/ss.cpp:255-276``). Here:

- :func:`span` — a named layer of the program: the step, the stage, the
  solve, the CG iteration and its applies, the V-cycle, the coarse solve.
  :func:`detail` — a finer part run thousands of times a step: the CG's
  exit test, the V-cycle's level stages, the element gather and fold.
  While no ``torch.profiler`` profile records, either is one check and a
  shared null context: no ``record_function``, no event, no allocation,
  no dict write. While one records, each enters the user annotation of
  ``torch.profiler.record_function`` (so it sits in the profiler's trace,
  on the profiler's clock, beside the kernels it launched) and adds its
  calls and host seconds to the record; a span also puts a marker on the
  device's current stream at its entry and exit (a CUDA event; the host
  clock on the CPU), and so does a detail after :func:`mark_details`. A
  marker costs tens of microseconds under a profile, so a detail takes
  none by default. A device-only profile (``activities=[CUDA]``) turns
  them on too: torch reports it as recording, as it does a host profile;
  it keeps none of the annotations, but the record takes its markers and
  steps.
- :class:`Record` — the program's record of the spans that recorded: per
  name the calls, the host seconds and the stream seconds (the time
  between a span's two markers, resolved at the next step's start or when
  read), each inclusive and self (less the parts its direct child spans
  cover: host seconds less every child's, stream seconds less the marked
  children's); the host reads of the device by site (:func:`sync`,
  counted on the lines that count a solve's ``syncs``); the steps (calls
  of ``timestep.step``), and its totals as they stood at each step's
  start (:meth:`Record.first`: one traced pass of several). Building a
  ``Problem`` starts a fresh one (:func:`reset`); :func:`record` returns
  it and :func:`report` prints it as a table. The stream seconds measure
  what a layer costs the wall: where the host sets the pace, the stream
  waits between the markers for the host's launches; where the device
  does, it runs the layer's kernels back to back between them. Both
  clocks count the profiler's own cost per launch and per span.
- :func:`trace` — a ``torch.profiler`` trace (host and, on a GPU, device
  activity) around a block, written as a Chrome / Perfetto trace file.
- :func:`check_finite` — raise with context on non-finite values.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["span", "detail", "step", "sync", "recording", "mark_details",
           "Record", "Totals", "record", "reset", "report", "trace",
           "check_finite", "block_until_ready"]

STEP = "timestep.step"

# whether a torch.profiler profile is recording (~0.1 us): the one thing a
# span does while none is; a site run thousands of times a step may test it
# itself and take no context at all while it is false
recording = torch._C._autograd._profiler_enabled
# the user annotation that ``torch.profiler.record_function`` enters, by
# torch's own binding (a quarter of record_function's cost)
_annotate = torch._C._autograd._record_function_with_args_enter
_annotate_end = torch._C._autograd._record_function_with_args_exit
_clock = time.perf_counter
# whether the detail spans take stream markers too (mark_details)
_details = False


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def block_until_ready(x):
    """Wait until the devices of the tensors in ``x`` (nested tuples, lists,
    dicts, NamedTuples) have run everything queued on them; returns ``x``."""
    for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return x


class Totals(NamedTuple):
    """One span name's totals in a :class:`Record` (seconds)."""
    calls: int
    host: float
    host_self: float
    stream: float
    stream_self: float


class _Null:
    """The span while nothing records: a shared, empty context."""
    __slots__ = ()

    def __enter__(self):
        pass

    def __exit__(self, exc_type, exc, tb):
        pass


_NULL = _Null()


class Record:
    """The program's record (module docstring), and the context of the span
    being entered while a profiler records (:func:`span`). ``device``: the
    device whose current stream takes the markers, set at the start of
    each step from the step's state (:func:`step`); a CUDA device puts CUDA
    events there, the CPU (or no step yet) reads the host clock instead.

    Markers are CUDA events from a pool: at the start of each step the
    earlier steps' markers, complete since the previous step's finiteness
    read, are resolved and go back to the pool, so a step reuses the
    events of the one before it. The open spans and the markers not yet
    resolved sit in flat lists: a span allocates nothing that outlives
    it."""

    def __init__(self):
        self.device = None
        self._cuda = False
        self._stream = None
        # name -> [calls, host, host_self, stream, stream_self]
        self._acc: dict[str, list] = {}
        self.syncs: dict[str, int] = {}
        # the open spans, innermost last, and the marked ones among them
        self._names: list = []
        self._marked: list = []
        self._handles: list = []
        self._t0: list = []
        self._ev0: list = []
        self._next = (None, None, True)   # (name, args, marked) to enter
        # markers not yet resolved: name, marked parent, entry, exit event
        self._pending: list = []
        self._pool: list = []          # resolved events, to reuse
        # the totals and syncs at each step's start (Record.first)
        self._starts: list = []

    def _use(self, device: torch.device) -> None:
        self.device = device
        self._cuda = device.type == "cuda"
        self._stream = (torch.cuda.current_stream(device) if self._cuda
                        else None)

    # -------------------------------------------------------------- on path
    def _marker(self):
        ev = (self._pool.pop() if self._pool
              else torch.cuda.Event(enable_timing=True))
        ev.record(self._stream)
        return ev

    def __enter__(self):
        name, args, marked = self._next
        self._handles.append(_annotate(name) if args is None
                             else _annotate(name, args))
        self._names.append(name)
        if marked:
            self._marked.append(name)
            self._ev0.append(self._marker() if self._cuda else True)
        else:
            self._ev0.append(None)
        self._t0.append(_clock())

    def __exit__(self, exc_type, exc, tb):
        t1 = _clock()
        names = self._names
        name = names.pop()
        dt = t1 - self._t0.pop()
        self._add(name, names[-1] if names else None, 1, dt)
        self._acc[name][0] += 1
        ev0 = self._ev0.pop()
        if ev0 is not None:
            marked = self._marked
            marked.pop()
            parent = marked[-1] if marked else None
            if ev0 is True:            # the host clock's markers
                self._add(name, parent, 3, dt)
            else:
                self._pending += (name, parent, ev0, self._marker())
        _annotate_end(self._handles.pop())

    def _entry(self, name: str) -> list:
        acc = self._acc[name] = [0, 0.0, 0.0, 0.0, 0.0]
        return acc

    def _add(self, name: str, parent: str | None, i: int, dt: float):
        """Add ``dt`` to ``name``'s inclusive and self total ``i`` (1: host,
        3: stream) and take it from its parent's self total."""
        acc = self._acc.get(name) or self._entry(name)
        acc[i] += dt
        acc[i + 1] += dt
        if parent is not None:
            (self._acc.get(parent) or self._entry(parent))[i + 1] -= dt

    def _resolve(self) -> None:
        """Stream seconds of the spans whose markers are pending (waits for
        the last of them); their events go back to the pool."""
        pending = self._pending
        if not pending:
            return
        pending[-1].synchronize()
        it = iter(pending)
        for name, parent, ev0, ev1 in zip(it, it, it, it):
            self._add(name, parent, 3, ev0.elapsed_time(ev1) * 1e-3)
        self._pool += pending[2::4]
        self._pool += pending[3::4]
        pending.clear()

    def _step_start(self, device) -> None:
        """At a step's start: resolve the earlier steps' markers, keep the
        totals as they stand, and take the markers' device (``device``, the
        step's state's) and its current stream."""
        self._resolve()
        self._starts.append(({k: v[:] for k, v in self._acc.items()},
                             dict(self.syncs)))
        if device is not None:
            self._use(device)

    # ------------------------------------------------------------- reading
    def first(self, n: int) -> "Record":
        """The record of the first ``n`` steps alone: the totals and syncs
        as they stood when step ``n + 1`` started (the whole record where
        it holds no more steps). A run's traced passes follow one another,
        so this is the first pass's ``n`` steps."""
        if n >= self.steps:
            return self
        out = Record()
        out.device = self.device
        acc, syncs = self._starts[n]
        out._acc = {k: v[:] for k, v in acc.items()}
        out.syncs = dict(syncs)
        return out

    def table(self) -> dict[str, Totals]:
        """Every span name's :class:`Totals`."""
        self._resolve()
        return {k: Totals(*v) for k, v in self._acc.items()}

    def totals(self, name: str) -> Totals:
        """``name``'s :class:`Totals` (zeros where it never recorded)."""
        return self.table().get(name, Totals(0, 0.0, 0.0, 0.0, 0.0))

    @property
    def steps(self) -> int:
        """Time steps recorded (calls of ``timestep.step``)."""
        acc = self._acc.get(STEP)
        return acc[0] if acc is not None else 0

    def report(self) -> str:
        """The record as a table: calls, host and stream seconds (inclusive
        and self) by span, the longest stream time first; then the host
        syncs by site and the steps."""
        tab = self.table()
        head = (f"{'span':28s} {'calls':>8s} {'host[s]':>10s} "
                f"{'self[s]':>10s} {'stream[s]':>10s} {'self[s]':>10s}")
        lines = [head]
        for k in sorted(tab, key=lambda k: (-tab[k].stream, -tab[k].host)):
            t = tab[k]
            lines.append(f"{k:28s} {t.calls:8d} {t.host:10.4f} "
                         f"{t.host_self:10.4f} {t.stream:10.4f} "
                         f"{t.stream_self:10.4f}")
        lines.append(f"{'host syncs by site':28s} {'reads':>8s}")
        for k in sorted(self.syncs):
            lines.append(f"{k:28s} {self.syncs[k]:8d}")
        lines.append(f"{'steps':28s} {self.steps:8d}")
        return "\n".join(lines)


_RECORD = Record()


def record() -> Record:
    """The current record."""
    return _RECORD


def reset() -> Record:
    """Start a fresh record and return it; the spans of an earlier run are
    gone."""
    global _RECORD
    _RECORD = Record()
    return _RECORD


def report() -> str:
    """The current record as a table (:meth:`Record.report`)."""
    return _RECORD.report()


def span(name: str):
    """The context of the layer ``name`` (module docstring): a shared null
    context unless a profiler records; stream markers while one does."""
    if not recording():
        return _NULL
    rec = _RECORD
    rec._next = (name, None, True)
    return rec


def detail(name: str):
    """The context of the detail ``name`` (module docstring): as
    :func:`span`, with stream markers only after :func:`mark_details`."""
    if not recording():
        return _NULL
    rec = _RECORD
    rec._next = (name, None, _details)
    return rec


def mark_details(on: bool = True) -> None:
    """Give the detail spans stream markers too (``on``), or none (the
    default): for a split of the V-cycle's stages or of the gather and
    fold on the stream's clock, at tens of microseconds a detail under a
    profile."""
    global _details
    _details = bool(on)


def step(device=None):
    """The span of one time step (``timestep.step``) on ``device``, the
    step's state's: its ``args`` are the step's index in the record, the
    identifier its spans share, and its start resolves the earlier steps'
    markers."""
    if not recording():
        return _NULL
    rec = _RECORD
    rec._step_start(device)
    rec._next = (STEP, str(rec.steps), True)
    return rec


def sync(site: str) -> int:
    """One host read of the device at ``site``: counted in the record while
    a profiler records. Returns 1, for the caller's own count."""
    if recording():
        syncs = _RECORD.syncs
        syncs[site] = syncs.get(site, 0) + 1
    return 1


@contextlib.contextmanager
def trace(logdir: str = "chiprun_out/lpfem-trace"):
    """``torch.profiler`` trace around a block: host activity, and device
    activity where a GPU is present; written to ``logdir/trace.json``
    (Chrome / Perfetto format), with the program's spans beside the
    kernels. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def check_finite(name: str, *arrays) -> None:
    """Raise with context if any array (NumPy or tensor) holds non-finite
    values."""
    for i, a in enumerate(arrays):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        a = np.asarray(a)
        if not np.all(np.isfinite(a)):
            bad = int(np.sum(~np.isfinite(a)))
            raise FloatingPointError(
                f"{name}: array {i} has {bad}/{a.size} non-finite values "
                f"(max finite {np.nanmax(np.where(np.isfinite(a), a, np.nan))})")
