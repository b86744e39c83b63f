"""Profiling and failure detection.

Counterpart of ``lpfem.profiling``. The reference's only tracing is
``MPI_Barrier`` + ``MPI_Wtime`` around step loops
(``Convergence_and_Scaling/ss.cpp:255-276``). Here:

- :class:`PhaseTimer` — wall-clock phases; ``block_on`` waits for the work
  queued on the device of the tensors it is given
  (``torch.cuda.synchronize``, the barrier analogue) before reading the
  clock.
- :func:`trace` — a ``torch.profiler`` trace (host and, on a GPU, device
  activity) around a block, written as a Chrome / Perfetto trace file.
- :func:`check_finite` — raise with context on non-finite values.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import numpy as np
import torch

__all__ = ["PhaseTimer", "trace", "check_finite", "block_until_ready"]


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


class PhaseTimer:
    """Accumulating wall-clock phase timer (``lpfem.profiling.PhaseTimer``).

    ``phase(name, block_on=x)`` waits for the device work behind ``x``
    before reading the clock, the single-program analogue of the
    reference's ``MPI_Barrier``-bracketed ``MPI_Wtime``
    (``ss.cpp:255-272``).
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                block_until_ready(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def time(self, name: str, fn, *args, **kw):
        with self.phase(name):
            out = fn(*args, **kw)
            block_until_ready(out)
        return out

    def report(self) -> str:
        lines = [f"{'phase':24s} {'calls':>6s} {'total[s]':>10s} {'mean[ms]':>10s}"]
        for k in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[k], self.counts[k]
            lines.append(f"{k:24s} {c:6d} {t:10.3f} {1e3 * t / max(c, 1):10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str = "chiprun_out/lpfem-trace"):
    """``torch.profiler`` trace around a block: host activity, and device
    activity where a GPU is present; written to ``logdir/trace.json``
    (Chrome / Perfetto format). Yields the profiler."""
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
