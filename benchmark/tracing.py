"""Reduction of a torch.profiler trace to what the per-layer metrics read.

The trace is read in memory, from the profiler's raw (Kineto) events:

- device events (kernels, copies, memsets) inside the traced window, and the
  union of their intervals: the seconds in which the device was busy;
- each kernel's name and duration, for the kernel readers and for the
  breakdown's ``device_ops`` (time by kernel name, the longest first);
- the gaps between device activity, each put on the innermost host event
  that was running at its midpoint (an ``aten::`` operator, a CUDA runtime
  call, or one of the benchmark's own spans), summed by name for the
  breakdown's ``idle_gaps``.

The window is the benchmark's own span ``WINDOW_SPAN``; events outside it
(the profiler's start-up, the reservoir's last copies) are left out.

``device_summary`` reads a trace that recorded the device's activity alone
(no host events, so the host runs as it does untraced): busy time, kernels
and device operations over the whole trace, which holds the window and
nothing else that runs on the device.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

__all__ = ["WINDOW_SPAN", "TraceSummary", "summarize", "device_summary"]

WINDOW_SPAN = "benchmark.window"

# device work; the other events of the device's track are left out: the
# device-side copies of spans (user annotations) and synchronisation markers
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset", "concurrent kernel")
_SYNC_NAMES = ("", "Event Sync", "Stream Sync", "Stream Wait Event",
               "Context Sync")


@dataclass
class TraceSummary:
    window_s: float                      # the traced window, host clock
    busy_s: float                        # union of device activity
    kernels: list = field(default_factory=list)   # [(name, seconds)]
    n_device_events: int = 0
    device_ops: list = field(default_factory=list)   # [[name, s]] top 10
    idle_gaps: list = field(default_factory=list)    # [[name, s]] top 10


def _kind(ev) -> str:
    """The event's Kineto activity type where this torch reports it."""
    try:
        return str(ev.activity_type()).lower()
    except Exception:       # absent from older torch builds
        return ""


def _on_device(ev) -> bool:
    return "cuda" in str(ev.device_type()).lower()


def _is_work(ev) -> bool:
    """A kernel, copy or memset on the device."""
    if not _on_device(ev) or ev.is_user_annotation() or \
            ev.name() in _SYNC_NAMES:
        return False
    kind = _kind(ev)
    return not kind or kind.startswith(_DEVICE_KINDS)


def short_name(name: str) -> str:
    """A kernel's name without its return type and its parameter list (the
    last parenthesised group; a name such as ``(anonymous namespace)::k``
    keeps its first)."""
    name = re.sub(r"^void ", "", name).strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                return name[:i].strip() or name
    return name


def _union(intervals) -> tuple[float, list]:
    """(total length, merged intervals) of [(start, end)] in ns."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _kernels_and_ops(dev) -> tuple[list, list]:
    """([(kernel name, s)], the ten device operations that took longest)
    of [(start, end, event)]."""
    kernels, by_name = [], {}
    for s, e, ev in dev:
        name = ev.name()
        sec = (e - s) * 1e-9
        if not name.startswith(("Memcpy", "Memset")):
            kernels.append((name, sec))
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + sec
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return kernels, [[k, v] for k, v in device_ops]


def device_summary(prof, window_s: float) -> TraceSummary:
    """The summary of a finished device-only ``torch.profiler.profile``:
    every device event of the trace counts (no idle gaps: the trace has no
    host events to put them on)."""
    dev = [(ev.start_ns(), ev.end_ns(), ev)
           for ev in prof.profiler.kineto_results.events() if _is_work(ev)]
    busy_ns, _ = _union((s, e) for s, e, _ in dev)
    kernels, device_ops = _kernels_and_ops(dev)
    return TraceSummary(window_s=window_s, busy_s=busy_ns * 1e-9,
                        kernels=kernels, n_device_events=len(dev),
                        device_ops=device_ops)


def summarize(prof, window_s: float) -> TraceSummary:
    """The summary of a finished ``torch.profiler.profile``."""
    events = list(prof.profiler.kineto_results.events())
    spans = [ev for ev in events if ev.name() == WINDOW_SPAN
             and not _on_device(ev)]
    if not spans:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} span")
    w0 = min(ev.start_ns() for ev in spans)
    w1 = max(ev.end_ns() for ev in spans)
    thread = spans[0].start_thread_id()

    dev, host = [], []
    for ev in events:
        s, e = ev.start_ns(), ev.end_ns()
        if e <= w0 or s >= w1:
            continue
        if _is_work(ev):
            dev.append((max(s, w0), min(e, w1), ev))
        elif (not _on_device(ev) and ev.name() != WINDOW_SPAN
              and ev.start_thread_id() == thread):
            host.append((s, e, ev.name()))
    busy_ns, merged = _union((s, e) for s, e, _ in dev)

    kernels, device_ops = _kernels_and_ops(dev)

    # gaps between device activity, each on the innermost host event of the
    # window's thread running at its midpoint (they nest: walk up parents)
    host.sort(key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    parent, stack = [-1] * len(host), []
    for i, (s, e, _) in enumerate(host):
        while stack and host[stack[-1]][1] <= s:
            stack.pop()
        parent[i] = stack[-1] if stack else -1
        stack.append(i)
    gaps, prev = {}, w0
    for s, e in merged + [[w1, w1]]:
        if s > prev:
            mid = (prev + s) // 2
            i = bisect.bisect_right(starts, mid) - 1
            while i >= 0 and host[i][1] < mid:
                i = parent[i]
            name = host[i][2] if i >= 0 else "(no host event)"
            gaps[name] = gaps.get(name, 0.0) + (s - prev) * 1e-9
        prev = max(prev, e)
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]

    return TraceSummary(window_s=window_s, busy_s=busy_ns * 1e-9,
                        kernels=kernels, n_device_events=len(dev),
                        device_ops=device_ops,
                        idle_gaps=[[k, v] for k, v in idle_gaps])
