"""A kernel's share of its roofline over a traced window.

    100 * sum over calls of the call's least time / the kernel's device time

The calls come from the benchmark's census of the program's kernel wrappers
(shape and dtype of each call) in the traced run's census pass and must agree, order by order, with the
program's own launch counters; the device time is the sum of the profiled
launches whose names match the kernel's patterns, scaled by calls over
launches recorded (the profiler drops a few short launches, and a dropped
launch would otherwise raise the share). Nothing to read: ``None``.
"""

from __future__ import annotations

__all__ = ["roofline_percent"]


def roofline_percent(ctx, kind: str, patterns, least_of_call):
    census, trace = ctx.get("census"), ctx.get("census_trace")
    if census is None or trace is None:
        return None
    calls = census.calls(kind)
    if not calls:
        return None
    by_p = {}
    for key, n in calls:
        by_p[key[0]] = by_p.get(key[0], 0) + n
    launched = (ctx.get("launches") or {}).get(kind)
    if launched is not None and launched != by_p:
        return None
    rec = [sec for name, sec in trace.kernels
           if any(pat in name for pat in patterns)]
    if not rec:
        return None
    device_s = sum(rec) * sum(by_p.values()) / len(rec)
    least = sum(n * least_of_call(key) for key, n in calls)
    return 100.0 * least / device_s
