"""Percent of a step's wall time in which no kernel, copy or memset runs on
the device: 100 (1 - busy / wall) per step, busy the union of the device's
activity intervals in the device pass's trace (device activity alone, no
host events and no wrappers) and wall the step time of the untraced pass
of the same run. Recording even the device's activity alone slows the
host's launches (by a fifth to a half on these cells), so the traced
pass's own wall would read the profiler's cost as idle time; the device's
busy time a step does not depend on the host's pace."""


def read(ctx):
    tr, steps = ctx["device_trace"], ctx["trace_step_s"]
    if tr is None or steps is None or tr.busy_s <= 0 \
            or ctx["device_steps"] == 0 or steps["untraced"] <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / ctx["device_steps"]
                    / steps["untraced"])
