"""Device kernels in the device pass's trace per RK4 step of that pass
(the profiler can drop a few short launches, so this reads low, never
high)."""


def read(ctx):
    tr = ctx["device_trace"]
    if tr is None or ctx["device_steps"] == 0 or not tr.kernels:
        return None
    return len(tr.kernels) / ctx["device_steps"]
