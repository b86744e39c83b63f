"""The program's own record of a traced run, for the span readers.

``lpfem_torch.profiling`` keeps, per span name, the calls, the host
seconds and the stream seconds between the span's two markers (CUDA events
on the card's current stream; the host clock on the CPU), inclusive and
self (less its direct child spans), the host reads of the device by site,
and the steps. Its details (the CG's exit test, the V-cycle's level
stages, the element gather and fold) take no markers in a benchmark run:
host seconds alone.

Building the cell's ``Problem`` starts a fresh record, and every pass in
which a profiler records adds to it: the device pass and then the census
pass (a device-only profile turns the spans on as a host profile does; the
program cannot tell the two apart, ``PERF.md`` section 3). The readers
take the device pass alone, the record's first ``ctx["device_steps"]``
steps: it runs neither the census's wrappers nor a host event per
operator. On the CPU, where no device pass records, that is the whole
record, the census pass's. Every share divides by the steps'
``timestep.step`` seconds on the same clock as its numerator.

Both clocks count the profiler's cost (the CUDA tracer's per launch, the
spans' own): a share is one of a traced step, longer than an untraced one
(``run.trace_step_s``).

Nothing to read (a program without the record, or a record without a
step): ``None``.
"""

from __future__ import annotations

__all__ = ["program_record", "share"]

STEP = "timestep.step"


def program_record(ctx):
    """The program's record of the device pass (``ctx["device_steps"]``
    steps; all of it where ``ctx`` has no count), or ``None`` where it
    keeps none or holds no step."""
    try:
        from lpfem_torch import profiling
    except ImportError:
        return None
    get = getattr(profiling, "record", None)
    if get is None:
        return None
    rec = get()
    if not getattr(rec, "steps", 0):
        return None
    n = ctx.get("device_steps")
    if n and hasattr(rec, "first"):
        rec = rec.first(n)
    return rec


def share(ctx, seconds_of, clock: str = "stream") -> float | None:
    """100 x ``seconds_of(record)`` / the record's steps' seconds on
    ``clock`` (``"stream"`` or ``"host"``, the numerator's); ``None`` with
    nothing to read."""
    rec = program_record(ctx)
    if rec is None:
        return None
    step_s = getattr(rec.totals(STEP), clock)
    if step_s <= 0:
        return None
    return 100.0 * seconds_of(rec) / step_s
