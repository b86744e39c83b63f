"""The roofline share of one order's calls of B1, where the cell runs B1 at
several orders.

    100 * sum over the order's calls of the call's least time
        / the device time of the order's own instantiation

The kernel's instantiations are named by their template arguments in a
profile, ``sep_tile_kernel<T, P>`` with ``P`` the order compiled in (0 for
the general one, which other orders share, so it is not read). As in
``costs.share``, the calls come from the census and must equal the
program's launch counter at the order, and each dtype's device time is
scaled by its calls over its launches recorded. Nothing to read (no such
call, or no launch of the order's own instantiation): ``None``.
"""

from __future__ import annotations

import re

from .roofline import b1_cost, least_seconds

__all__ = ["b1_order_percent", "instantiation"]

KIND = "sep_apply"
DTYPE = {4: "float32", 8: "float64"}
CTYPE = {4: "float", 8: "double"}
_NAME = re.compile(r"sep_tile_kernel<\s*(float|double)\s*,\s*(\d+)\s*>")


def instantiation(name: str):
    """(C type, P) of a B1 kernel's name in a profile, or ``None``."""
    m = _NAME.search(name)
    return (m.group(1), int(m.group(2))) if m else None


def b1_order_percent(ctx, p: int) -> float | None:
    census, trace = ctx.get("census"), ctx.get("census_trace")
    if census is None or trace is None:
        return None
    mine = [(key, n) for key, n in census.calls(KIND) or [] if key[0] == p]
    n_calls = sum(n for _, n in mine)
    launched = ((ctx.get("launches") or {}).get(KIND) or {}).get(p)
    if n_calls == 0 or launched != n_calls:
        return None
    least = device_s = 0.0
    for itemsize in sorted({key[2] for key, _ in mine}):
        rec = [sec for name, sec in trace.kernels
               if instantiation(name) == (CTYPE[itemsize], p)]
        if not rec:
            return None
        these = [(key, n) for key, n in mine if key[2] == itemsize]
        device_s += sum(rec) * sum(n for _, n in these) / len(rec)
        least += sum(n * least_seconds(*b1_cost(key[1], p, itemsize),
                                       DTYPE[itemsize]) for key, n in these)
    return 100.0 * least / device_s
