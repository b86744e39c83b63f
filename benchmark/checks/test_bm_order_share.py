"""B1's roofline share at one order (``costs.order_share``) on a made-up
census and trace: the instantiation that runs the order, the scaling by
calls over launches recorded, and the cases with nothing to read."""

import pytest

from benchmark.costs.order_share import b1_order_percent, instantiation
from benchmark.costs.roofline import b1_cost, least_seconds

DIMS8, DIMS4 = (1024, 65, 257), (512, 33, 129)


class FakeCensus:
    def __init__(self, counts):
        self.counts = counts

    def calls(self, kind):
        return [(k, n) for k, n in self.counts.items()] if kind == \
            "sep_apply" else None


class FakeTrace:
    def __init__(self, kernels):
        self.kernels = kernels


def _name(ct, P):
    return (f"void (anonymous namespace)::sep_tile_kernel<{ct}, {P}>"
            f"({ct} const*, {ct}*, int)")


def _ctx(counts, kernels, launches=None):
    if launches is None:
        launches = {}
        for (p, _, _), n in counts.items():
            launches[p] = launches.get(p, 0) + n
    return {"census": FakeCensus(counts), "census_trace": FakeTrace(kernels),
            "launches": {"sep_apply": launches}}


def _least(n, dims, p, itemsize, dtype):
    return n * least_seconds(*b1_cost(dims, p, itemsize), dtype)


def test_instantiation_names():
    assert instantiation(_name("double", 8)) == ("double", 8)
    assert instantiation("sep_tile_kernel<float, 0>(float const*)") == \
        ("float", 0)
    assert instantiation("pa_element_kernel<double, 5, 6>(...)") is None


def test_share_of_the_order_alone():
    # 10 calls at p = 8 (9 launches recorded, 2 ms each), 30 at p = 4
    counts = {(8, DIMS8, 8): 10, (4, DIMS4, 4): 30}
    kernels = ([(_name("double", 8), 2e-3)] * 9
               + [(_name("float", 4), 1e-3)] * 30)
    got = b1_order_percent(_ctx(counts, kernels), 8)
    want = 100 * _least(10, DIMS8, 8, 8, "float64") / (9 * 2e-3 * 10 / 9)
    assert got == pytest.approx(want, rel=1e-12)


def test_both_dtypes_scale_apart():
    counts = {(8, DIMS8, 8): 4, (8, DIMS8, 4): 6}
    kernels = ([(_name("double", 8), 3e-3)] * 4
               + [(_name("float", 8), 1e-3)] * 3)
    got = b1_order_percent(_ctx(counts, kernels), 8)
    least = (_least(4, DIMS8, 8, 8, "float64")
             + _least(6, DIMS8, 8, 4, "float32"))
    assert got == pytest.approx(100 * least / (12e-3 + 6e-3), rel=1e-12)


def test_nothing_to_read():
    counts = {(8, DIMS8, 8): 10, (3, DIMS4, 8): 5}
    kernels = [(_name("double", 0), 2e-3)] * 15
    # p = 8 on the general instantiation, which p = 3 runs too
    assert b1_order_percent(_ctx(counts, kernels), 8) is None
    # the launch counter disagrees with the census at p = 8
    ok = {(8, DIMS8, 8): 10}
    k8 = [(_name("double", 8), 2e-3)] * 10
    assert b1_order_percent(_ctx(ok, k8, launches={8: 11}), 8) is None
    # no p = 8 call, no kernel recorded, no census
    assert b1_order_percent(_ctx({(4, DIMS4, 4): 3}, k8), 8) is None
    assert b1_order_percent(_ctx(ok, []), 8) is None
    assert b1_order_percent({"census": None, "census_trace": None}, 8) is None
