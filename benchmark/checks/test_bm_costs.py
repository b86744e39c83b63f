"""The frozen cost functions against counts made by hand."""

import pytest

from benchmark.costs.roofline import (HBM_BYTES_PER_S, PEAK_FLOPS, b1_cost,
                                      b3b_cost, least_seconds)


def test_peaks():
    assert HBM_BYTES_PER_S == 3.35e12
    # float64 on the CUDA cores, not the tensor cores' 67e12
    assert PEAK_FLOPS == {"float32": 67e12, "float64": 34e12}


@pytest.mark.parametrize("p, dims, itemsize, nbytes, flops", [
    # n = 4*3*3 = 36; bands 2 * 3 * (4+3+3) = 60 values; 7 * 3 MACs a dof
    (1, (4, 3, 3), 4, 4 * (72 + 60), 2 * 21 * 36),
    # n = 8*5*5 = 200; bands 2 * 5 * 18 = 180; 7 * 5 MACs a dof
    (2, (8, 5, 5), 8, 8 * (400 + 180), 2 * 35 * 200),
    # the refs 3 tank: n = 1024*65*257; bands 2 * 9 * 1346
    (4, (1024, 65, 257), 4, 4 * (2 * 17_105_920 + 24_228),
     2 * 63 * 17_105_920),
])
def test_b1_by_hand(p, dims, itemsize, nbytes, flops):
    assert b1_cost(dims, p, itemsize) == (nbytes, flops)


@pytest.mark.parametrize("p, q, ne, itemsize, nbytes, flops", [
    # p=1, q=2: L=8, Q=8; MACs 4*8*2 + 6*4*4 + 6*2*8 = 64+96+96 = 256
    (1, 2, 1, 8, 8 * (16 + 48 + 8), 2 * 256 + 15 * 8),
    # p=2, q=3: L=27, Q=27; MACs 4*27*3 + 6*9*9 + 6*3*27 = 324+486+486
    (2, 3, 10, 4, 4 * (10 * 54 + 10 * 162 + 18), 10 * (2 * 1296 + 405)),
    # p=4, q=5: L=125, Q=125; MACs 4*125*5 + 6*25*25 + 6*5*125 = 2500 +
    # 3750 + 3750; the study's 4,224 hexes
    (4, 5, 4224, 8, 8 * (4224 * 250 + 4224 * 750 + 50),
     4224 * (2 * 10_000 + 1875)),
])
def test_b3b_by_hand(p, q, ne, itemsize, nbytes, flops):
    assert b3b_cost(ne, p, q, itemsize) == (nbytes, flops)


def test_least_seconds_takes_the_longer_bound():
    # 3.35e12 bytes take a second; 34e12 float64 flops take a second
    assert least_seconds(3.35e12, 1.0, "float64") == pytest.approx(1.0)
    assert least_seconds(1.0, 68e12, "float64") == pytest.approx(2.0)
    assert least_seconds(1.0, 67e12, "float32") == pytest.approx(1.0)
