"""Peak rates of one NVIDIA H100 SXM and the least bytes and operations of
the Laplace applies B1 and B3b.

Peaks (NVIDIA's data sheet, dense rates, at the 700 W power limit): HBM3 at
3.35 TB/s; 67 TFLOP/s in float32 on the CUDA cores; 34 TFLOP/s in float64
on the CUDA cores. The card's 67 TFLOP/s float64 rate is the tensor cores'
(DMMA), which none of the port's kernels use, so it is not the ceiling of
these applies.

A call's least time is the larger of its bytes over the bandwidth and its
flops over the peak of its dtype. Bytes count every input read once and
every output written once, plus the call's tables; flops count the
arithmetic the algorithm needs, whatever a kernel reads or computes again.
The byte and flop counts are those of the port's own smoke test (its
``_b1_bound`` and ``_element_flops``), copied here and frozen.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS", "least_seconds", "b1_cost",
           "b3b_cost"]

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def least_seconds(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the card could take for a call: bytes at the HBM
    bandwidth or flops at the dtype's peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def b1_cost(dims, p: int, itemsize: int) -> tuple[int, int]:
    """(bytes, flops) of one B1 apply on the lattice ``dims = (Dx, Dy, Dz)``
    at order ``p``: x read once and y written once, the six bands
    ``[2p+1, D_a]`` (a K and an M per axis) read once; 7 (2p+1)
    multiply-adds per dof (two 1D sums along x, three along y, two z)."""
    n = dims[0] * dims[1] * dims[2]
    nbytes = itemsize * (2 * n + 2 * (2 * p + 1) * sum(dims))
    return nbytes, 2 * 7 * (2 * p + 1) * n


def b3b_cost(ne: int, p: int, q: int, itemsize: int) -> tuple[int, int]:
    """(bytes, flops) of one B3b call on ``ne`` elements of order ``p`` with
    ``q`` Gauss points a direction: the E-vector read once and written
    once (``(p+1)^3`` values an element each way), the full metric (six
    values a Gauss point) and the 1D tables B and D; the sum-factorised
    apply's six 1D passes (``4 (p+1)^3 q + 6 (p+1)^2 q^2 + 6 (p+1) q^3``
    multiply-adds) and the symmetric 3x3 product at each Gauss point (15
    flops)."""
    p1 = p + 1
    L, Q = p1 ** 3, q ** 3
    nbytes = itemsize * (2 * ne * L + ne * 6 * Q + 2 * q * p1)
    macs = 4 * p1 ** 3 * q + 6 * p1 ** 2 * q ** 2 + 6 * p1 * q ** 3
    return nbytes, ne * (2 * macs + 15 * Q)
