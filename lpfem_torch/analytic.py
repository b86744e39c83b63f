"""Analytic solutions: Airy (linear) waves, dispersion, McCamy-Fuchs.

A copy of ``lpfem.analytic`` (host NumPy / SciPy, the same operations):

- dispersion fixed point ``kh = sqrt((w^2/g) h kh coth(kh))``
  (``Solvers/PF_linear_serial.cpp:15-34``),
- the Airy free-surface fields (``Solvers/PF_linear_serial.cpp:351-364``)
  and the volume fields ``phi`` / ``w_vel``
  (``Solvers/laplace_solver.cpp:74-81``),
- the McCamy-Fuchs wave-cylinder diffraction series with Bessel/Hankel terms
  (``Solvers/cylinder-exact.cpp:52-115``; Boost.Math there, SciPy here).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["dispersion_kh", "AiryWave", "mccamy_fuchs_envelope"]


def coth(x: np.ndarray | float) -> np.ndarray | float:
    x = np.maximum(x, 1e-12)
    return np.cosh(x) / np.sinh(x)


def dispersion_kh(g: float, T: float, h: float, n_iter: int = 40) -> float:
    """Fixed-point solve of ``w^2 = g k tanh(kh)`` for ``kh``
    (``Solvers/PF_linear_serial.cpp:15-34``)."""
    w = 2.0 * np.pi / T
    kh = max((w * w) * h / g, 1e-8)
    for _ in range(n_iter):
        kh = max(np.sqrt((w * w / g) * h * kh * coth(kh)), 1e-8)
    return kh


@dataclass
class AiryWave:
    """Linear progressive (or standing-tank) wave on depth ``h``.

    eta(x, t)    =  H/2 cos(w t - k.x)
    phi_fs(x, t) = -H/2 c (cosh kh / sinh kh) sin(w t - k.x)
    with dispersion w^2 = g k tanh(kh); direction (kx, ky) = (cos theta,
    sin theta).
    """
    H: float
    k: float
    h: float
    g: float = 9.81
    theta: float = 0.0
    z_top: float | None = None   # z of the free surface; defaults to h

    def __post_init__(self):
        self.kh = self.k * self.h
        self.omega = float(np.sqrt(self.g * self.k * np.tanh(self.kh)))
        self.T = 2.0 * np.pi / self.omega
        self.c = self.omega / self.k
        self.wavelength = 2.0 * np.pi / self.k
        self.kx = np.cos(self.theta)
        self.ky = np.sin(self.theta)
        if self.z_top is None:
            self.z_top = self.h

    @classmethod
    def from_period(cls, H: float, T: float, h: float, g: float = 9.81,
                    n_iter: int = 40, **kw) -> "AiryWave":
        """Wave chosen by period via the dispersion fixed point
        (``Solvers/PF_linear_serial.cpp:319-325``)."""
        kh = dispersion_kh(g, T, h, n_iter)
        return cls(H=H, k=kh / h, h=h, g=g, **kw)

    @classmethod
    def from_modes(cls, H: float, m: float, Lx: float, h: float,
                   g: float = 9.81, **kw) -> "AiryWave":
        """Wave with ``m`` periods across a periodic tank of length ``Lx``
        (``Solvers/PF_linear_periodic.cpp:153-160``)."""
        return cls(H=H, k=m * 2.0 * np.pi / Lx, h=h, g=g, **kw)

    def phase(self, x, y, t):
        return self.omega * t - self.k * (self.kx * x + self.ky * y)

    def eta(self, x, y, t=0.0):
        return 0.5 * self.H * np.cos(self.phase(x, y, t))

    def phi_fs(self, x, y, t=0.0):
        amp = -0.5 * self.H * self.c * np.cosh(self.kh) / np.sinh(self.kh)
        return amp * np.sin(self.phase(x, y, t))

    def phi(self, x, y, z, t=0.0):
        """Volume potential; z measured with free surface at ``z_top`` and
        bottom at ``z_top - h`` (``Solvers/laplace_solver.cpp:74-78``)."""
        zz = z - self.z_top + self.h
        amp = -0.5 * self.H * self.c / np.sinh(self.kh)
        return amp * np.cosh(self.k * zz) * np.sin(self.phase(x, y, t))

    def w_vel(self, x, y, z, t=0.0):
        """Vertical velocity dphi/dz (``Solvers/laplace_solver.cpp:79-81``)."""
        zz = z - self.z_top + self.h
        amp = -0.5 * self.H * self.c * self.k / np.sinh(self.kh)
        return amp * np.sinh(self.k * zz) * np.sin(self.phase(x, y, t))


def mccamy_fuchs_envelope(theta: np.ndarray, ka: float,
                          m_max: int = 400, tol: float = 1e-10) -> np.ndarray:
    """Normalized diffraction run-up |eta| * 2/H on a bottom-mounted circular
    cylinder of radius ``a`` (ka = k*a), vs azimuth ``theta`` (0 = up-wave):

        eta / (H/2) = | sum_m eps_m i^m 2i / (pi ka H'^(1)_m(ka)) cos(m theta) |

    (``Solvers/cylinder-exact.cpp:52-115``, the bracket of the series
    reduced through the Wronskian)."""
    from scipy.special import jv, yv

    theta = np.asarray(theta, dtype=np.float64)
    total = np.zeros_like(theta, dtype=np.complex128)
    for m in range(m_max + 1):
        eps = 1.0 if m == 0 else 2.0
        Jp = _besselp(jv, m, ka)
        Yp = _besselp(yv, m, ka)
        Hp = Jp + 1j * Yp
        term = eps * (1j ** m) * (2j / (np.pi * ka)) / Hp * np.cos(m * theta)
        total += term
        if np.max(np.abs(term)) < tol and m > 10:
            break
    return np.abs(total)


def _besselp(f, m, x):
    """d/dx of the Bessel function of order m via the standard recurrence."""
    if m == 0:
        return -f(1, x)
    return 0.5 * (f(m - 1, x) - f(m + 1, x))
