"""Plain reference of the Cartesian wave tank: one RK4 step of the linear
potential-flow free surface, with every Laplace solve exact.

Works the discretisation out again from the configuration's numbers alone:

- the tank [0, Lx] x [0, Ly] x [0, Lz] with ``nx, ny, nz`` elements per axis,
  each split ``ref_levels`` times, order-p Lagrange elements on Gauss-Lobatto
  nodes, x periodic on a ``periodic_tank``; dofs numbered ``ix + Dx (iy + Dy
  iz)`` (x fastest), the free surface the top plane ``iz = Dz - 1``;
- the Laplace operator as the sum of Kronecker products of the assembled 1D
  stiffness and mass matrices, ``A = Mz Ky Mx ...`` (dense 1D factors);
- the Dirichlet solve (phi = phi_fs on the top plane, zero Neumann on the rest)
  by fast diagonalisation: the 1D generalised eigenproblems ``K s = lambda M
  s`` of each axis (z without its top node) turn the interior block of A into
  a diagonal, so the solve is three dense transforms each way and a division,
  followed by two passes of iterative refinement on the true residual;
- the free-surface trace dphi/dz at the top nodes (the derivative of the top
  element's interpolant along z), the right-hand side
  ``d eta/dt = dphi/dz, d phi_fs/dt = -g eta``, classic RK4;
- the wave's period from the linear dispersion relation, dt = periods T /
  nsteps.

Runs on any device, in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .basis import element_matrices, lagrange, lobatto_nodes

__all__ = ["TankReference"]


def _assemble(n_el: int, h: float, loc: np.ndarray, periodic: bool,
              stiff: bool) -> np.ndarray:
    """Dense global 1D matrix of ``n_el`` equal elements of width ``h``."""
    p = loc.shape[0] - 1
    D = n_el * p + (0 if periodic else 1)
    G = np.zeros((D, D))
    blk = loc / h if stiff else loc * h
    for e in range(n_el):
        idx = (e * p + np.arange(p + 1)) % D
        G[np.ix_(idx, idx)] += blk
    return G


def _gen_eig(K: np.ndarray, M: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(S, lam): K S = M S diag(lam) with S^T M S = I (Cholesky of M)."""
    L = np.linalg.cholesky(M)
    Li = np.linalg.inv(L)
    lam, V = np.linalg.eigh(Li @ K @ Li.T)
    return Li.T @ V, lam


class TankReference:
    """The reference of one Cartesian tank configuration.

    ``cfg``: the configuration's numbers (``nx, ny, nz, Lx, Ly, Lz,
    ref_levels, order, mesh_kind, g, wave_m, nsteps, t_final_periods``)."""

    def __init__(self, cfg: dict, device="cpu"):
        p = int(cfg["order"])
        refs = int(cfg.get("ref_levels", 0))
        self.p, self.device = p, torch.device(device)
        self.dtype = dtype = torch.float64
        self.g = float(cfg["g"])
        periodic = cfg["mesh_kind"] == "periodic_tank"
        n_el = [int(cfg[k]) * 2 ** refs for k in ("nx", "ny", "nz")]
        L = [float(cfg[k]) for k in ("Lx", "Ly", "Lz")]
        h = [Li / n for Li, n in zip(L, n_el)]
        Khat, Mhat = element_matrices(p)
        Kx = _assemble(n_el[0], h[0], Khat, periodic, True)
        Mx = _assemble(n_el[0], h[0], Mhat, periodic, False)
        Ky = _assemble(n_el[1], h[1], Khat, False, True)
        My = _assemble(n_el[1], h[1], Mhat, False, False)
        Kz = _assemble(n_el[2], h[2], Khat, False, True)
        Mz = _assemble(n_el[2], h[2], Mhat, False, False)
        self.dims = (Kx.shape[0], Ky.shape[0], Kz.shape[0])      # Dx, Dy, Dz
        self.n_dofs = int(np.prod(self.dims))
        self.n_surf = self.dims[0] * self.dims[1]

        def dev(a):
            return torch.tensor(a, dtype=torch.float64).to(self.device, dtype)

        self.Kx, self.Mx, self.Ky, self.My, self.Kz, self.Mz = map(
            dev, (Kx, Mx, Ky, My, Kz, Mz))
        Sx, lx = _gen_eig(Kx, Mx)
        Sy, ly = _gen_eig(Ky, My)
        Sz, lz = _gen_eig(Kz[:-1, :-1], Mz[:-1, :-1])
        self.Sx, self.Sy, self.Sz = map(dev, (Sx, Sy, Sz))
        self.inv_lam = dev(1.0 / (lz[:, None, None] + ly[None, :, None]
                                  + lx[None, None, :]))
        # d/dz of the top element's interpolant at its top node
        _, Dt = lagrange(lobatto_nodes(p), np.array([1.0]))
        self.dn = dev(Dt[0] / h[2])

        # node coordinates of the free surface, x fastest
        xi = lobatto_nodes(p)

        def axis(n, hh, per):
            pts = (np.arange(n)[:, None] * hh + xi[None, :p] * hh).ravel()
            return pts if per else np.append(pts, n * hh)

        self.axes = (axis(n_el[0], h[0], periodic), axis(n_el[1], h[1], False),
                     axis(n_el[2], h[2], False))
        self.size = max(L)

        k = 2.0 * math.pi * float(cfg["wave_m"]) / L[0]
        self.k = k
        self.omega = math.sqrt(self.g * k * math.tanh(k * L[2]))
        self.period = 2.0 * math.pi / self.omega
        self.dt = (float(cfg["t_final_periods"]) * self.period
                   / int(cfg["nsteps"]))

    # ------------------------------------------------------------ numbering
    def _nearest(self, a: int, c: np.ndarray) -> tuple[np.ndarray, float]:
        ax = self.axes[a]
        i = np.clip(np.searchsorted(ax, c), 1, len(ax) - 1)
        i = np.where(np.abs(ax[i - 1] - c) <= np.abs(ax[i] - c), i - 1, i)
        return i, float(np.max(np.abs(ax[i] - c), initial=0.0))

    def surface_index(self, xy: np.ndarray) -> tuple[np.ndarray, float]:
        """(this numbering's surface index of each point ``xy``, the largest
        distance from a point to its node)."""
        (ix, dx), (iy, dy) = (self._nearest(a, xy[:, a]) for a in range(2))
        return ix + self.dims[0] * iy, max(dx, dy)

    def volume_index(self, xyz: np.ndarray) -> tuple[np.ndarray, float]:
        """The same for volume points ``xyz``."""
        (ix, dx), (iy, dy), (iz, dz) = (self._nearest(a, xyz[:, a])
                                        for a in range(3))
        Dx, Dy, _ = self.dims
        return ix + Dx * (iy + Dy * iz), max(dx, dy, dz)

    # ----------------------------------------------------------- the operator
    def apply(self, X: torch.Tensor) -> torch.Tensor:
        """A X on the lattice ``X [Dz, Dy, Dx]``."""
        ax = X @ self.Kx.T
        bx = X @ self.Mx.T
        t1 = torch.einsum("jb,zbx->zjx", self.My, ax)
        t1 = t1 + torch.einsum("jb,zbx->zjx", self.Ky, bx)
        t2 = torch.einsum("jb,zbx->zjx", self.My, bx)
        return (torch.einsum("kz,zyx->kyx", self.Mz, t1)
                + torch.einsum("kz,zyx->kyx", self.Kz, t2))

    def _fdm(self, F: torch.Tensor) -> torch.Tensor:
        """A_II^-1 F on the interior planes ``F [Dz-1, Dy, Dx]``."""
        V = F @ self.Sx
        V = torch.einsum("yb,zyx->zbx", self.Sy, V)
        V = torch.einsum("zc,zyx->cyx", self.Sz, V)
        V = V * self.inv_lam
        V = torch.einsum("zc,cyx->zyx", self.Sz, V)
        V = torch.einsum("yb,zbx->zyx", self.Sy, V)
        return V @ self.Sx.T

    def solve(self, phi_top: torch.Tensor, refine: int = 2) -> torch.Tensor:
        """phi [Dz, Dy, Dx] harmonic in the discrete sense with the top plane
        ``phi_top [Dy * Dx]``: the interior rows of A phi vanish."""
        Dx, Dy, Dz = self.dims
        phi = torch.zeros((Dz, Dy, Dx), dtype=self.dtype, device=self.device)
        phi[-1] = phi_top.reshape(Dy, Dx).to(self.dtype)
        for _ in range(1 + refine):
            r = -self.apply(phi)[:-1]
            phi[:-1] += self._fdm(r)
        return phi

    def trace(self, phi: torch.Tensor) -> torch.Tensor:
        """dphi/dz at the top nodes, [Dy * Dx]."""
        p = self.p
        top = phi[-(p + 1):]
        return torch.einsum("m,myx->yx", self.dn, top).reshape(-1)

    # ------------------------------------------------------------ time steps
    def rhs(self, t: float, y: torch.Tensor):
        ns = self.n_surf
        eta, pfs = y[:ns], y[ns:]
        phi = self.solve(pfs)
        return torch.cat([self.trace(phi), -self.g * eta]), phi

    def step(self, t: float, y: torch.Tensor):
        """One classic RK4 step from ``y = [eta; phi_fs]``: (y_new, phi of
        the last stage, flattened)."""
        dt = self.dt
        y = y.to(self.device, self.dtype)
        k1, _ = self.rhs(t, y)
        k2, _ = self.rhs(t + dt / 2, y + dt / 2 * k1)
        k3, _ = self.rhs(t + dt / 2, y + dt / 2 * k2)
        k4, phi = self.rhs(t + dt, y + dt * k3)
        return y + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4), phi.reshape(-1)
