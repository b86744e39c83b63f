"""Plain reference of the wave-cylinder diffraction study: one RK4 step of
the linear free surface with relaxation zones, every Laplace solve to 1e-13.

Works the discretisation out again from the study's numbers alone:

- the tank [0, Lx] x [0, Ly] x [0, depth] less the half-disk of radius a
  about (cx, 0), meshed as one polar block: ``n_theta`` rays from the
  cylinder's centre (the rectangle's two upper corners among them, the
  rest spread evenly on the three arcs between), radial layers that grow
  geometrically from the rim (``grading``; capped at ``dr_max`` where it is
  given, the first as wide as the rim's arc), ``nz`` layers in z;
- every element's geometry the order-p Lagrange interpolant, on its
  Gauss-Lobatto nodes, of the exact polar map ``x = c + (a + f (t(theta) -
  a)) (cos theta, sin theta)``, with theta, the radial fraction f and z
  linear in the element's reference coordinates and t(theta) the ray's
  length to the rectangle;
- order-p Lagrange elements on the same nodes, numbered on the block's
  (r, theta, z) node lattice, r fastest; the free surface its top plane;
- the stiffness matrix of every element from the map's Jacobian at the
  Gauss points of the configured rule (p+1 a direction), applied element
  by element; the Dirichlet solve by Jacobi-preconditioned CG to a relative
  residual of 1e-13;
- the trace dphi/dz at the surface nodes: each top element's nodal
  derivative along z (through the inverse Jacobian at the node), averaged
  over the elements that share the node;
- the surface equations with the three relaxation zones: generation at the
  inlet (a cubic ramp over ``Ng`` wavelengths) and the lateral zone (``Ny``
  wavelengths, weight xi^5) relax toward the incident Airy wave, the outlet
  zone (``Ns`` wavelengths, xi^5) toward rest, the generation ramped in over
  ``n_ramp`` periods, penalty time dt; classic RK4 with its stage times;
- the wave: wavelength lambda with kh pinned, omega^2 = g k tanh(kh), dt =
  periods T / nsteps.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .basis import gauss_rule, lagrange, lobatto_nodes

__all__ = ["CylinderReference", "polar_block"]


def _ray(cx: float, Lx: float, Ly: float, th: np.ndarray) -> np.ndarray:
    """Length of the ray from (cx, 0) at angle ``th`` to the rectangle
    [0, Lx] x [0, Ly]."""
    c, s = np.cos(th), np.sin(th)
    big = np.full(np.shape(th), np.inf)
    tx = np.where(c > 1e-14, (Lx - cx) / np.where(c > 1e-14, c, 1.0),
                  np.where(c < -1e-14, -cx / np.where(c < -1e-14, c, 1.0),
                           big))
    ty = np.where(s > 1e-14, Ly / np.where(s > 1e-14, s, 1.0), big)
    return np.minimum(tx, ty)


def polar_block(Lx, Ly, cx, a, n_theta, n_r, grading, dr_max):
    """(thetas [n_theta + 1], fractions [n_r + 1]) of the polar block."""
    corners = [math.atan2(Ly, Lx - cx), math.atan2(Ly, -cx)]
    arcs = [(0.0, corners[0]), (corners[0], corners[1]), (corners[1], math.pi)]
    lens = np.array([b - a_ for a_, b in arcs])
    counts = np.maximum(1, np.round(n_theta * lens / math.pi).astype(int))
    while counts.sum() > n_theta:
        counts[np.argmax(counts)] -= 1
    while counts.sum() < n_theta:
        counts[np.argmin(counts / np.maximum(lens, 1e-9))] += 1
    thetas = np.concatenate([np.linspace(a_, b, k, endpoint=False)
                             for (a_, b), k in zip(arcs, counts)]
                            + [[math.pi]])
    if dr_max:
        longest = float(np.max(_ray(cx, Lx, Ly, thetas))) - a
        widths = [min(a * math.pi / n_theta, dr_max)]
        while sum(widths) < longest:
            widths.append(min(widths[-1] * grading, dr_max))
        w = np.asarray(widths)
    else:
        w = grading ** np.arange(n_r)
    return thetas, np.concatenate([[0.0], np.cumsum(w)]) / np.sum(w)


def _wave_weights(x, x0, x1, rising: bool, power: float = 5.0):
    xi = np.clip((x - x0) / (x1 - x0), 0.0, 1.0)
    if rising:
        return xi ** power
    s = 1.0 - xi
    return 3.0 * s ** 2 - 2.0 * s ** 3


class CylinderReference:
    """The reference of the diffraction study at the parameters ``cfg``
    (``order, n_theta, n_r, dr_max, nz, Lx, Ly, cx, radius, H, nsteps,
    periods``; the study's zones and wave are fixed below)."""

    LAMBDA, KH, G = 1.0, 1.0, 9.81
    NG, NS, NY, N_RAMP = 2.5, 4.0, 3.0, 3.0

    RTOL, MAX_ITER = 1e-13, 40000          # the reference's own CG

    def __init__(self, cfg: dict, device="cpu"):
        p = int(cfg["order"])
        self.p, self.device = p, torch.device(device)
        self.dtype = dtype = torch.float64
        Lx, Ly, cx, a = (float(cfg[k]) for k in ("Lx", "Ly", "cx", "radius"))
        depth = 1.0 / (2.0 * math.pi)
        dr_max = cfg.get("dr_max")
        thetas, frac = polar_block(Lx, Ly, cx, a, int(cfg["n_theta"]),
                                   int(cfg["n_r"]),
                                   1.4 if dr_max else 1.25, dr_max)
        nz = int(cfg["nz"])
        zs = np.linspace(0.0, depth, nz + 1)
        n_r, n_t = len(frac) - 1, len(thetas) - 1
        p1 = p + 1
        self.dims = (n_r * p + 1, n_t * p + 1, nz * p + 1)
        Dr, Dt, Dz = self.dims
        self.n_dofs = Dr * Dt * Dz
        self.n_surf = Dr * Dt
        self.size = max(Lx, Ly)

        # element nodes: local (a, b, c) = (r, theta, z), r fastest
        xi = lobatto_nodes(p)
        ej, ei, ek = np.meshgrid(np.arange(n_r), np.arange(n_t),
                                 np.arange(nz), indexing="ij")
        ej, ei, ek = ej.ravel(), ei.ravel(), ek.ravel()
        C, B_, A_ = np.meshgrid(xi, xi, xi, indexing="ij")     # z, th, r
        la, lb, lc = A_.ravel(), B_.ravel(), C.ravel()
        th = thetas[ei, None] + (thetas[ei + 1] - thetas[ei])[:, None] * lb
        f = frac[ej, None] + (frac[ej + 1] - frac[ej])[:, None] * la
        z = zs[ek, None] + (zs[ek + 1] - zs[ek])[:, None] * lc
        r = a + f * (_ray(cx, Lx, Ly, th) - a)
        X = np.stack([cx + r * np.cos(th), r * np.sin(th), z], axis=-1)
        ia, ib, ic = np.meshgrid(np.arange(p1), np.arange(p1),
                                 np.arange(p1), indexing="ij")
        ia, ib, ic = ic.ravel(), ib.ravel(), ia.ravel()      # r fastest
        edofs = ((ej[:, None] * p + ia) + Dr * ((ei[:, None] * p + ib)
                                                + Dt * (ek[:, None] * p + ic)))
        self.node_xyz = np.zeros((self.n_dofs, 3))
        self.node_xyz[edofs.ravel()] = X.reshape(-1, 3)
        mult = np.bincount(edofs.ravel(), minlength=self.n_dofs)

        # 1D tables: values / derivatives at the Gauss points and the nodes
        q = cfg.get("quad")
        xq, wq = gauss_rule(p1 if q is None else int(q))
        Bq, Dq = lagrange(xi, xq)
        _, Dn = lagrange(xi, xi)
        In = np.eye(p1)

        def grad3(Bt, Dt_):
            """[3, npts^3, p1^3]: d/dr, d/dtheta, d/dz of every basis
            function at the tensor points of the tables."""
            return np.stack([np.einsum("zc,yb,xa->zyxcba", Bt, Bt, Dt_),
                             np.einsum("zc,yb,xa->zyxcba", Bt, Dt_, Bt),
                             np.einsum("zc,yb,xa->zyxcba", Dt_, Bt, Bt)]
                            ).reshape(3, len(Bt) ** 3, p1 ** 3)

        Gq, Gn = grad3(Bq, Dq), grad3(In, Dn)
        W = np.einsum("z,y,x->zyx", wq, wq, wq).ravel()
        dev = self.device

        def t(v, dt=dtype):
            return torch.as_tensor(v).to(dev, dt)

        # element stiffness matrices, in blocks of elements
        Xt = t(X, torch.float64)
        Gq_t = t(Gq, torch.float64)
        Ke = []
        for e0 in range(0, len(X), 512):
            Xe = Xt[e0:e0 + 512]
            J = torch.einsum("aql,eld->eqda", Gq_t, Xe)       # dx_d / dxi_a
            Ji = torch.linalg.inv(J)                          # dxi_a / dx_d
            w = t(W, torch.float64) * torch.linalg.det(J).abs()
            M = torch.einsum("eqad,eqbd,eq->eqab", Ji, Ji, w)
            T = torch.einsum("eqab,bqj->eqaj", M, Gq_t)
            Ke.append(torch.einsum("aqi,eqaj->eij", Gq_t, T))
        self.Ke = torch.cat(Ke).to(dtype)
        self.edofs = t(edofs, torch.int64)
        diag = torch.zeros(self.n_dofs, dtype=dtype, device=dev)
        diag.index_add_(0, self.edofs.reshape(-1),
                        torch.diagonal(self.Ke, dim1=1, dim2=2).reshape(-1))
        top = np.zeros(self.n_dofs, dtype=bool)
        top[Dr * Dt * (Dz - 1):] = True
        self.free = t(~top, dtype)
        self.inv_diag = torch.where(torch.as_tensor(top, device=dev),
                                    torch.ones_like(diag), 1.0 / diag)

        # the trace: top elements' nodal d/dz, averaged over sharing elements
        topel = np.nonzero(ek == nz - 1)[0]
        Gn_t = t(Gn, torch.float64)
        Jn = torch.einsum("aql,eld->eqda", Gn_t, Xt[topel])
        jz = torch.linalg.inv(Jn)[..., 2]                     # [m, L, 3]
        top_l = np.nonzero(ic == p)[0]                        # local top nodes
        self.tr_elems = t(topel, torch.int64)
        self.tr_rows = t(top_l, torch.int64)
        self.tr_jz = jz[:, top_l].to(dtype)
        self.tr_G = t(Gn[:, top_l], dtype)                    # [3, nt, L]
        self.tr_surf = t(edofs[topel][:, top_l] - Dr * Dt * (Dz - 1),
                         torch.int64)
        self.tr_inv = t(1.0 / mult[Dr * Dt * (Dz - 1):], dtype)

        # relaxation weights and the incident wave at the surface nodes
        sx, sy = self.node_xyz[-self.n_surf:, :2].T
        x0, x1 = float(np.min(X[..., 0])), float(np.max(X[..., 0]))
        y1 = float(np.max(X[..., 1]))
        lam = self.LAMBDA
        gen = (_wave_weights(sx, x0, x0 + self.NG * lam, False)
               + _wave_weights(sy, y1 - self.NY * lam, y1, True))
        ab = _wave_weights(sx, x1 - self.NS * lam, x1, True)
        self.k = 2.0 * math.pi / lam
        self.omega = math.sqrt(self.G * self.k * math.tanh(self.KH))
        self.period = 2.0 * math.pi / self.omega
        self.dt = float(cfg["periods"]) * self.period / int(cfg["nsteps"])
        self.H = float(cfg["H"])
        self.phi_amp = (-0.5 * self.H * (self.omega / self.k)
                        / math.tanh(self.KH))
        self.gen, self.ab = t(gen), t(ab)
        self.kx = t(self.k * sx, torch.float64)

    # ------------------------------------------------------------ numbering
    def surface_index(self, xy: np.ndarray) -> tuple[np.ndarray, float]:
        from scipy.spatial import cKDTree
        d, i = cKDTree(self.node_xyz[-self.n_surf:, :2]).query(xy)
        return i, float(np.max(d, initial=0.0))

    def volume_index(self, xyz: np.ndarray) -> tuple[np.ndarray, float]:
        from scipy.spatial import cKDTree
        d, i = cKDTree(self.node_xyz).query(xyz)
        return i, float(np.max(d, initial=0.0))

    # ----------------------------------------------------------- the operator
    def apply(self, x: torch.Tensor) -> torch.Tensor:
        ye = torch.bmm(self.Ke, x[self.edofs].unsqueeze(-1)).squeeze(-1)
        return torch.zeros_like(x).index_add_(0, self.edofs.reshape(-1),
                                              ye.reshape(-1))

    def solve(self, phi_top: torch.Tensor, x0=None) -> torch.Tensor:
        """phi with the top plane ``phi_top`` and the other rows of A phi
        zero, by Jacobi-PCG on the free dofs."""
        ns = self.n_surf
        lift = torch.zeros(self.n_dofs, dtype=self.dtype, device=self.device)
        lift[-ns:] = phi_top.to(self.dtype)
        b = -self.apply(lift) * self.free
        x = (torch.zeros_like(b) if x0 is None else x0 * self.free)
        r = b - self.apply(x) * self.free
        z = self.inv_diag * r
        d = z.clone()
        rz = torch.dot(r, z)
        bnorm = float(torch.linalg.vector_norm(b))
        for it in range(self.MAX_ITER):
            if it % 50 == 0 and float(torch.linalg.vector_norm(r)) <= \
                    self.RTOL * bnorm:
                break
            Ad = self.apply(d) * self.free
            alpha = rz / torch.dot(d, Ad)
            x = x + alpha * d
            r = r - alpha * Ad
            z = self.inv_diag * r
            rz_new = torch.dot(r, z)
            d = z + (rz_new / rz) * d
            rz = rz_new
        else:
            raise RuntimeError("the reference's CG did not reach its "
                               "tolerance")
        return x + lift

    def trace(self, phi: torch.Tensor) -> torch.Tensor:
        u = phi[self.edofs[self.tr_elems]]                     # [m, L]
        g = torch.einsum("anl,ml->mna", self.tr_G, u)          # [m, nt, 3]
        w = (g * self.tr_jz).sum(-1)
        out = torch.zeros(self.n_surf, dtype=self.dtype, device=self.device)
        out.index_add_(0, self.tr_surf.reshape(-1), w.reshape(-1))
        return out * self.tr_inv

    # ------------------------------------------------------------ time steps
    def rhs(self, t: float, y: torch.Tensor, x0=None):
        ns = self.n_surf
        eta, pfs = y[:ns], y[ns:]
        phi = self.solve(pfs, x0)
        deta = self.trace(phi)
        dpfs = -self.G * eta
        arg = self.omega * t - self.kx
        eta_e = (0.5 * self.H * torch.cos(arg)).to(self.dtype)
        pfs_e = (self.phi_amp * torch.sin(arg)).to(self.dtype)
        alpha = min(max(t / (self.N_RAMP * self.period), 0.0), 1.0)
        gen = alpha * self.gen / self.dt
        ab = self.ab / self.dt
        deta = deta + gen * (eta_e - eta) - ab * eta
        dpfs = dpfs + gen * (pfs_e - pfs) - ab * pfs
        return torch.cat([deta, dpfs]), phi

    def step(self, t: float, y: torch.Tensor):
        """One classic RK4 step from ``y = [eta; phi_fs]`` at time ``t``:
        (y_new, phi of the last stage, in this numbering)."""
        dt = self.dt
        y = y.to(self.device, self.dtype)
        k1, phi = self.rhs(t, y)
        k2, phi = self.rhs(t + dt / 2, y + dt / 2 * k1, phi)
        k3, phi = self.rhs(t + dt / 2, y + dt / 2 * k2, phi)
        k4, phi = self.rhs(t + dt, y + dt * k3, phi)
        return y + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4), phi
