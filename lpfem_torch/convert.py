"""Carry state and smoother tables between ``lpfem`` and this package.

The volume numbering is the same in both (``ix + Dx*(iy + Dy*iz)``) on
either lattice — the Cartesian tank (``LatticeSpace``) and a curved
generator-declared lattice (``CurvedLatticeSpace``, lpfem's
``_renumber_from_lattice``) — but ``lpfem``'s surface state
``[eta; phi_fs]`` is in the topological order of its ``SurfaceSpace(attr=2)``
(``build_quad_dofs``), while here the surface is the top plane in lattice
order: surface dof ``s`` of ``lpfem`` is lattice-plane dof
``surf_to_vol[s] - Dx*Dy*(Dz-1)``. Everything is NumPy in and out; nothing
here imports ``lpfem`` or ``jax`` — pass ``np.asarray`` of their arrays.
"""

from __future__ import annotations

import numpy as np

__all__ = ["surface_permutation", "state_from_lpfem", "state_to_lpfem",
           "smoother_lmax"]


def surface_permutation(surf_to_vol, dof_dims) -> np.ndarray:
    """[Ns] top-plane lattice index of each ``lpfem`` surface dof."""
    Dx, Dy, Dz = dof_dims
    perm = np.asarray(surf_to_vol, dtype=np.int64) - Dx * Dy * (Dz - 1)
    if (perm.shape != (Dx * Dy,) or perm.min() < 0
            or len(np.unique(perm)) != Dx * Dy):
        raise ValueError("surf_to_vol is not a permutation of the top plane")
    return perm


def state_from_lpfem(y, phi, surf_to_vol, dof_dims):
    """(y, phi) of ``lpfem`` -> (y, phi) in this package's surface order."""
    perm = surface_permutation(surf_to_vol, dof_dims)
    y = np.asarray(y)
    ns = len(perm)
    out = np.empty_like(y)
    out[perm] = y[:ns]
    out[ns + perm] = y[ns:]
    return out, np.asarray(phi).copy()


def state_to_lpfem(y, phi, surf_to_vol, dof_dims):
    """Inverse of :func:`state_from_lpfem`."""
    perm = surface_permutation(surf_to_vol, dof_dims)
    y = np.asarray(y)
    ns = len(perm)
    return np.concatenate([y[perm], y[ns + perm]]), np.asarray(phi).copy()


def smoother_lmax(pmg) -> list[float]:
    """Per-level lambda_max of an ``lpfem.multigrid.PMultigrid``, read back
    from its Chebyshev smoothers (``theta + delta``), for
    ``lpfem_torch.multigrid.PMultigrid(lmax=...)``."""
    return [float(sm.theta + sm.delta) for sm in pmg.smoothers]
