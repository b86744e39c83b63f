"""Carry state and smoother tables between ``lpfem`` and this package.

The volume numbering is the same in both on every space. On the two lattice
spaces — the Cartesian tank (``LatticeSpace``) and a generator-declared
lattice (``CurvedLatticeSpace``, lpfem's ``_renumber_from_lattice``) — it is
``ix + Dx*(iy + Dy*iz)``, but ``lpfem``'s surface state ``[eta; phi_fs]`` is
in the topological order of its ``SurfaceSpace(attr=2)``
(``build_quad_dofs``), while here the surface is the top plane in lattice
order: surface dof ``s`` of ``lpfem`` is lattice-plane dof
``surf_to_vol[s] - Dx*Dy*(Dz-1)``. On an ``H1Space`` (mesh files, refined
meshes) the port reproduces lpfem's volume and surface numbering, so states
pass unchanged; :func:`surface_map` gives the map in every case and
:func:`assert_same_numbering` checks the identity. Everything is NumPy in
and out; nothing here imports ``lpfem`` or ``jax`` — pass ``np.asarray`` of
their arrays. The volume potential ``phi`` may be a ``(hi, lo)`` pair of
float32 arrays, lpfem's double-single carry (``lpfem.ds.DS``), in and out.
"""

from __future__ import annotations

import numpy as np

__all__ = ["surface_permutation", "surface_map", "assert_same_numbering",
           "state_from_lpfem", "state_to_lpfem", "sharded_state_from_lpfem",
           "smoother_lmax"]


def surface_map(surf_to_vol_lpfem, surf_to_vol_port) -> np.ndarray:
    """[Ns] the port's surface dof of each ``lpfem`` surface dof, matched
    through the volume dof both sit on (the volume numberings agree)."""
    s2v_l = np.asarray(surf_to_vol_lpfem, dtype=np.int64)
    s2v_p = np.asarray(surf_to_vol_port, dtype=np.int64)
    order = np.argsort(s2v_p, kind="stable")
    pos = np.searchsorted(s2v_p[order], s2v_l)
    if (s2v_l.shape != s2v_p.shape or pos.max(initial=0) >= len(order)
            or not np.array_equal(s2v_p[order][pos], s2v_l)
            or len(np.unique(s2v_l)) != len(s2v_l)):
        raise ValueError("the two surfaces do not cover the same volume dofs")
    return order[pos]


def surface_permutation(surf_to_vol, dof_dims) -> np.ndarray:
    """[Ns] top-plane lattice index of each ``lpfem`` surface dof."""
    Dx, Dy, Dz = dof_dims
    return surface_map(surf_to_vol,
                       Dx * Dy * (Dz - 1) + np.arange(Dx * Dy, dtype=np.int64))


def assert_same_numbering(space_l, surf_l, space_p, surf_p) -> None:
    """Raise unless the port's space and surface (an ``H1Space`` and its
    ``SurfaceSpace``) number volume and surface dofs exactly as lpfem's:
    then states of either package are states of the other."""
    if (space_l.n_dofs != space_p.n_dofs
            or not np.array_equal(space_l.elem_dofs, space_p.elem_dofs)):
        raise ValueError("volume numberings differ")
    if not np.array_equal(np.asarray(surf_l.surf_to_vol),
                          surf_p.surf_to_vol):
        raise ValueError("surface numberings differ")


def _copy_phi(phi):
    """A copy of ``phi``: one array, or a ``(hi, lo)`` double-single pair."""
    if isinstance(phi, tuple):
        hi, lo = phi
        return np.array(hi), np.array(lo)
    return np.array(phi)


def state_from_lpfem(y, phi, surf_to_vol, dof_dims):
    """(y, phi) of ``lpfem`` -> (y, phi) in this package's surface order."""
    perm = surface_permutation(surf_to_vol, dof_dims)
    y = np.asarray(y)
    ns = len(perm)
    out = np.empty_like(y)
    out[perm] = y[:ns]
    out[ns + perm] = y[ns:]
    return out, _copy_phi(phi)


def state_to_lpfem(y, phi, surf_to_vol, dof_dims):
    """Inverse of :func:`state_from_lpfem`."""
    perm = surface_permutation(surf_to_vol, dof_dims)
    y = np.asarray(y)
    ns = len(perm)
    return np.concatenate([y[perm], y[ns + perm]]), _copy_phi(phi)


def sharded_state_from_lpfem(y, phi_stacked, surf_to_vol, dof_dims=None):
    """(y, phi_stacked) of ``lpfem.shard.ShardedProblem`` -> the port's:
    ``y`` in this package's surface order (as :func:`state_from_lpfem`; on
    an ``H1Space`` pass ``dof_dims=None``, the orders agree) and a copy of
    the stacked potential ``[ndev, N_max+1]``, whose layout is the same in
    both (``lpfem_torch.shard.Partition`` has lpfem's tables), for
    ``lpfem_torch.shard.ShardedProblem.run(state=...)``."""
    phi = np.array(phi_stacked)
    if phi.ndim != 2:
        raise ValueError("expected a stacked [ndev, N_max+1] potential")
    if dof_dims is None:
        return np.array(y), phi
    y, _ = state_from_lpfem(y, np.zeros(0), surf_to_vol, dof_dims)
    return y, phi


def smoother_lmax(pmg) -> list[float]:
    """Per-level lambda_max of an ``lpfem.multigrid.PMultigrid`` or
    ``lpfem.shard.ShardedPMG``, read back from its Chebyshev smoothers
    (``theta + delta``), for ``lpfem_torch.multigrid.PMultigrid(lmax=...)``
    or ``lpfem_torch.shard.ShardedProblem(lmax=...)``."""
    return [float(sm.theta + sm.delta) for sm in pmg.smoothers]
