"""The x-periodic wave tank meshed with leaning (sheared) elements.

Every vertex of the Cartesian tank is moved by ``x += slope * z`` (lean
``"z"``) or ``x += slope * y`` (lean ``"y"``) with ``slope = 0.5 hx / h``,
half an element width per element height. With periodic x this is the same
physical tank — flat bottom, top and side walls, the periodic translation
unchanged — so the Airy wave is still the exact solution; but the elements
are parallelepipeds, not boxes, so the Kronecker operator does not apply and
the affine kernels run: with the element lattice declared on the mesh the
fused lattice kernel, and after a trip through a mesh file (which keeps no
lattice) the per-element affine kernel. Give such a run its wave by
wavelength: ``wave_by="modes"`` reads the tank length off the bounding box,
which the lean widens.

``python -m lpfem_torch.experiments.leaning_tank out.mesh --lean y`` writes
the ss.cpp tank (``scaling_base``: 32 x 2 x 8 hexes) leaning along y as an
MFEM mesh file.
"""

from __future__ import annotations

import argparse
from dataclasses import replace

import numpy as np

from ..configs import preset
from ..mesh import Mesh, make_wave_tank, save_mfem

__all__ = ["declare_lattice", "shear_x", "leaning_tank"]


def declare_lattice(mesh: Mesh) -> Mesh:
    """The mesh with ``elem_lattice`` / ``lattice_dims`` declared from its
    element centroids, which must form a tensor product (an unsheared
    Cartesian mesh, element axes along the coordinate axes)."""
    cen = mesh.corner_coords.mean(axis=1)
    idx, dims = [], []
    for a in range(3):
        u, inv = np.unique(np.round(cen[:, a], 9), return_inverse=True)
        idx.append(inv)
        dims.append(len(u))
    el = np.stack(idx, axis=1).astype(np.int64)
    lin = el[:, 0] + dims[0] * (el[:, 1] + dims[1] * el[:, 2])
    if len(np.unique(lin)) != mesh.n_elems or np.prod(dims) != mesh.n_elems:
        raise ValueError("the element centroids are not a tensor product")
    return replace(mesh, elem_lattice=el, lattice_dims=tuple(dims))


def shear_x(mesh: Mesh, axis: int, slope: float) -> Mesh:
    """The mesh with ``x += slope * coordinate[axis]`` at every vertex
    (topological and per-element positions alike)."""
    verts = mesh.verts.copy()
    verts[:, 0] += slope * verts[:, axis]
    cc = mesh.corner_coords.copy()
    cc[..., 0] += slope * cc[..., axis]
    return replace(mesh, verts=verts, corner_coords=cc)


def leaning_tank(nx: int, ny: int, nz: int, Lx: float, Ly: float, Lz: float,
                 ref_levels: int = 0, lean: str = "z",
                 declare: bool = True) -> Mesh:
    """The x-periodic ``nx x ny x nz`` tank, refined ``ref_levels`` times,
    then leaning along ``lean`` (``"z"`` or ``"y"``); ``declare`` puts the
    element lattice on the mesh record."""
    if lean not in ("y", "z"):
        raise ValueError(f"lean must be 'y' or 'z', got {lean!r}")
    mesh = make_wave_tank(nx, ny, nz, Lx, Ly, Lz)
    for _ in range(ref_levels):
        mesh = mesh.uniform_refine()
    if declare:
        mesh = declare_lattice(mesh)
    hx = Lx / nx
    axis, h = (2, Lz / nz) if lean == "z" else (1, Ly / ny)
    return shear_x(mesh, axis, 0.5 * hx / h)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="MFEM mesh file to write")
    ap.add_argument("--lean", default="y", choices=["y", "z"])
    args = ap.parse_args(argv)
    cfg = preset("scaling_base")
    save_mfem(leaning_tank(cfg.nx, cfg.ny, cfg.nz, cfg.Lx, cfg.Ly, cfg.Lz,
                           lean=args.lean, declare=False), args.out)


if __name__ == "__main__":
    main()
