"""I/O: ParaView (VTU/PVD) output, experiment data files, checkpoints.

A NumPy copy of ``lpfem.io`` (``lpfem/io.py``), the same text byte for byte:

- a host-side VTU writer that subdivides each element into p^3 (surface:
  p^2) linear sub-cells on the GLL lattice, the "levels of detail" of MFEM's
  ``ParaViewDataCollection`` (``Solvers/PF_linear_par.cpp:433-449``), and a
  ``.pvd`` time series over the per-step files;
- append-only whitespace data files with a ``#`` header written once
  (``Convergence_and_Scaling/ss.cpp:140-148``);
- checkpoint / resume of ``[eta; phi_fs]``, the volume-potential warm start,
  the step index and the time.

The VTU writers take lpfem's ``binary`` switch (``lpfem/io.py:111-135``):
``binary=True`` (the default) writes VTK's appended raw encoding through the
native library (:func:`lpfem_torch.native.write_vtu_binary`, the same
bytes as lpfem's native writer), ``binary=False`` the ASCII text. Fields
may be NumPy arrays or tensors on any device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .ds import DS, ds_to_f64

__all__ = ["write_vtu", "write_vtu_surface", "volume_cells", "surface_cells",
           "ParaViewCollection", "DataFile", "save_checkpoint",
           "load_checkpoint"]

# VTK hex vertex order == MFEM hex order; lattice offsets of the 8 corners
_SUB_HEX = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.int64)
_SUB_QUAD = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.int64)


def _host(v) -> np.ndarray:
    """A NumPy array of ``v`` (a tensor on any device, a DS pair recombined
    to float64, or anything NumPy takes)."""
    if isinstance(v, DS):
        v = ds_to_f64(v)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _vtu_xml(points: np.ndarray, conn: np.ndarray, cell_type: int,
             point_data: dict[str, np.ndarray]) -> str:
    npts, ncell = len(points), len(conn)
    nverts = conn.shape[1]
    buf = []
    w = buf.append
    w('<?xml version="1.0"?>\n')
    w('<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">\n')
    w('<UnstructuredGrid>\n')
    w(f'<Piece NumberOfPoints="{npts}" NumberOfCells="{ncell}">\n')
    w('<Points>\n<DataArray type="Float64" NumberOfComponents="3" format="ascii">\n')
    w("\n".join(" ".join(f"{v:.16g}" for v in p) for p in points))
    w('\n</DataArray>\n</Points>\n')
    w('<Cells>\n<DataArray type="Int64" Name="connectivity" format="ascii">\n')
    w("\n".join(" ".join(str(v) for v in c) for c in conn))
    w('\n</DataArray>\n<DataArray type="Int64" Name="offsets" format="ascii">\n')
    w(" ".join(str((i + 1) * nverts) for i in range(ncell)))
    w('\n</DataArray>\n<DataArray type="UInt8" Name="types" format="ascii">\n')
    w(" ".join(str(cell_type) for _ in range(ncell)))
    w('\n</DataArray>\n</Cells>\n')
    w('<PointData>\n')
    for name, vals in point_data.items():
        w(f'<DataArray type="Float64" Name="{name}" format="ascii">\n')
        w(" ".join(f"{v:.16g}" for v in np.asarray(vals).ravel()))
        w('\n</DataArray>\n')
    w('</PointData>\n')
    w('</Piece>\n</UnstructuredGrid>\n</VTKFile>\n')
    return "".join(buf)


def volume_cells(space) -> tuple[np.ndarray, np.ndarray]:
    """GLL-subdivided linear visualization cells of a volume space:
    per-element lattice points [ne*(p+1)^3, 3] + p^3 sub-hexes per element
    (``lpfem.io.volume_cells``)."""
    p = space.p
    p1 = p + 1
    enc = space.elem_node_coords                         # [ne, p1^3, 3]
    ne = enc.shape[0]
    pts = enc.reshape(-1, 3)

    def lat(ix, iy, iz):
        return ix + p1 * (iy + p1 * iz)

    sub = []
    for iz in range(p):
        for iy in range(p):
            for ix in range(p):
                sub.append([lat(ix + o[0], iy + o[1], iz + o[2]) for o in _SUB_HEX])
    sub = np.asarray(sub)                                 # [p^3, 8]
    base = (np.arange(ne) * p1 ** 3)[:, None, None]
    conn = (base + sub[None]).reshape(-1, 8)
    return pts, conn


def surface_cells(surf) -> tuple[np.ndarray, np.ndarray]:
    """GLL-subdivided linear quad cells of a surface trace space."""
    p = surf.p
    p1 = p + 1
    ne = surf.elem_dofs.shape[0]
    pts = surf.node_coords[surf.elem_dofs].reshape(-1, 3)

    def lat(r, s):
        return r + p1 * s

    sub = []
    for s in range(p):
        for r in range(p):
            sub.append([lat(r + o[0], s + o[1]) for o in _SUB_QUAD])
    sub = np.asarray(sub)
    base = (np.arange(ne) * p1 ** 2)[:, None, None]
    conn = (base + sub[None]).reshape(-1, 4)
    return pts, conn


def _write(path: str, pts, conn, cell_type: int, pdata,
           binary: bool) -> None:
    """The binary-appended file through the native writer, or ASCII."""
    if binary:
        from .native import write_vtu_binary
        write_vtu_binary(path, pts, conn, cell_type, pdata)
        return
    with open(path, "w") as f:
        f.write(_vtu_xml(pts, conn, cell_type, pdata))


def write_vtu(path: str, space, fields: dict, binary: bool = True) -> None:
    """High-order volume output: per-element GLL lattice points, p^3
    linear sub-hexes per element. ``fields`` maps name -> dof vector
    [n_dofs]."""
    pts, conn = volume_cells(space)
    pdata = {name: _host(v)[space.elem_dofs].reshape(-1)
             for name, v in fields.items()}
    _write(path, pts, conn, 12, pdata, binary)


def write_vtu_surface(path: str, surf, fields: dict,
                      binary: bool = True) -> None:
    """Surface (quad) output on the free-surface trace space."""
    pts, conn = surface_cells(surf)
    pdata = {name: _host(v)[surf.elem_dofs].reshape(-1)
             for name, v in fields.items()}
    _write(path, pts, conn, 9, pdata, binary)


class ParaViewCollection:
    """A .pvd time-series over per-step .vtu files (MFEM
    ``ParaViewDataCollection::SetCycle/SetTime/Save`` analogue)."""

    def __init__(self, prefix: str, name: str):
        self.dir = os.path.join(prefix, name)
        os.makedirs(self.dir, exist_ok=True)
        self.name = name
        self.entries: list[tuple[float, str]] = []

    def save(self, cycle: int, time: float, writer, *args, **kw) -> str:
        fname = f"{self.name}_{cycle:06d}.vtu"
        writer(os.path.join(self.dir, fname), *args, **kw)
        self.entries.append((time, fname))
        self._write_pvd()
        return fname

    def _write_pvd(self):
        lines = ['<?xml version="1.0"?>',
                 '<VTKFile type="Collection" version="0.1">', '<Collection>']
        for t, f in self.entries:
            lines.append(f'<DataSet timestep="{t}" file="{f}"/>')
        lines += ['</Collection>', '</VTKFile>']
        with open(os.path.join(self.dir, self.name + ".pvd"), "w") as f:
            f.write("\n".join(lines))


class DataFile:
    """Append-only whitespace-separated results file with a ``#`` header
    written once (the reference's experiment-output convention,
    ``Convergence_and_Scaling/laplace-parallel-hconv.cpp:15-24``)."""

    def __init__(self, path: str, header: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            with open(path, "w") as f:
                f.write("# " + header.lstrip("# ").rstrip() + "\n")

    def append(self, *cols) -> None:
        with open(self.path, "a") as f:
            f.write(" ".join(_fmt(c) for c in cols) + "\n")

    def read(self) -> np.ndarray:
        return np.loadtxt(self.path, ndmin=2)


def _fmt(c):
    if isinstance(c, (int, np.integer)):
        return str(int(c))
    if isinstance(c, float) or isinstance(c, np.floating):
        return f"{float(c):.16g}"
    return str(c)


def save_checkpoint(path: str, step: int, t: float, y, phi, **meta) -> None:
    """Persist the complete solver state: [eta; phi_fs], the volume-potential
    warm start, step index and time. A double-single warm start (the
    ``hi_apply="ds"`` carry, a :class:`~lpfem_torch.ds.DS` pair) is
    recombined to float64, so checkpoints keep one format;
    ``Problem.run`` splits it again on resume."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, step=step, t=t, y=_host(y), phi=_host(phi),
             **{f"meta_{k}": v for k, v in meta.items()})


def load_checkpoint(path: str):
    """(step, t, y, phi, meta) as NumPy arrays, from :func:`save_checkpoint`'s
    file."""
    with np.load(path, allow_pickle=False) as z:
        meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
        return int(z["step"]), float(z["t"]), z["y"], z["phi"], meta
