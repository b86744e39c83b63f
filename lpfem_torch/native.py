"""Native (C++) host library: dof numbering, binary VTU, Gmsh parsing.

The twin of ``lpfem.native`` (``lpfem/native/__init__.py:76-161``) over the
port's own copy of its sources, ``csrc/dofs.cpp`` and ``csrc/vtuio.cpp``,
built with g++ at first use into ``build/lpfem_torch/`` (named by a hash of
the sources; :func:`lpfem_torch.kernels._build.load_host_library`).

Unlike lpfem, nothing here switches silently to NumPy: lpfem's native
numbering permutes the dof ids against its NumPy one, so a port that fell
back where lpfem did not would number differently without saying so. A
missing g++ or a failed build raises, and so does a call the library
refuses.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

__all__ = ["build_hex_dofs", "write_vtu_binary", "parse_gmsh"]

_SOURCES = ("dofs.cpp", "vtuio.cpp")

_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The library, built at first use, with its entries declared."""
    from .kernels._build import load_host_library
    lib = load_host_library("lpfem_native", _SOURCES)
    lib.lpfem_build_hex_dofs.restype = ctypes.c_int64
    lib.lpfem_build_hex_dofs.argtypes = [
        _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _i64p]
    lib.lpfem_write_vtu.restype = ctypes.c_int64
    lib.lpfem_write_vtu.argtypes = [
        ctypes.c_char_p, _f64p, ctypes.c_int64, _i64p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p,
        ctypes.POINTER(_f64p), ctypes.c_int64]
    lib.lpfem_gmsh_open.restype = ctypes.c_void_p
    lib.lpfem_gmsh_open.argtypes = [ctypes.c_char_p]
    lib.lpfem_gmsh_counts.restype = ctypes.c_int64
    lib.lpfem_gmsh_counts.argtypes = [ctypes.c_void_p, _i64p]
    lib.lpfem_gmsh_fill.restype = ctypes.c_int64
    lib.lpfem_gmsh_fill.argtypes = [ctypes.c_void_p, _f64p, _i64p, _i64p,
                                    _i64p]
    lib.lpfem_gmsh_free.restype = None
    lib.lpfem_gmsh_free.argtypes = [ctypes.c_void_p]
    return lib


def build_hex_dofs(elems: np.ndarray, n_verts: int,
                   p: int) -> tuple[np.ndarray, int]:
    """Topological H1 dof numbering of the hexes ``elems [ne, 8]``:
    ``(elem_dofs [ne, (p+1)^3] int64, lattice-lex, x fastest; n_dofs)``.
    Edge and face ids in first-encounter order, so the ids are a
    permutation of :func:`lpfem_torch.space.build_hex_dofs`'s NumPy ones;
    every topological invariant (sharing pattern, counts) is the same."""
    elems = np.ascontiguousarray(elems, dtype=np.int64)
    if elems.ndim != 2 or elems.shape[1] != 8:
        raise ValueError(f"elems of shape {elems.shape}, expected [ne, 8]")
    if p < 1:
        raise ValueError(f"order p = {p} < 1")
    ne = elems.shape[0]
    out = np.zeros((ne, (p + 1) ** 3), dtype=np.int64)
    n = _lib().lpfem_build_hex_dofs(elems.ctypes.data_as(_i64p), ne,
                                    int(n_verts), int(p),
                                    out.ctypes.data_as(_i64p))
    if n < 0:
        raise RuntimeError("lpfem_build_hex_dofs refused the mesh")
    return out, int(n)


def write_vtu_binary(path: str, points: np.ndarray, conn: np.ndarray,
                     cell_type: int, fields: dict) -> None:
    """Binary-appended VTU (raw little-endian blocks) of the cells ``conn
    [ncell, nverts]`` on ``points [npts, 3]`` with the point fields
    ``fields`` (name -> [npts]); MFEM's ``ParaViewDataCollection`` in the
    reference (``Solvers/PF_linear_par.cpp:433-449``)."""
    points = np.ascontiguousarray(points, dtype=np.float64)
    conn = np.ascontiguousarray(conn, dtype=np.int64)
    npts = points.shape[0]
    ncell, nverts = conn.shape
    names = list(fields)
    arrs = [np.ascontiguousarray(np.asarray(fields[k]).ravel(),
                                 dtype=np.float64) for k in names]
    for name, a in zip(names, arrs):
        if a.shape[0] != npts:
            raise ValueError(f"field {name!r} of {a.shape[0]} values for "
                             f"{npts} points")
    fnames = b"\0".join(n.encode() for n in names) + b"\0"
    fptrs = (_f64p * max(len(arrs), 1))(
        *[a.ctypes.data_as(_f64p) for a in arrs])
    rc = _lib().lpfem_write_vtu(
        str(path).encode(), points.ctypes.data_as(_f64p), npts,
        conn.ctypes.data_as(_i64p), ncell, nverts, int(cell_type), fnames,
        fptrs, len(arrs))
    if rc != 0:
        raise OSError(f"lpfem_write_vtu failed for {path} (code {rc})")


def parse_gmsh(path: str):
    """Gmsh v2.2 ``.msh``: ``(verts [nn, 3], hexes [nh, 8], quads [nq, 4],
    qtags [nq])`` with node ids remapped to 0..nn-1 in ascending id order
    and the physical tag of every quad (``lpfem_torch.mesh.
    parse_gmsh_python`` computes the same)."""
    lib = _lib()
    h = lib.lpfem_gmsh_open(str(path).encode())
    if not h:
        raise OSError(f"cannot parse {path} as a Gmsh v2.2 mesh")
    try:
        counts = np.zeros(3, dtype=np.int64)
        if lib.lpfem_gmsh_counts(h, counts.ctypes.data_as(_i64p)) != 0:
            raise OSError(f"cannot parse {path} as a Gmsh v2.2 mesh")
        nn, nh, nq = (int(c) for c in counts)
        verts = np.zeros((nn, 3))
        hexes = np.zeros((nh, 8), dtype=np.int64)
        quads = np.zeros((max(nq, 1), 4), dtype=np.int64)
        qtags = np.zeros(max(nq, 1), dtype=np.int64)
        if lib.lpfem_gmsh_fill(h, verts.ctypes.data_as(_f64p),
                               hexes.ctypes.data_as(_i64p),
                               quads.ctypes.data_as(_i64p),
                               qtags.ctypes.data_as(_i64p)) != 0:
            raise OSError(f"cannot parse {path} as a Gmsh v2.2 mesh")
        return verts, hexes, quads[:nq], qtags[:nq]
    finally:
        lib.lpfem_gmsh_free(h)
