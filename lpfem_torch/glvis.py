"""GLVis socket streaming.

The port of ``lpfem.glvis`` (``lpfem/glvis.py``), the reference's live
visualization (``Solvers/PF_linear_serial.cpp:438-487``): MFEM opens a
``socketstream`` to a running ``glvis`` server (default ``localhost:19916``)
and streams ``"solution\\n" << mesh << gridfunction`` once per visualization
step, plus a ``keys`` string for the initial view.

The high-order field goes out as the GLL-subdivided linear visualization
mesh (the cells :func:`lpfem_torch.io.volume_cells` /
:func:`~lpfem_torch.io.surface_cells` give ParaView) with an ``H1 P1`` grid
function, whose dofs are the mesh vertices in order, so a stock GLVis
renders it; the text is lpfem's byte for byte.

The socket is optional, as in the reference: with no GLVis server listening
the stream warns once (``RuntimeWarning``) and disables itself, and the
solver runs on (MFEM prints "Unable to connect to GLVis server" and goes on,
``PF_linear_serial.cpp:447-455``).
"""

from __future__ import annotations

import socket
import warnings

import numpy as np

from .io import _host, surface_cells, volume_cells

__all__ = ["GLVisStream", "solution_text", "parallel_solution_text"]


def _mesh_text(points: np.ndarray, conn: np.ndarray, dim: int) -> str:
    """MFEM v1.0 mesh of the linear visualization cells (hexes, or quads
    embedded in 3D)."""
    geom = 5 if conn.shape[1] == 8 else 3          # hex / quad
    buf = [f"MFEM mesh v1.0\n\ndimension\n{dim}\n\n"]
    buf.append(f"elements\n{len(conn)}\n")
    buf.extend("1 %d %s\n" % (geom, " ".join(map(str, c))) for c in conn)
    # the visualization mesh needs no boundary: GLVis derives the faces
    buf.append("\nboundary\n0\n")
    buf.append(f"\nvertices\n{len(points)}\n{points.shape[1]}\n")
    buf.extend(" ".join(f"{v:.16g}" for v in p) + "\n" for p in points)
    return "".join(buf)


def _gf_text(values: np.ndarray, dim: int) -> str:
    """MFEM GridFunction: P1 nodal values in mesh vertex order."""
    head = (f"FiniteElementSpace\nFiniteElementCollection: H1_{dim}D_P1\n"
            "VDim: 1\nOrdering: 0\n\n")
    return head + "\n".join(f"{v:.16g}" for v in np.asarray(values).ravel()) \
        + "\n"


def _cells(sp, values):
    """(points, cells, per-point values, dim) of a volume or surface
    space's visualization mesh; ``values`` expanded to every element's GLL
    lattice (shared nodes repeated, as MFEM's L-vector stream)."""
    vals = _host(values)[np.asarray(sp.elem_dofs)].reshape(-1)
    if sp.elem_dofs.shape[1] == (sp.p + 1) ** 3:       # volume space
        pts, conn = volume_cells(sp)
        return pts, conn, vals, 3
    pts, conn = surface_cells(sp)                      # surface trace space
    return pts, conn, vals, 2


def solution_text(sp, values, keys: str | None = None) -> str:
    """The ``solution`` payload of a dof vector ``values`` (a tensor on any
    device or an array) on a volume or surface space."""
    pts, conn, vals, dim = _cells(sp, values)
    txt = "solution\n" + _mesh_text(pts, conn, dim) + "\n" + _gf_text(vals,
                                                                      dim)
    if keys:
        txt += f"keys {keys}\n"
    return txt


def _piece(sp, values, nranks: int, rank: int):
    """Rank ``rank``'s contiguous element slice of the visualization cells;
    the points are per element, so the slice is a row range."""
    pts, conn, vals, dim = _cells(sp, values)
    ne, L = sp.elem_dofs.shape
    nsub = conn.shape[0] // ne
    bounds = np.linspace(0, ne, nranks + 1).astype(int)
    e0, e1 = bounds[rank], bounds[rank + 1]
    return (pts[e0 * L:e1 * L], conn[e0 * nsub:e1 * nsub] - e0 * L,
            vals[e0 * L:e1 * L], dim)


def parallel_solution_text(sp, values, nranks: int, rank: int,
                           keys: str | None = None) -> str:
    """One rank's payload of the GLVis parallel stream: the ``"parallel "
    << nranks << " " << rank`` handshake of the reference's parallel
    programs before its piece of mesh and grid function
    (``Solvers/laplace_solver_parallel.cpp:166-172``); one process plays
    every rank."""
    pts, conn, vals, dim = _piece(sp, values, nranks, rank)
    txt = (f"parallel {nranks} {rank}\n"
           "solution\n" + _mesh_text(pts, conn, dim) + "\n"
           + _gf_text(vals, dim))
    if keys and rank == 0:
        txt += f"keys {keys}\n"
    return txt


class GLVisStream:
    """A persistent connection to a GLVis server, as the reference's.

    >>> vis = GLVisStream()                   # localhost:19916
    >>> vis.send(prob.surf, eta, keys="Rjlc") # once per visualization step

    ``send`` returns True if the payload was written. A failed connection
    or write warns once and disables the stream instead of raising: the
    solver must not stop because nobody watches.
    """

    def __init__(self, host: str = "localhost", port: int = 19916,
                 timeout: float = 2.0):
        self.host, self.port, self.timeout = host, port, timeout
        self._sock: socket.socket | None = None
        self._psocks: list[socket.socket] | None = None
        self._disabled = False

    def _disable(self, what: str, err: OSError) -> None:
        warnings.warn(f"glvis: {what} {self.host}:{self.port} ({err}); live "
                      "visualization disabled", RuntimeWarning, stacklevel=3)
        self.close()
        self._disabled = True

    def _connect(self) -> bool:
        if self._sock is not None:
            return True
        if self._disabled:
            return False
        try:
            self._sock = socket.create_connection((self.host, self.port),
                                                  timeout=self.timeout)
            return True
        except OSError as e:
            self._disable("unable to connect to", e)
            return False

    def send(self, sp, values, keys: str | None = None) -> bool:
        if not self._connect():
            return False
        try:
            self._sock.sendall(solution_text(sp, values, keys=keys).encode())
            return True
        except OSError as e:
            self._disable("send failed to", e)
            return False

    def send_parallel(self, sp, values, nranks: int,
                      keys: str | None = None) -> bool:
        """``nranks`` pieces over one connection per rank, the reference's
        parallel handshake (``Solvers/laplace_solver_parallel.cpp:
        166-172``); the connections persist across sends."""
        if self._disabled:
            return False
        if self._psocks is None or len(self._psocks) != nranks:
            self.close()
            socks = []
            try:
                for _ in range(nranks):
                    socks.append(socket.create_connection(
                        (self.host, self.port), timeout=self.timeout))
            except OSError as e:
                for s in socks:
                    s.close()
                self._disable("unable to connect to", e)
                return False
            self._psocks = socks
        try:
            for rank, s in enumerate(self._psocks):
                s.sendall(parallel_solution_text(
                    sp, values, nranks, rank, keys=keys).encode())
            return True
        except OSError as e:
            self._disable("send failed to", e)
            return False

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
        for s in self._psocks or []:
            try:
                s.close()
            except OSError:
                pass
        self._psocks = None
