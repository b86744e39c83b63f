"""The p-multigrid's Chebyshev coarse solve in one launch: CUDA kernel
wrapper and its plain mirror.

``z ~= A^-1 r`` on a p = 1 level of curved hexes (the full metric ``G6q``,
q = 2), from zero, with the polynomial of
:class:`lpfem_torch.multigrid.ChebyshevSmoother` and the free-surface rows
of ``ElementLaplace.constrained_apply_top``: the same linear operator as
the eager chain of ``degree - 1`` applies, in one launch of
``csrc/coarse_cheb.cu`` (one thread-block cluster that keeps the level in
its shared memory for every step).

- :func:`partition` cuts the level once on the host: block b of the
  cluster owns a contiguous range of elements and a range of dofs (the dofs
  ordered by their first holder element, cut into equal ranges), and gets
  its tables: the node addresses of its elements, the fold table of its
  dofs (every copy's holder and slot, in ascending element order, as
  ``operators._fold_table``) and its dofs' global numbers.
- :class:`CoarseChebyshev` holds one level's tables and coefficients on its
  device and is the coarse solve ``PMultigrid`` calls on the fused route;
  :meth:`CoarseChebyshev.for_level` decides whether a level takes it: a
  full-metric ``ElementLaplace`` in mode ``"pallas"`` on a CUDA device that
  :func:`fits` (p = 1, q = 2, float32 / float64, one cluster of
  ``CLUSTER`` blocks with the metric in shared memory within one block's
  budget). :func:`coarse_cheb` launches the kernel for a CUDA tensor and
  counts each launch in ``LAUNCHES`` (by dtype name), and runs
  :func:`coarse_cheb_mirror` for a CPU tensor.
- :func:`coarse_cheb_mirror` is the kernel's decomposition in plain
  PyTorch: the blocks' z, the per-block E-vectors (the element operator in
  the column body's stages, ``pa_apply.pa_apply_element_mirror``), the fold
  in holder order and the smoother's update expression.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..operators import ElementLaplace
from .pa_apply import pa_apply_element_mirror

__all__ = ["LAUNCHES", "CoarseChebyshev", "Tables", "chebyshev_coefficients",
           "coarse_cheb", "coarse_cheb_mirror", "fits", "partition",
           "smem_bytes"]

LAUNCHES: dict[str, int] = {}       # kernel launches by dtype name

CLUSTER = 16              # blocks of the cluster (the non-portable size)
SMEM_BUDGET = 232_448     # shared memory one H100 block can take (227 KB)
MAX_DEGREE = 32           # csrc/coarse_cheb.cu kMaxSteps + 1
NODES, METRIC = 8, 48     # (p+1)^3 and 6 q^3 at p = 1, q = 2
RANK_SHIFT = 20           # an address is rank << RANK_SHIFT | slot
ESS = -2                  # fold-table mark of a free-surface dof


class Tables(NamedTuple):
    """One level's partition over a cluster of C blocks (int32).

    ``eaddr [C, 8, ne_max]``: block b's element el, node j: the owner's rank
    << 20 | the dof's slot in the owner, -1 on the free surface (read as
    zero) and in pads. ``ftab [C, m, nd_max]``: block b's dof i, copy j: the
    holder's rank << 20 | the slot ``j' * ne_max + el`` of the copy in the
    holder's E-vector, in ascending element order; -1 pads; ``ESS`` in row
    0 of a free-surface dof. ``gdof [C, nd_max]``: the dofs' global numbers
    (-1 pads). ``counts [C, 2]``: elements and dofs of each block.
    ``elem_start [C + 1]``: the element ranges."""

    eaddr: np.ndarray
    ftab: np.ndarray
    gdof: np.ndarray
    counts: np.ndarray
    elem_start: np.ndarray


def _sizes(ne: int, n_dofs: int, clusters: int = CLUSTER) -> tuple[int, int]:
    """(ne_max, nd_max) of the partition into ``clusters`` blocks (nd_max
    rounded up to a multiple of 4: every table row 16-byte aligned)."""
    ne_max = -(-ne // clusters)
    nd_max = -(-n_dofs // clusters)
    return ne_max, -(-nd_max // 4) * 4


def smem_bytes(value_bytes: int, ne_max: int, nd_max: int, mult: int) -> int:
    """Shared memory of one block (``csrc/coarse_cheb.cu`` smem_bytes): z,
    r, d, inv_diag, the E-vector, the metric; the node addresses and the
    fold table."""
    return (value_bytes * (4 * nd_max + (NODES + METRIC) * ne_max)
            + 4 * (NODES * ne_max + mult * nd_max))


def fits(ne: int, n_dofs: int, p: int, q: int, dtype: torch.dtype,
         mult: int = 8) -> bool:
    """Whether a level of ``ne`` elements and ``n_dofs`` dofs (at most
    ``mult`` copies of a dof) can take the kernel: p = 1, q = 2, float32
    or float64, and one block of the ``CLUSTER`` within its shared
    memory."""
    if not (p == 1 and q == 2 and dtype in (torch.float32, torch.float64)
            and ne > 0):
        return False
    vb = torch.tensor([], dtype=dtype).element_size()
    return smem_bytes(vb, *_sizes(ne, n_dofs), mult) <= SMEM_BUDGET


def chebyshev_coefficients(theta: float, delta: float,
                           degree: int) -> list[tuple[float, float]]:
    """``(rho_new * rho, 2 rho_new / delta)`` of each step after the first,
    in the float arithmetic of ``ChebyshevSmoother.__call__``."""
    sigma = theta / delta
    rho = 1.0 / sigma
    out = []
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        out.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    return out


def partition(elem_dofs: np.ndarray, fold_table: np.ndarray,
              ess: np.ndarray, clusters: int) -> Tables:
    """The tables of the level with element table ``elem_dofs [ne, 8]``,
    its fold table (``operators._fold_table``: every dof's copies as
    positions in the flattened E-vector, ascending, padded with
    ``elem_dofs.size``) and free-surface dofs ``ess``, over ``clusters``
    blocks."""
    ed = np.asarray(elem_dofs)
    tab = np.asarray(fold_table)
    ne, L = ed.shape
    n, m = tab.shape
    if L != NODES:
        raise ValueError(f"elements of {L} nodes: the kernel takes p = 1")
    if not 1 <= clusters <= 16:
        raise ValueError(f"{clusters} blocks: the kernel takes 1 to 16")
    C = clusters
    ne_max, nd_max = _sizes(ne, n, C)
    elem_start = (np.arange(C + 1) * ne) // C
    blk = np.repeat(np.arange(C), np.diff(elem_start))       # [ne]
    el = np.arange(ne) - elem_start[blk]
    # each dof's first holder is its first copy's element; dofs ordered by
    # it (then by number) and cut into C equal ranges
    first = tab[:, 0] // L
    if np.any(tab[:, 0] >= ed.size):
        raise ValueError("a dof that no element holds")
    order = np.argsort(first, kind="stable")
    d_start = (np.arange(C + 1) * n) // C
    owner = np.empty(n, dtype=np.int64)
    slot = np.empty(n, dtype=np.int64)
    pos_blk = np.repeat(np.arange(C), np.diff(d_start))
    owner[order] = pos_blk
    slot[order] = np.arange(n) - d_start[pos_blk]
    gdof = np.full((C, nd_max), -1, dtype=np.int32)
    gdof[owner, slot] = np.arange(n)

    is_ess = np.zeros(n, dtype=bool)
    is_ess[np.asarray(ess)] = True
    addr = (owner << RANK_SHIFT) | slot
    node_addr = np.where(is_ess[ed], -1, addr[ed])            # [ne, 8]
    eaddr = np.full((C, NODES, ne_max), -1, dtype=np.int32)
    eaddr[blk[:, None], np.arange(NODES)[None, :], el[:, None]] = node_addr

    valid = tab < ed.size
    tc = np.where(valid, tab, 0)
    e, j = tc // L, tc % L
    copy_addr = (blk[e] << RANK_SHIFT) | (j * ne_max + el[e])
    copy_addr = np.where(valid, copy_addr, -1)
    copy_addr[is_ess] = -1
    copy_addr[is_ess, 0] = ESS
    ftab = np.full((C, m, nd_max), -1, dtype=np.int32)
    ftab[owner[:, None], np.arange(m)[None, :], slot[:, None]] = copy_addr

    counts = np.stack([np.diff(elem_start), np.diff(d_start)],
                      axis=1).astype(np.int32)
    return Tables(eaddr, ftab, gdof, counts, elem_start)


@functools.lru_cache(maxsize=None)
def _entry(name: str, dtype: torch.dtype):
    """The library's C entry ``coarse_cheb_<name>`` for ``dtype`` (built
    at first use)."""
    from ._build import load_library
    lib = load_library("coarse_cheb")
    fn = getattr(lib, f"coarse_cheb{name}_"
                      f"{'f32' if dtype == torch.float32 else 'f64'}")
    if name == "_clusters":
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    else:
        fn.argtypes = ([ctypes.c_void_p] * 10
                       + [ctypes.POINTER(ctypes.c_double)]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_schedulable(clusters: int, ne_max: int, nd_max: int, mult: int,
                       dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless the card can hold one cluster of this layout
    (``cudaOccupancyMaxActiveClusters`` at least 1)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _entry("_clusters", dtype)(clusters, ne_max, nd_max, mult,
                                        ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"coarse_cheb occupancy query failed: CUDA error "
                           f"{rc}")
    if out.value < 1:
        raise RuntimeError(f"coarse_cheb: the card cannot schedule a cluster "
                           f"of {clusters} blocks with {ne_max} elements and "
                           f"{nd_max} dofs a block")


class CoarseChebyshev:
    """The Chebyshev coarse solve of one p = 1 level with the full metric
    (an ``ElementLaplace`` ``op`` and its constrained Jacobi inverse
    diagonal), the polynomial of ``chebyshev`` (a ``ChebyshevSmoother`` on
    the same level, kept as ``.chebyshev``), over ``clusters`` blocks (the
    kernel's ``CLUSTER``; the mirror takes 1 to 16). Called on ``r``,
    returns z from zero. On a CUDA device, raises where the card cannot
    schedule the cluster."""

    @classmethod
    def for_level(cls, op, inv_diag: torch.Tensor,
                  chebyshev) -> "CoarseChebyshev | None":
        """The fused coarse solve of the bottom level ``op``, or None where
        the kernel does not apply: ``op`` is not a full-metric
        ``ElementLaplace`` in mode ``"pallas"`` on a CUDA device, the degree
        is past ``MAX_DEGREE``, or the level does not :func:`fits`."""
        if not (isinstance(op, ElementLaplace) and op.C64 is None
                and op.mode == "pallas" and op.device.type == "cuda"
                and chebyshev.degree <= MAX_DEGREE
                and fits(op.space.elem_dofs.shape[0], op.n_dofs, op.p, op.q,
                         op.dtype, op.fold.shape[1])):
            return None
        return cls(op, inv_diag, chebyshev)

    def __init__(self, op, inv_diag: torch.Tensor, chebyshev,
                 clusters: int = CLUSTER):
        if not 1 <= chebyshev.degree <= MAX_DEGREE:
            raise ValueError(f"degree {chebyshev.degree}: the kernel takes "
                             f"1 to {MAX_DEGREE}")
        self.chebyshev = chebyshev
        self.clusters = clusters
        self.theta = chebyshev.theta
        self.coefs = chebyshev.coefs
        self.n_dofs = op.n_dofs
        self.dtype, dev = op.dtype, op.device
        t = partition(op.space.elem_dofs, op.fold.cpu().numpy(),
                      op.space.top_plane_dofs(), clusters)
        ne_max = t.eaddr.shape[2]
        self.mult, self.nd_max = t.ftab.shape[1:]
        if dev.type == "cuda":
            _check_schedulable(clusters, ne_max, self.nd_max, self.mult,
                               self.dtype, dev)
        self.tables = Tables(*(torch.as_tensor(a, device=dev)
                               for a in t[:4]), t.elem_start)
        self.B, self.D = op.B, op.D
        # the metric [C, 48, ne_max] and inv_diag [C, nd_max] by block
        blk = np.repeat(np.arange(clusters), np.diff(t.elem_start))
        slots = blk * ne_max + np.arange(len(blk)) - t.elem_start[blk]
        g = op.G6q.new_zeros(clusters * ne_max, METRIC)
        g[torch.as_tensor(slots, device=dev)] = op.G6q
        self.g6b = g.view(clusters, ne_max, METRIC).transpose(1, 2) \
            .contiguous()
        gd = self.tables.gdof.long()
        self.invd_b = torch.where(gd >= 0, inv_diag[gd.clamp(min=0)],
                                  inv_diag.new_zeros(()))
        self._coef_array = (ctypes.c_double * (1 + 2 * len(self.coefs)))(
            self.theta, *(c for c, _ in self.coefs),
            *(c for _, c in self.coefs))

    @property
    def degree(self) -> int:
        return self.chebyshev.degree

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return coarse_cheb(r, self)


def coarse_cheb_mirror(r: torch.Tensor, cc: CoarseChebyshev) -> torch.Tensor:
    """The kernel's decomposition in plain PyTorch, on ``cc``'s tables: the
    blocks' z, r, d, inv_diag [C, nd_max]; per step the node values read
    through ``eaddr`` (zero on the free surface), the elements' E-vectors
    [C, 8, ne_max], the fold through ``ftab`` copy by copy in holder order
    (z on the free surface), and the smoother's update."""
    eaddr, ftab, gdof, _ = (t.long() for t in cc.tables[:4])
    C, L, ne_max = eaddr.shape
    mask = (1 << RANK_SHIFT) - 1
    zero = r.new_zeros(())
    own = gdof >= 0
    rl = torch.where(own, r[gdof.clamp(min=0)], zero)
    il = cc.invd_b
    z = il * rl / cc.theta
    d = z
    e_ok, f_ok = eaddr >= 0, ftab >= 0
    e_rank = torch.where(e_ok, eaddr >> RANK_SHIFT, 0)
    e_slot = torch.where(e_ok, eaddr & mask, 0)
    f_rank = torch.where(f_ok, ftab >> RANK_SHIFT, 0)
    f_slot = torch.where(f_ok, ftab & mask, 0)
    ess = ftab[:, 0] == ESS
    G = cc.g6b.transpose(1, 2).reshape(C * ne_max, METRIC)
    for c1, c2 in cc.coefs:
        u = torch.where(e_ok, z[e_rank, e_slot], zero)           # [C, 8, ne]
        ye = pa_apply_element_mirror(u.transpose(1, 2).reshape(-1, L), G,
                                     cc.B, cc.D)
        ev = ye.view(C, ne_max, L).transpose(1, 2).reshape(C, L * ne_max)
        y = torch.zeros_like(z)
        for j in range(ftab.shape[1]):
            y = y + torch.where(f_ok[:, j], ev[f_rank[:, j], f_slot[:, j]],
                                zero)
        y = torch.where(ess, z, y)
        d = c1 * d + c2 * (il * (rl - y))
        z = z + d
    out = r.new_zeros(cc.n_dofs)
    out[gdof[own]] = z[own]
    return out


def coarse_cheb(r: torch.Tensor, cc: CoarseChebyshev) -> torch.Tensor:
    """z ~= A^-1 r on ``cc``'s level: the CUDA kernel for a CUDA tensor (one
    launch, counted in ``LAUNCHES``), the mirror for a CPU tensor."""
    if r.device.type == "cpu":
        return coarse_cheb_mirror(r, cc)
    if r.device.type != "cuda":
        raise ValueError(f"coarse_cheb: unsupported device {r.device}")
    if r.dim() != 1 or not r.is_contiguous() or r.shape[0] != cc.n_dofs:
        raise ValueError(f"r must be a contiguous vector of {cc.n_dofs} "
                         f"values, got {tuple(r.shape)}")
    if r.dtype != cc.dtype or r.device != cc.g6b.device:
        raise ValueError("r must match the level in dtype and device")
    ea, ft, gd, counts = cc.tables[:4]
    ne_max = ea.shape[2]
    with torch.cuda.device(r.device):
        z = torch.empty_like(r)
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = _entry("", r.dtype)(
            cc.g6b.data_ptr(), ea.data_ptr(), ft.data_ptr(), gd.data_ptr(),
            cc.invd_b.data_ptr(), counts.data_ptr(), r.data_ptr(),
            cc.B.data_ptr(), cc.D.data_ptr(), z.data_ptr(), cc._coef_array,
            len(cc.coefs), cc.clusters, ne_max, cc.nd_max, cc.mult, stream)
    if rc != 0:
        raise RuntimeError(f"coarse_cheb kernel launch failed: CUDA error "
                           f"{rc}")
    name = str(r.dtype).removeprefix("torch.")
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
    return z
