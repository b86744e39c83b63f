"""Domain decomposition: the sharded solver of ``lpfem.shard`` with its shards
stacked on the leading axis of tensors on one device.

Counterpart of ``lpfem/shard.py`` (the reference's MPI domain decomposition,
``ParMesh`` + hypre, SURVEY.md section 2; its contract is mpirun rank-count
invariance, ``Convergence_and_Scaling/ss.sh``). lpfem runs one program per
device under ``shard_map``, each device seeing its ``[N_max+1]`` slice of
arrays that are globally ``[ndev, N_max+1]``; here that global view is the
data structure:

- A sharded vector is one tensor ``[ndev, N_max+1]``: row d is shard d's
  owned block in its local numbering, lane ``N_max`` the trash lane, always
  0. Vector algebra acts on the stacked tensor; the dot of two sharded
  vectors is a sum of per-shard dots (lpfem's ``pdot``), which
  ``solvers.pcg`` / ``pcg_ir`` take as ``dot_fn``.
- The two collectives are index operations on stacked buffers, kept in
  :class:`ShardComm`: ``psum`` sums a ``[ndev, ...]`` buffer over the shards,
  ``shift`` moves rows between neighbouring shards as lpfem's ``ppermute``
  does (``fwd``: d -> d+1, ``fwd_rev``: d -> d-1, ``wrap``: 0 -> ndev-1,
  ``wrap_rev``: ndev-1 -> 0; a shard that receives nothing gets zeros).
- Kernels run once over every shard: the lattice kernels' shard modes
  (``kernels.sep_apply.sep_apply_shard``, B1; ``kernels.lattice_apply.
  lattice_affine_apply_shard``, B2) take the stacked windows in one launch,
  and the element kernels (B3a, B3b) take the stacked E-vectors.

Modules, in lpfem's order: :class:`Partition` (element slabs, dof ownership,
the z-slab *window* layout and the compact owner-major layout, the interface
set S and every index table), :class:`ShardedExchange` (the halo exchange
through ``psum`` or neighbour shifts, the window halo plane, E-vector gather
and fold), :class:`ShardedLevel` (one operator over a partition: B1-shard on
separable window levels, B2-shard on sheared window levels, else the element
kernels on per-shard E-vectors), :class:`ShardedPMG` (the p-multigrid with
h-levels, each level over the same element slabs), and
:class:`ShardedProblem` (the RK4 time loop; ``from_config`` builds the
tables on the host and places them on the device).

Under ``apply_mode="assembled"`` the fine level is the ELL level
(``ShardedLevel(..., ell=True)``): each shard's partial assembly over its
local layout, applied through the same exchange.

Shards as processes: under a :class:`GroupComm` (one shard per rank of an
initialised ``torch.distributed`` group; ``lpfem_torch.dist`` launches the
ranks) every rank builds the same host tables and keeps its own row, so a
sharded vector is ``[1, N_max+1]`` and every stacked code path keeps its
shapes. The exchange then takes the collectives (``psum`` an all-reduce,
``shift`` one send / receive pair per direction) in place of the compiled
routes, which index across every shard's lanes; the lattice kernels' shard
modes take the rank's one window. NCCL with one rank per card is not
ported (it needs two or more cards).
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from . import resolve_device
from .elements import basis_1d
from .geometry import affine_c6, surface_elements, top_trace_geometry
from .kernels.lattice_apply import lattice_affine_apply_shard
from .kernels.pa_apply import pa_apply_affine, pa_apply_element
from .kernels.sep_apply import check_scal, sep_apply_shard
from .multigrid import (ChebyshevSmoother, VCycle, _ElementTransfer,
                        estimate_lmax, interp_3d, p_orders)
from .operators import (AffineLatticeLaplace, ElementLaplace,
                        SeparableLattice, _fold_table, _reference_matrices,
                        assemble_csr, element_source, laplace_operator,
                        separable_spacings)
from .profiling import span
from .space import _top_plane_dofs
from .surface import SolveCarry, SolveStats
from .timestep import rk4_run

__all__ = ["ShardComm", "GroupComm", "Partition", "ShardedExchange",
           "ShardedLevel", "ShardedPMG", "ShardedProblem"]


def _zslab_layers(part: np.ndarray, elem_dims, ndev: int):
    """Per-shard ``(ez0, n_layers)`` if ``part`` is a contiguous z-layer slab
    partition of the element lattice (every shard owns whole, consecutive
    element layers, each at least one), else ``None``
    (``lpfem/shard.py:79-97``)."""
    nex, ney, nez = elem_dims
    if len(part) != nex * ney * nez:
        return None
    p3 = part.reshape(nez, ney, nex)
    layer_dev = p3[:, 0, 0]
    if not np.all(p3 == layer_dev[:, None, None]):
        return None
    if np.any(np.diff(layer_dev) != np.clip(np.diff(layer_dev), 0, 1)):
        return None
    nlay = np.bincount(layer_dev, minlength=ndev)
    if len(nlay) != ndev or np.any(nlay < 1):
        return None
    ez0 = np.concatenate([[0], np.cumsum(nlay)[:-1]])
    return ez0, nlay


def _centroids(space) -> np.ndarray:
    """[ne, 3] element centroids: the mean of the 8 corners (lpfem's
    ``mesh.corner_coords.mean(axis=1)``)."""
    mesh = getattr(space, "mesh", None)
    if mesh is not None:
        return mesh.corner_coords.mean(axis=1)
    return space.geometry_lattice()[0].mean(axis=1)       # box corners


def _node_mult(space) -> np.ndarray:
    """[n_dofs] float64: the elements sharing each dof."""
    return np.bincount(np.asarray(space.elem_dofs).ravel(),
                       minlength=space.n_dofs).astype(np.float64)


class ShardComm:
    """The collectives of ``lpfem.shard`` over shards stacked on the leading
    axis of tensors on one device. :class:`GroupComm` is its twin over a
    process group. ``rows`` shards, from shard ``first`` on, are held by
    this process: every shard here."""

    stacked = True

    def __init__(self, ndev: int):
        self.ndev = ndev
        self.rows = ndev
        self.first = 0

    def local(self, arr):
        """The rows of a host table ``[ndev, ...]`` held by this process."""
        return arr[self.first:self.first + self.rows]

    def psum(self, buf: torch.Tensor) -> torch.Tensor:
        """``[rows, ...]`` -> ``[...]``: the sum over shards, which every
        shard reads (``jax.lax.psum``)."""
        return buf.sum(0)

    def shift(self, send: torch.Tensor, kind: str) -> torch.Tensor:
        """Row d of the result is what shard d receives from ``send``'s rows
        under lpfem's permutation ``kind`` (``lpfem/shard.py:468-476``);
        zeros where it receives nothing."""
        n = self.ndev
        out = torch.zeros_like(send)
        if kind == "fwd":                    # owner d -> toucher d+1
            out[1:] = send[:-1]
        elif kind == "fwd_rev":
            out[:-1] = send[1:]
        elif kind == "wrap":                 # owner 0 -> toucher ndev-1
            out[n - 1] = send[0]
        elif kind == "wrap_rev":
            out[0] = send[n - 1]
        else:
            raise ValueError(f"unknown permutation {kind!r}")
        return out

    def pdot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The dot of two sharded vectors (lpfem's ``pdot``, the psum of
        per-shard dots): on stacked shards one dot over every lane."""
        return torch.dot(a.reshape(-1), b.reshape(-1))

    def all_true(self, flag: torch.Tensor) -> torch.Tensor:
        """A boolean flag of this process -> true iff it holds on every
        shard."""
        return flag


def _peers(kind: str, r: int, n: int) -> tuple:
    """(rank sent to, rank received from) of rank ``r`` of ``n`` under
    lpfem's permutation ``kind``; ``None`` for no peer."""
    last = n - 1
    if kind == "fwd":                    # owner d -> toucher d+1
        return (r + 1 if r < last else None, r - 1 if r > 0 else None)
    if kind == "fwd_rev":
        return (r - 1 if r > 0 else None, r + 1 if r < last else None)
    if kind == "wrap":                   # owner 0 -> toucher ndev-1
        return (last if r == 0 else None, 0 if r == last else None)
    if kind == "wrap_rev":
        return (0 if r == last else None, last if r == 0 else None)
    raise ValueError(f"unknown permutation {kind!r}")


class GroupComm(ShardComm):
    """:class:`ShardComm` over the initialised default ``torch.distributed``
    process group, one shard per rank: each rank holds its shard as a
    leading axis of length 1. ``psum`` and ``pdot`` are a sum
    ``all_reduce``; ``shift`` is one send / receive pair per rank, posted
    together
    (``batch_isend_irecv``) under lpfem's permutations. Every collective
    is staged through host tensors (pinned, for CUDA tensors): gloo is
    handed no CUDA tensor. The blocking copy to the host orders each
    collective after the device work that made its input.

    ``calls`` counts the collectives by kind; with ``timing`` set, CUDA
    events (the host clock on the CPU) bracket each one, from its copy to
    the host to its copy back, and :meth:`exchange_seconds` sums them."""

    stacked = False

    def __init__(self, timing: bool = False):
        import torch.distributed as dist
        self._dist = dist
        self.ndev = dist.get_world_size()
        self.rank = dist.get_rank()
        self.rows, self.first = 1, self.rank
        self.timing = timing
        self.calls: dict[str, int] = {}
        self._spans: list = []
        self._host_s = 0.0

    # ---------------------------------------------------------- staging
    def _begin(self, kind: str, like: torch.Tensor):
        self.calls[kind] = self.calls.get(kind, 0) + 1
        if not self.timing:
            return None
        if like.is_cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _end(self, start) -> None:
        if start is None:
            return
        if isinstance(start, float):
            self._host_s += time.perf_counter() - start
        else:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._spans.append((start, ev))

    def exchange_seconds(self) -> float:
        """Seconds inside the collectives since the last call (``timing``
        only): device time from each collective's copy to the host to its
        copy back, during which the rank's stream waits."""
        s = self._host_s
        if self._spans:
            self._spans[-1][1].synchronize()
            s += sum(a.elapsed_time(b) for a, b in self._spans) / 1e3
        self._spans, self._host_s = [], 0.0
        return s

    @staticmethod
    def _to_host(t: torch.Tensor) -> torch.Tensor:
        if t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            return h
        return t.detach().clone(memory_format=torch.contiguous_format)

    @staticmethod
    def _back(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return h.to(like.device, non_blocking=True) if like.is_cuda else h

    def _all_reduce(self, t: torch.Tensor, kind: str, op=None):
        start = self._begin(kind, t)
        h = self._to_host(t)
        self._dist.all_reduce(h, op=op or self._dist.ReduceOp.SUM)
        out = self._back(h, t)
        self._end(start)
        return out

    # ------------------------------------------------------ collectives
    def psum(self, buf: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(buf[0], "psum")

    def shift(self, send: torch.Tensor, kind: str) -> torch.Tensor:
        dst, src = _peers(kind, self.rank, self.ndev)
        start = self._begin(kind, send)
        h = self._to_host(send)
        recv = torch.zeros_like(h)
        dist = self._dist
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, h, dst))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, recv, src))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        out = self._back(recv, send)
        self._end(start)
        return out

    def pdot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(torch.dot(a.reshape(-1), b.reshape(-1)),
                                "pdot")

    def all_true(self, flag: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(flag.to(torch.int32), "flag",
                                self._dist.ReduceOp.MIN) > 0

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor | None:
        """Every rank's row of ``x`` stacked ``[ndev, ...]`` on rank 0
        (host memory); ``None`` on the others."""
        start = self._begin("gather", x)
        h = self._to_host(x)
        parts = ([torch.empty_like(h) for _ in range(self.ndev)]
                 if self.rank == 0 else None)
        self._dist.gather(h, parts, dst=0)
        self._end(start)
        return None if parts is None else torch.cat(parts)


class Partition:
    """Host-side partition tables of a space over ``ndev`` shards
    (``lpfem/shard.py:99-295``, the same tables integer for integer).

    ``part`` (element -> shard) may be given so that the levels of a
    multigrid hierarchy share one element decomposition; ``layout`` is
    ``"compact"`` (owner-major contiguous blocks), ``"lattice"`` (the z-slab
    window: each shard's owned block laid out as its local sub-lattice
    ``[p*nez_loc+1, Dy, Dx]``, plane 0 the halo plane owned by the lower
    neighbour, real on shard 0; planes past a short slab padding) or
    ``"auto"`` (the window where the space qualifies). ``owner`` /
    ``lat_loc = (loc_of_dof, N_max, win)`` force the ownership and the
    window layout of another partition on the same dof lattice (the
    h-transfer "via" space of :class:`ShardedPMG`).
    """

    def __init__(self, space, ndev: int, part: np.ndarray | None = None,
                 owner: np.ndarray | None = None, layout: str = "auto",
                 lat_loc: tuple | None = None):
        self.ndev = ndev
        ed = np.asarray(space.elem_dofs)
        ne, L = ed.shape
        n = space.n_dofs
        lat = space.dof_dims is not None

        if part is None:
            zslab = (layout in ("auto", "lattice") and lat
                     and not space.periodic[2]
                     and space.elem_dims[2] >= ndev)
            if zslab:
                # contiguous z-layer slabs, larger slabs first so shard 0
                # carries the padded layer count
                nex, ney, nez = space.elem_dims
                layer_of = np.zeros(nez, dtype=np.int64)
                for d, idx in enumerate(np.array_split(np.arange(nez), ndev)):
                    layer_of[idx] = d
                part = np.repeat(layer_of, ney * nex)
            else:
                # contiguous slabs by element centroid, (x, y, z)-major
                cen = _centroids(space)
                order = np.lexsort((cen[:, 2], cen[:, 1], cen[:, 0]))
                part = np.zeros(ne, dtype=np.int64)
                for d, idx in enumerate(np.array_split(order, ndev)):
                    part[idx] = d
        self.part = part

        # dof ownership: the lowest and highest shard touching each dof
        pmin = np.full(n, ndev, dtype=np.int64)
        pmax = np.full(n, -1, dtype=np.int64)
        pe = np.repeat(part, L)
        np.minimum.at(pmin, ed.ravel(), pe)
        np.maximum.at(pmax, ed.ravel(), pe)
        inherited = owner is not None
        owner = pmin if owner is None else np.asarray(owner)
        self.owner = owner
        self.pmin, self.pmax = pmin, pmax
        iface = (pmin != owner) | (pmax != owner)
        self.n_iface = int(iface.sum())

        n_own = np.bincount(owner, minlength=ndev)
        self.n_own = n_own
        self.win = None
        sl = (_zslab_layers(np.asarray(part), space.elem_dims, ndev)
              if lat and layout != "compact" and not space.periodic[2]
              else None)
        if sl is not None and sl[1][0] != sl[1].max():
            # the window needs shard 0 to carry the largest slab
            sl = None
        if lat_loc is not None:
            loc_of_dof, self.N_max, self.win = lat_loc
            self.loc_of_dof = loc_of_dof
        elif sl is not None and not inherited:
            # ---- the window layout over z-layer slabs ----
            ez0, nlay = sl
            p = space.p
            Dx, Dy, Dz = space.dof_dims
            plane = Dx * Dy
            nez_loc = int(nlay.max())
            z = np.arange(n) // plane
            rem = np.arange(n) % plane
            loc_of_dof = (z - p * ez0[owner]) * plane + rem
            self.N_max = (p * nez_loc + 1) * plane
            assert np.all((loc_of_dof >= 0) & (loc_of_dof < self.N_max))
            self.loc_of_dof = loc_of_dof
            self.win = {
                "p": p, "dims": (space.elem_dims[0], space.elem_dims[1],
                                 nez_loc),
                "ez0": ez0, "nlay": nlay, "Dx": Dx, "Dy": Dy,
                "Dz_win": p * nez_loc + 1, "plane": plane,
                "periodic": (bool(space.periodic[0]),
                             bool(space.periodic[1])),
            }
        else:
            # ---- the compact layout: owner-major contiguous blocks ----
            new_of_old = np.argsort(np.argsort(owner, kind="stable"),
                                    kind="stable")
            offs = np.concatenate([[0], np.cumsum(n_own)])
            self.loc_of_dof = new_of_old - offs[owner]
            self.N_max = int(n_own.max())
        loc_of_dof = self.loc_of_dof

        # the interface set S, by dof id
        s_ids = np.where(iface)[0]
        NS = len(s_ids)
        self.NS = NS
        s_pos = np.full(n, -1, dtype=np.int64)
        s_pos[s_ids] = np.arange(NS)
        self.s_pos = s_pos

        N_max = self.N_max
        elems_of = [np.where(part == d)[0] for d in range(ndev)]
        self.elems_of = elems_of
        E_max = max(len(e) for e in elems_of)
        self.E_max = E_max

        led = np.full((ndev, E_max, L), N_max, dtype=np.int64)
        halo_of = []
        for d in range(ndev):
            dofs = ed[elems_of[d]]
            halo_of.append(np.unique(dofs[owner[dofs] != d]))
        H_max = max((len(h) for h in halo_of), default=0)
        self.H_max = H_max

        halo_pos = np.full((ndev, max(H_max, 1)), NS, dtype=np.int64)
        own_if_pos_l, own_if_loc_l = [], []
        for d in range(ndev):
            es = elems_of[d]
            dofs = ed[es]
            own_mask = owner[dofs] == d
            halo_ids = halo_of[d]
            h_idx = np.full(n, -1, dtype=np.int64)
            h_idx[halo_ids] = np.arange(len(halo_ids))
            # local layout: [own(N_max), trash(1), halo(H_max), htrash(1)]
            local = np.where(own_mask, loc_of_dof[dofs],
                             N_max + 1 + h_idx[dofs])
            led[d, : len(es)] = local
            assert np.all(s_pos[halo_ids] >= 0)
            halo_pos[d, : len(halo_ids)] = s_pos[halo_ids]
            o_ids = np.where((owner == d) & iface)[0]
            own_if_pos_l.append(s_pos[o_ids])
            own_if_loc_l.append(loc_of_dof[o_ids])

        self.local_elem_dofs = led.astype(np.int32)
        self.elem_dofs_global = ed
        NIo_max = max(max((len(a) for a in own_if_pos_l), default=0), 1)
        oip = np.full((ndev, NIo_max), NS, dtype=np.int64)
        oil = np.full((ndev, NIo_max), N_max, dtype=np.int64)
        for d in range(ndev):
            k = len(own_if_pos_l[d])
            oip[d, :k] = own_if_pos_l[d]
            oil[d, :k] = own_if_loc_l[d]
        self.own_if_pos = oip.astype(np.int32)
        self.own_if_loc = oil.astype(np.int32)
        self.halo_pos = halo_pos.astype(np.int32)

    # ------------------------------------------------------------- helpers
    def stack_elem(self, arr: np.ndarray, fill=0.0) -> np.ndarray:
        """``[ne, ...]`` -> ``[ndev, E_max, ...]`` by shard, padded."""
        out = np.full((self.ndev, self.E_max) + arr.shape[1:], fill,
                      dtype=arr.dtype)
        for d, es in enumerate(self.elems_of):
            out[d, : len(es)] = arr[es]
        return out

    def stack_dof(self, vec: np.ndarray, fill=0.0) -> np.ndarray:
        """``[n, ...]`` -> ``[ndev, N_max+1, ...]``: each shard's owned
        values at their local positions."""
        out = np.full((self.ndev, self.N_max + 1) + vec.shape[1:], fill,
                      dtype=vec.dtype)
        for d in range(self.ndev):
            ids = np.where(self.owner == d)[0]
            out[d, self.loc_of_dof[ids]] = vec[ids]
        return out

    def unstack_dof(self, stacked: np.ndarray) -> np.ndarray:
        """Inverse of :meth:`stack_dof`."""
        n = len(self.owner)
        out = np.zeros((n,) + stacked.shape[2:], dtype=stacked.dtype)
        for d in range(self.ndev):
            ids = np.where(self.owner == d)[0]
            out[ids] = stacked[d, self.loc_of_dof[ids]]
        return out


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


class ShardedExchange:
    """The interface exchange of one :class:`Partition`
    (``lpfem/shard.py:298-567``): index tables on the device and the
    primitives on stacked vectors. ``exchange="auto"`` takes the neighbour
    shifts (lpfem's ``ppermute``) where every interface dof is shared by
    two ring-adjacent shards, else the ``psum`` of the interface buffer;
    ``"ppermute"`` / ``"psum"`` force one (``"ppermute"`` raises where it
    does not apply).

    The device tables hold the ``comm.rows`` rows of this process: every
    shard's on stacked shards, where the exchange is compiled into one
    gather and one indexed add; a rank's own under a :class:`GroupComm`,
    where it runs the collectives."""

    def __init__(self, pt: Partition, comm: ShardComm, device,
                 exchange: str = "auto"):
        if exchange not in ("auto", "ppermute", "psum"):
            raise ValueError(f"unknown shard_exchange {exchange!r}")
        if comm.ndev != pt.ndev:
            raise ValueError(f"{comm.ndev} shards for a partition over "
                             f"{pt.ndev}")
        self.pt = pt
        self.comm = comm
        self.device = torch.device(device)
        self.ndev = pt.ndev
        self.rows = comm.rows
        # the halo segment is padded to >= 1 (a single shard has none)
        self.N_max, self.H_max, self.NS = pt.N_max, max(pt.H_max, 1), pt.NS
        self.oip = self._table(pt.own_if_pos)
        self.oil = self._table(pt.own_if_loc)
        self.hp = self._table(pt.halo_pos)
        self.exchange = "psum"
        if exchange in ("auto", "ppermute") and self._build_neighbor_tables():
            self.exchange = "ppermute"
        elif exchange == "ppermute":
            raise ValueError("partition is not neighbor-only; ppermute "
                             "exchange unavailable (use 'auto' or 'psum')")
        self.win = pt.win
        if self.win is not None:
            self._check_window()
        self._halo_route = self._loc_route = self._add_route = None
        if comm.stacked:
            self._compile_routes()
        self._etab = None
        self.invm = None

    def _table(self, arr) -> torch.Tensor:
        """This process's rows of a host index table, on the device."""
        return _index(self.comm.local(np.asarray(arr)), self.device)

    def _check_window(self) -> None:
        """The window layout's halo must be exactly plane 0 in plane order
        on every shard with a lower neighbour (``lpfem/shard.py:352-362``)."""
        w, pt = self.win, self.pt
        ed = pt.elem_dofs_global
        for d in range(1, pt.ndev):
            dofs = np.unique(ed[pt.elems_of[d]])
            halo = dofs[pt.owner[dofs] != d]
            z0 = w["p"] * w["ez0"][d]
            expect = z0 * w["plane"] + np.arange(w["plane"])
            assert np.array_equal(halo, expect), \
                "window layout requires plane-order halos"

    def _build_neighbor_tables(self) -> bool:
        """Neighbour-exchange tables for slab partitions
        (``lpfem/shard.py:367-462``): valid when every interface dof is
        shared by exactly two ring-adjacent shards, owner d with toucher d+1,
        or owner 0 with toucher ndev-1 (the periodic wrap seam)."""
        pt = self.pt
        ndev = pt.ndev
        if ndev == 1:
            return False
        pmin, pmax, owner = pt.pmin, pt.pmax, pt.owner
        n = len(owner)
        iface = (pmin != owner) | (pmax != owner)
        ids = np.where(iface)[0]
        if len(ids) == 0:
            return False
        space_ed = pt.elem_dofs_global
        n_touch = np.zeros(n, dtype=np.int64)
        for d, es in enumerate(pt.elems_of):
            n_touch[np.unique(space_ed[es])] += 1
        fwd = (n_touch[ids] == 2) & (pmax[ids] == pmin[ids] + 1) \
            & (owner[ids] == pmin[ids])
        wrap = (n_touch[ids] == 2) & (pmin[ids] == 0) \
            & (pmax[ids] == ndev - 1) & (owner[ids] == 0) & (ndev > 2)
        if not np.all(fwd | wrap):
            return False
        ids_f, ids_w = ids[fwd], ids[wrap]

        def seg_tables(seg_ids, src_of):
            W = np.bincount(src_of[seg_ids], minlength=ndev)
            W_max = max(int(W.max()), 1)
            g = np.full((ndev, W_max), pt.N_max, dtype=np.int64)
            for d in range(ndev):
                own_ids = np.sort(seg_ids[src_of[seg_ids] == d])
                g[d, : len(own_ids)] = pt.loc_of_dof[own_ids]
            return g, W_max

        gsl_f, Wf = seg_tables(ids_f, owner)
        gsl_w, Ww = seg_tables(ids_w, owner)

        # receiver: each halo slot's position in [recv_fwd, recv_wrap, 0]
        hr = np.full((ndev, max(pt.H_max, 1)), Wf + Ww, dtype=np.int64)
        rank_f = np.full(n, -1, dtype=np.int64)
        rank_w = np.full(n, -1, dtype=np.int64)
        for d in range(ndev):
            sf = np.sort(ids_f[owner[ids_f] == d])
            rank_f[sf] = np.arange(len(sf))
            sw = np.sort(ids_w[owner[ids_w] == d])
            rank_w[sw] = np.arange(len(sw))
        for d, es in enumerate(pt.elems_of):
            dofs = np.unique(space_ed[es])
            halo_ids = dofs[owner[dofs] != d]
            is_f = np.isin(halo_ids, ids_f)
            pos = np.where(is_f, rank_f[halo_ids], Wf + rank_w[halo_ids])
            if np.any(is_f & (owner[halo_ids] != d - 1)):
                return False
            if np.any(~is_f & ((owner[halo_ids] != 0) | (d != ndev - 1))):
                return False
            hr[d, : len(halo_ids)] = pos
        # sender side of the reverse direction: each sent dof's slot in the
        # sender's halo segment (padding -> the appended zero at H_max)
        hs_f = np.full((ndev, Wf), self.H_max, dtype=np.int64)
        hs_w = np.full((ndev, Ww), self.H_max, dtype=np.int64)
        for d, es in enumerate(pt.elems_of):
            dofs = np.unique(space_ed[es])
            halo_ids = dofs[owner[dofs] != d]
            slot = np.full(n, -1, dtype=np.int64)
            slot[halo_ids] = np.arange(len(halo_ids))
            hf = np.sort(halo_ids[np.isin(halo_ids, ids_f)])
            hs_f[d, : len(hf)] = slot[hf]
            hw = np.sort(halo_ids[np.isin(halo_ids, ids_w)])
            hs_w[d, : len(hw)] = slot[hw]
        self.Wf, self.Ww = Wf, Ww
        self._wrap = len(ids_w) > 0          # else the wrap rows are padding
        self.nbr = {"gslf": gsl_f.astype(np.int32),
                    "gslw": gsl_w.astype(np.int32),
                    "hr": hr.astype(np.int32), "hsf": hs_f.astype(np.int32),
                    "hsw": hs_w.astype(np.int32)}
        self.gslf, self.gslw = self._table(gsl_f), self._table(gsl_w)
        self.hr = self._table(hr)
        self.hsf, self.hsw = self._table(hs_f), self._table(hs_w)
        return True

    # ------------------------------------------------ the collectives
    def _shift_wrap(self, send: torch.Tensor, kind: str) -> torch.Tensor:
        """The wrap seam's shift; zeros without a sent value where no dof
        crosses the seam (every row of its tables is padding)."""
        if self._wrap:
            return self.comm.shift(send, kind)
        return torch.zeros_like(send)

    def _gather_halo_collective(self, x: torch.Tensor) -> torch.Tensor:
        """``[rows, H_max]``: every shard's halo values in halo-id order, the
        owner-broadcast direction, through :class:`ShardComm` as lpfem's
        ``gather_halo`` (``lpfem/shard.py:478-491``)."""
        comm = self.comm
        if self.exchange == "ppermute":
            rf = comm.shift(x.gather(1, self.gslf), "fwd")
            rw = self._shift_wrap(x.gather(1, self.gslw), "wrap")
            buf = torch.cat([rf, rw, x.new_zeros(self.rows, 1)], dim=1)
            return buf.gather(1, self.hr)
        buf = x.new_zeros(self.rows, self.NS + 1)
        buf.scatter_(1, self.oip, x.gather(1, self.oil))
        return comm.psum(buf)[self.hp]

    def _assemble_collective(self, y_own: torch.Tensor,
                             y_halo: torch.Tensor) -> torch.Tensor:
        """Every shard's halo contributions added onto their owners, through
        :class:`ShardComm` as lpfem's ``assemble_halo``
        (``lpfem/shard.py:497-512``); a new tensor, trash lane 0."""
        comm = self.comm
        if self.exchange == "ppermute":
            yh = torch.cat([y_halo, y_halo.new_zeros(self.rows, 1)], dim=1)
            rf = comm.shift(yh.gather(1, self.hsf), "fwd_rev")
            rw = self._shift_wrap(yh.gather(1, self.hsw), "wrap_rev")
            y = y_own.scatter_add(1, self.gslf, rf)
            y.scatter_add_(1, self.gslw, rw)
        else:
            buf = y_halo.new_zeros(self.rows, self.NS + 1)
            buf.scatter_add_(1, self.hp, y_halo)
            y = y_own.scatter_add(1, self.oil, comm.psum(buf)[self.oip])
        y[:, self.N_max] = 0.0
        return y

    def _compile_routes(self) -> None:
        """The exchange as index tables on the flat stacked storage, found by
        running the collective on the stacked lane numbers (exact in
        float64): each halo slot's source lane (shard 0's trash lane, always
        0, where it has none) — so a halo gather is one gather launch with
        the collective's values — and, where every interface dof has one
        halo copy (two touchers: always on the window layout), the
        (owner lane, halo slot) pairs of the reverse direction, one indexed
        add with one term per lane."""
        ndev, N1, H = self.ndev, self.N_max + 1, self.H_max
        lanes = torch.arange(1, ndev * N1 + 1, dtype=torch.float64,
                             device=self.device).view(ndev, N1)
        lanes[:, self.N_max] = 0.0
        h = self._gather_halo_collective(lanes).round().long() - 1
        real = h >= 0
        self._halo_route = torch.where(real, h, self.N_max)
        self._loc_route = torch.cat([
            torch.arange(ndev * N1, device=self.device).view(ndev, N1),
            self._halo_route,
            torch.full((ndev, 1), self.N_max, device=self.device)], dim=1)
        dst = h[real]
        src = torch.arange(ndev * H, device=self.device).view(ndev, H)[real]
        self._add_route = None
        if len(torch.unique(dst)) == len(dst):
            # the halo slots in one run (the window layout: every slot of
            # shards 1..ndev-1) are read as a slice, not gathered
            n = len(src)
            run = n > 0 and bool(torch.equal(
                src, torch.arange(int(src[0]), int(src[0]) + n,
                                  device=self.device)))
            self._add_route = (dst, slice(int(src[0]), int(src[0]) + n)
                               if run else src)

    # ------------------------------------------------------- the exchange
    def gather_halo(self, x: torch.Tensor) -> torch.Tensor:
        """``[rows, H_max]``: every shard's halo values in halo-id order."""
        if self._halo_route is None:
            return self._gather_halo_collective(x)
        return x.reshape(-1)[self._halo_route]

    def gather_loc(self, x: torch.Tensor) -> torch.Tensor:
        """``[rows, N_max+1 + H_max + 1]``: each shard's local layout
        ``[own, trash, halo, zero]`` (lpfem's ``gather_loc``)."""
        if self._loc_route is not None:
            return x.reshape(-1)[self._loc_route]
        return torch.cat([x, self.gather_halo(x),
                          x.new_zeros(self.rows, 1)], dim=1)

    def assemble_halo(self, y_own: torch.Tensor,
                      y_halo: torch.Tensor) -> torch.Tensor:
        """Add every shard's halo contributions ``y_halo [ndev, H_max]``
        onto their owners; returns the assembled ``[ndev, N_max+1]`` (in
        ``y_own``'s storage where the indexed add applies), trash lane 0."""
        if self._add_route is None:
            return self._assemble_collective(y_own, y_halo)
        dst, src = self._add_route
        y = y_own.contiguous()
        y.view(-1).index_add_(0, dst, y_halo.reshape(-1)[src])
        return y

    def halo_plane(self, x: torch.Tensor) -> torch.Tensor:
        """The window's exchanged plane 0, rows ``[ndev, >= Dx*Dy]`` (read
        only where a shard does not own its plane 0)."""
        if self.H_max >= self.win["plane"]:
            return self.gather_halo(x)
        return x.new_zeros(self.rows, self.win["plane"])   # a single shard

    def window(self, x: torch.Tensor) -> torch.Tensor:
        """The materialised windows ``[ndev, Dz_win, Dy, Dx]``: each owned
        block with the exchanged halo plane as plane 0 where the shard does
        not own it (``lpfem/shard.py:529-536``)."""
        w = self.win
        xw = x[:, : self.N_max].reshape(self.rows, w["Dz_win"], w["Dy"],
                                        w["Dx"]).clone()
        p0 = self.halo_plane(x)[:, : w["plane"]]
        lo = max(1 - self.comm.first, 0)        # rows of shards 1..ndev-1
        xw[lo:, 0] = p0[lo:].view(-1, w["Dy"], w["Dx"])
        return xw

    def unwindow(self, y3: torch.Tensor) -> torch.Tensor:
        """Assemble window contributions ``[ndev, Dz_win, Dy, Dx]``: plane 0
        goes to the lower neighbour (shard 0 owns its own), the rest is the
        owned block (``lpfem/shard.py:538-550``)."""
        plane = self.win["plane"]
        flat = y3.reshape(self.rows, -1)
        y_own = torch.cat([flat, flat.new_zeros(self.rows, 1)], dim=1)
        y_halo = flat.new_zeros(self.rows, self.H_max)
        if self.H_max == plane:                  # more than one shard
            lo = max(1 - self.comm.first, 0)
            y_halo[lo:] = flat[lo:, :plane]
            y_own[lo:, :plane] = 0.0
        return self.assemble_halo(y_own, y_halo)

    # --------------------------------------------- E-vector gather and fold
    def element_routes(self, led: np.ndarray, counts) -> tuple:
        """(gather route ``[rows, E*L]``, fold table) of the E-vectors over
        the local element table ``led [rows, E, L]`` of this process's
        shards (slots of ``[own, trash, halo, zero]``; the first
        ``counts[d]`` elements of row d are real), for :meth:`gather_routed`
        and :meth:`fold`. On stacked shards the gather reads each node's
        lane of the stacked vector, halo nodes through the exchange, and the
        fold table ``[ndev*(N_max+1), m]`` gives each owned lane the flat
        E-vector positions that sum into it: its own copies in element
        order, then its halo copies on the other shards in shard order (the
        fold and the exchange in one gather and one sum; padding reads an
        appended 0). Under a process group the gather reads the local layout
        (:meth:`gather_loc`) and the table ``[rows*Nloc, m]`` folds onto it;
        :meth:`fold` then adds the halo rows onto their owners (lpfem's
        ``assemble_own``)."""
        if not self.comm.stacked:
            return self._element_routes_local(led, counts)
        ndev, E, L = led.shape
        N1 = self.N_max + 1
        nloc = N1 + self.H_max + 1
        loc = self._loc_route.cpu().numpy()
        halo = self._halo_route.cpu().numpy()
        gidx = np.take_along_axis(loc, led.reshape(ndev, -1), axis=1)
        tgt, ent = [], []
        remote_t, remote_e = [], []
        for d in range(ndev):
            c = int(counts[d])
            t = _fold_table(led[d, :c], nloc)
            ok = t < c * L
            t = t + d * E * L
            rows = np.broadcast_to(np.arange(nloc)[:, None], t.shape)
            own = ok & (rows < N1)
            tgt.append(d * N1 + rows[own])
            ent.append(t[own])
            hj = rows - N1
            rem = ok & (hj >= 0) & (hj < self.H_max)
            rt = halo[d][np.clip(hj, 0, self.H_max - 1)]
            rem &= rt != self.N_max
            remote_t.append(rt[rem])
            remote_e.append(t[rem])
        tgt = np.concatenate(tgt + remote_t)
        ent = np.concatenate(ent + remote_e)
        order = np.argsort(tgt, kind="stable")
        tgt, ent = tgt[order], ent[order]
        counts_t = np.bincount(tgt, minlength=ndev * N1)
        start = np.cumsum(counts_t) - counts_t
        m = max(int(counts_t.max()), 1)
        table = np.full((ndev * N1, m), ndev * E * L, dtype=np.int64)
        table[tgt, np.arange(len(tgt)) - start[tgt]] = ent
        return _index(gidx, self.device), _index(table, self.device)

    def _element_routes_local(self, led: np.ndarray, counts) -> tuple:
        rows, E, L = led.shape
        nloc = self.N_max + 1 + self.H_max + 1
        gidx = led.reshape(rows, -1) + nloc * np.arange(rows)[:, None]
        tabs = []
        for d in range(rows):
            c = int(counts[d])
            t = _fold_table(led[d, :c], nloc)
            tabs.append(np.where(t < c * L, t + d * E * L, rows * E * L))
        m = max(t.shape[1] for t in tabs)
        table = np.concatenate([np.pad(t, ((0, 0), (0, m - t.shape[1])),
                                       constant_values=rows * E * L)
                                for t in tabs])
        return _index(gidx, self.device), _index(table, self.device)

    def _elem_tables(self):
        if self._etab is None:
            pt = self.pt
            self._etab = self.element_routes(
                self.comm.local(pt.local_elem_dofs.astype(np.int64)),
                self.comm.local([len(es) for es in pt.elems_of]))
        return self._etab

    def gather_routed(self, x: torch.Tensor,
                      gidx: torch.Tensor) -> torch.Tensor:
        """The values of ``x [rows, N_max+1]`` at a gather route of
        :meth:`element_routes`."""
        src = x if self.comm.stacked else self.gather_loc(x)
        return src.reshape(-1)[gidx]

    def gather_E(self, x: torch.Tensor) -> torch.Tensor:
        """``[rows, N_max+1]`` -> E-vectors ``[rows, E_max, L]`` (one
        gather)."""
        gidx, _ = self._elem_tables()
        return self.gather_routed(x, gidx).view(self.rows, self.pt.E_max, -1)

    def fold(self, ye: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """E-vectors -> the assembled ``[rows, N_max+1]`` through a fold
        table of :meth:`element_routes`."""
        yp = F.pad(ye.reshape(-1), (0, 1))
        if self.comm.stacked:
            return yp[table].sum(-1).view(self.ndev, self.N_max + 1)
        n1 = self.N_max + 1
        y = yp[table].sum(-1).view(self.rows, -1)
        return self.assemble_halo(y[:, :n1].contiguous(),
                                  y[:, n1:n1 + self.H_max])

    def assemble_E(self, ye: torch.Tensor) -> torch.Tensor:
        """E-vectors -> the assembled sharded vector (transpose of
        :meth:`gather_E`)."""
        return self.fold(ye, self._elem_tables()[1])

    def pdot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.comm.pdot(a, b)


def _layer_bands(kf: np.ndarray, mf: np.ndarray, p: int, Khat, Mhat):
    """(Kz, Mz) ``[2p+1, p*len(kf)+1]`` float64: the 1D z factors assembled
    from element layers of stiffness scale ``kf`` (1/hz) and mass scale
    ``mf`` (hz), both 0 on padding layers."""
    D = len(kf) * p + 1
    K = np.zeros((2 * p + 1, D))
    M = np.zeros((2 * p + 1, D))
    ar = np.arange(p + 1)
    s = ar[None, :] - ar[:, None]
    for e in range(len(kf)):
        rows = e * p + ar
        K[p + s, rows[:, None]] += Khat * kf[e]
        M[p + s, rows[:, None]] += Mhat * mf[e]
    return K, M


class ShardedLevel(ShardedExchange):
    """One operator over a partition (``lpfem/shard.py:570-779``): the
    exchange plus the stacked essential mask ``ess``, ``free = 1 - ess``,
    the constrained inverse diagonal ``invd`` and the inverse multiplicity
    ``invm``, in the operator's dtype, and one of three applies:

    - ``"sep"``: a :class:`~lpfem_torch.operators.SeparableLattice` on the
      window layout — B1's shard mode over every window in one launch, the
      x and y bands global, the z bands assembled from each slab's own
      layers (zero on padding layers);
    - ``"affine"``: an :class:`~lpfem_torch.operators.AffineLatticeLaplace`
      (a sheared lattice) on the window layout — B2's shard mode, the metric
      rows of each slab's layers (zero on padding layers);
    - ``"element"``: anything else (the compact layout; curved elements):
      the E-vectors of every shard through B3a (affine metric ``C6``, built
      from the space where the operator has none) or B3b (full metric
      ``G6q``), folded and assembled;
    - ``"ell"`` (``ell=True``, the fine level of ``apply_mode="assembled"``;
      ``lpfem/shard.py:637-683``): each shard's partial assembly, its own
      elements' matrices over its local layout ``[own, trash, halo,
      zero]`` (hypre's diag + offd split), as one block-diagonal CSR over the
      stacked local vectors; the apply gathers the local vectors, runs one
      sparse matrix-vector product and adds the halo rows onto their owners
      through the exchange.

    On the two window applies the top-plane constraint runs inside the
    kernel (``scal`` rows ``(zt, own0)``: the shard holding the top plane
    gets its local plane index, -1 elsewhere and for ``apply_own``), where
    the essential set is the global top plane.
    """

    def __init__(self, op, pt: Partition, ess_dofs: np.ndarray,
                 comm: ShardComm, device, exchange: str = "auto",
                 ell: bool = False):
        super().__init__(pt, comm, device, exchange)
        self.op = op
        dtype = op.dtype
        self.dtype = dtype
        npdt = np.float32 if dtype == torch.float32 else np.float64
        ess = np.asarray(ess_dofs)
        n = op.n_dofs
        ess_mask = np.zeros(n)
        ess_mask[ess] = 1.0
        diag = op.diag().detach().to("cpu", torch.float64).numpy()
        dstack = pt.stack_dof(np.where(ess_mask > 0, 1.0, diag), fill=1.0)
        dstack[:, pt.N_max] = 1.0
        mstack = pt.stack_dof(_node_mult(op.space), fill=1.0)
        mstack[:, pt.N_max] = 1.0

        def put(a):
            """This process's rows of a host table ``[ndev, ...]``."""
            return torch.as_tensor(comm.local(np.asarray(a)).astype(npdt),
                                   device=device)

        self.ess = put(pt.stack_dof(ess_mask))
        self.free = 1.0 - self.ess
        self.invd = put(1.0 / dstack)
        self.invm = put(1.0 / mstack)
        self._ess_top = (op.space.dof_dims is not None and np.array_equal(
            np.sort(ess), _top_plane_dofs(op.space.dof_dims)))

        w = pt.win
        if ell:
            self.mode = "ell"
            self._init_ell()
        elif w is not None and isinstance(op, SeparableLattice):
            self.mode = "sep"
            self._init_sep(put)
        elif (w is not None and isinstance(op, AffineLatticeLaplace)
              and not w["periodic"][1]):
            self.mode = "affine"
            self._init_affine(put)
        else:
            self.mode = "element"
            self._init_element(put, npdt)
        if self.mode in ("sep", "affine"):
            self._init_scal()

    # ------------------------------------------------------------- tables
    def _init_scal(self) -> None:
        """``scal`` rows ``(zt, own0)``: constrained (the top plane's local
        index on the shard holding the last element layer) and not."""
        w = self.pt.win
        nez_glob = int(w["ez0"][-1] + w["nlay"][-1])
        own0 = np.zeros(self.ndev, dtype=np.int32)
        own0[0] = 1
        zt = np.where(w["ez0"] + w["nlay"] == nez_glob,
                      w["p"] * w["nlay"], -1).astype(np.int32)
        c = np.stack([zt, own0], axis=1)
        o = np.stack([np.full(self.ndev, -1, np.int32), own0], axis=1)
        check_scal(c, w["Dz_win"])
        self.scal_c = torch.as_tensor(self.comm.local(c), device=self.device)
        self.scal_o = torch.as_tensor(self.comm.local(o), device=self.device)

    def _slab_rows(self, arr: np.ndarray, per_layer: int) -> np.ndarray:
        """``[nez * per_layer, ...]`` -> ``[ndev, nez_loc * per_layer, ...]``:
        each slab's layers, zero rows on its padding layers."""
        w = self.pt.win
        nez_loc = w["dims"][2]
        out = np.zeros((self.ndev, nez_loc * per_layer) + arr.shape[1:],
                       dtype=arr.dtype)
        for d in range(self.ndev):
            s, nl = int(w["ez0"][d]), int(w["nlay"][d])
            out[d, : nl * per_layer] = arr[s * per_layer:(s + nl) * per_layer]
        return out

    def _init_sep(self, put) -> None:
        op, w = self.op, self.pt.win
        p = op.p
        self.bands_xy = tuple(b.detach().to(self.device)
                              for b in op.bands[:4])
        hz = np.asarray(separable_spacings(op.space)[2], dtype=np.float64)
        Khat, Mhat = _reference_matrices(p, op.q)
        fac = self._slab_rows(np.stack([1.0 / hz, hz], axis=1), 1)
        Kz, Mz = zip(*(_layer_bands(fac[d, :, 0], fac[d, :, 1], p, Khat,
                                    Mhat) for d in range(self.ndev)))
        self.zbands = (put(np.stack(Kz)), put(np.stack(Mz)))
        self.dims = (w["Dx"], w["Dy"], w["Dz_win"])

    def _init_affine(self, put) -> None:
        op, w = self.op, self.pt.win
        nex, ney, _ = w["dims"]
        C6 = self._slab_rows(np.asarray(op.C64, dtype=np.float64), nex * ney)
        self.C6 = put(C6).reshape(-1, 6)
        self.w3, self.B, self.D = (t.detach().to(self.device)
                                   for t in (op.w3, op.B, op.D))

    def _init_element(self, put, npdt) -> None:
        op, pt = self.op, self.pt
        sp = op.space
        b = basis_1d(op.p, op.q)
        self.B, self.D = (torch.as_tensor(t.astype(npdt), device=self.device)
                          for t in (b.B, b.D))
        C6 = op.C64 if isinstance(op, ElementLaplace) else affine_c6(
            sp, op.q, npdt)
        if isinstance(op, ElementLaplace) and C6 is None:
            G = op.G64                                      # [ne, Q, 6]
            G6q = G.transpose(0, 2, 1).reshape(G.shape[0], -1)
            self.G6q = put(pt.stack_elem(G6q)).reshape(-1, G6q.shape[1])
            self.C6 = None
        else:
            if C6 is None:
                raise ValueError("a level without element tables needs "
                                 "affine elements")
            self.C6 = put(pt.stack_elem(np.asarray(C6))).reshape(-1, 6)
            self.w3 = torch.as_tensor(np.einsum(
                "c,b,a->cba", b.qwts, b.qwts, b.qwts).reshape(-1).astype(
                    npdt), device=self.device)

    def _init_ell(self) -> None:
        """The stacked partial assemblies: shard d's element matrices over
        rows and columns ``d * Nloc + led[d]``, Nloc = N_max + 1 + H_max + 1
        (``lpfem/shard.py:637-674``), in the operator's dtype, assembled on
        the operator's device and placed on the level's."""
        pt = self.pt
        nloc = self.N_max + 1 + self.H_max + 1
        led = self.comm.local(pt.local_elem_dofs.astype(np.int64))
        elems_of = self.comm.local(pt.elems_of)
        elems = np.concatenate([np.asarray(es, dtype=np.int64)
                                for es in elems_of])
        rows = np.concatenate([d * nloc + led[d, :len(es)]
                               for d, es in enumerate(elems_of)])
        self.A = assemble_csr(element_source(self.op), self.dtype,
                              elem_dofs=rows, elems=elems,
                              n=self.rows * nloc).to(self.device)

    # ------------------------------------------------------------- applies
    def _ell_apply(self, x: torch.Tensor) -> torch.Tensor:
        n1 = self.N_max + 1
        x_loc = self.gather_loc(x)                            # [rows, Nloc]
        y = torch.mv(self.A, x_loc.reshape(-1)).view(self.rows, -1)
        return self.assemble_halo(y[:, :n1], y[:, n1:n1 + self.H_max])

    def _window_apply(self, x: torch.Tensor,
                      scal: torch.Tensor) -> torch.Tensor:
        w = self.pt.win
        p0 = self.halo_plane(x)
        if self.mode == "sep":
            y, yh = sep_apply_shard(x, self.bands_xy, self.zbands,
                                    w["periodic"][0], scal, p0, self.dims)
        else:
            y, yh = lattice_affine_apply_shard(
                x, self.C6, self.w3, self.B, self.D, w["dims"],
                (w["periodic"][0], False, False), scal, p0)
        if self.H_max != w["plane"]:                  # a single shard
            yh = yh.new_zeros(self.rows, self.H_max)
        return self.assemble_halo(y, yh)

    def _element_apply(self, x: torch.Tensor) -> torch.Tensor:
        u = self.gather_E(x)
        shape = u.shape
        u = u.reshape(-1, shape[2])
        if self.C6 is not None:
            ye = pa_apply_affine(u, self.C6, self.w3, self.B, self.D)
        else:
            ye = pa_apply_element(u, self.G6q, self.B, self.D)
        return self.assemble_E(ye.view(shape))

    def apply_own(self, x: torch.Tensor) -> torch.Tensor:
        """``A x`` on the owned lanes, no constraint."""
        if self.mode == "element":
            return self._element_apply(x)
        if self.mode == "ell":
            return self._ell_apply(x)
        return self._window_apply(x, self.scal_o)

    def apply_c(self, x: torch.Tensor) -> torch.Tensor:
        """The constrained apply: identity rows and columns on the essential
        dofs."""
        if self.mode in ("sep", "affine") and self._ess_top:
            return self._window_apply(x, self.scal_c)
        y = self.apply_own(x * self.free)
        return y * self.free + x * self.ess


def _estimate_lmax_sharded(lv: ShardedLevel, iters: int = 20,
                           safety: float = 1.1) -> float:
    """Power iteration for lambda_max(D^-1 A) through the sharded operator
    (``lpfem/shard.py:850-872``), from numpy's ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    npdt = np.float32 if lv.dtype == torch.float32 else np.float64
    v = torch.as_tensor(lv.comm.local(lv.pt.stack_dof(
        rng.standard_normal(len(lv.pt.owner)).astype(npdt))), device=lv.device)
    lam = torch.ones((), dtype=lv.dtype, device=lv.device)
    for _ in range(iters):
        w = lv.apply_c(v) * lv.invd
        lam = torch.sqrt(lv.pdot(w, w))
        v = w / lam
    return float(lam) * safety


class ShardedPMG(VCycle):
    """The sharded p-multigrid (``lpfem/shard.py:875-1060``): p-levels p,
    p/2, .., 1 over the fine element partition, then h-levels (2x2x2
    merges) while the bottom level is a lattice above
    ``h_coarsen_min_dofs``, on partitions descended from the fine slabs.
    Where the coarse z-slabs stop halving the bottom level's, the bottom
    level is rebuilt in the compact layout and h-coarsening goes on below
    it. Smoothers, transfers and V-cycle are those of ``multigrid``; the
    coarse solve is the coarsest level's Chebyshev-16 (lpfem's design).

    ``lmax``: per-level lambda_max (parity runs inject the reference's);
    else ``lmax_mode="host"`` estimates it on the single-device operators,
    ``"sharded"`` through the sharded operators.
    """

    def __init__(self, prob, pt_fine: Partition, comm: ShardComm, device,
                 smooth_degree: int = 3, coarse_cheb_degree: int = 16,
                 h_coarsen_min_dofs: int = 20000, exchange: str = "auto",
                 lmax: list[float] | None = None, lmax_mode: str = "host"):
        space = prob.space
        ndev = pt_fine.ndev
        dtype = prob.op.dtype
        setup_dev = prob.op.device
        self.orders = orders = p_orders(space.p)

        def level(op, pt, ess):
            return ShardedLevel(op, pt, ess, comm, device, exchange)

        self.levels: list[ShardedLevel] = []
        self.transfers: list[_ElementTransfer] = []
        self.ess_list = []
        for li, pl in enumerate(orders):
            if li == 0:
                op, pt = prob.op, pt_fine
                ess = np.asarray(prob.surf.surf_to_vol)
            else:
                sp = space.with_order(pl)
                op = laplace_operator(sp, dtype, setup_dev)
                pt = Partition(sp, ndev, part=pt_fine.part)
                ess = sp.top_plane_dofs()
            self.levels.append(level(op, pt, ess))
            self.ess_list.append(ess)
            if li > 0:
                self.transfers.append(_ElementTransfer(
                    interp_3d(orders[li], orders[li - 1], dtype, device),
                    self.levels[-2], self.levels[-1], self.levels[-2].invm))

        # ---- h-coarsening below p=1 ----
        while True:
            bot = self.levels[-1]
            sp_b = bot.op.space
            if (sp_b.p != 1 or sp_b.dof_dims is None
                    or bot.op.n_dofs <= h_coarsen_min_dofs):
                break
            if not np.array_equal(np.sort(np.asarray(self.ess_list[-1])),
                                  _top_plane_dofs(sp_b.dof_dims)):
                break
            sp_c = sp_b.coarsen()
            if sp_c is None:
                break
            hs = sp_c.with_order(2)
            if hs.dof_dims != sp_b.dof_dims or hs.n_dofs != bot.op.n_dofs:
                break
            # the coarse partition descends from the bottom level's: parent
            # element -> shard of its (0,0,0) child
            nex, ney, nez = sp_b.elem_dims
            pf3 = np.asarray(bot.pt.part).reshape(nez, ney, nex)
            part_c = np.ascontiguousarray(pf3[::2, ::2, ::2]).reshape(-1)
            lat_loc = None
            if bot.pt.win is not None:
                bw = bot.pt.win
                sl_c = _zslab_layers(part_c, hs.elem_dims, ndev)
                ok = (sl_c is not None
                      and np.array_equal(bw["p"] * np.asarray(bw["ez0"]),
                                         2 * sl_c[0])
                      and np.array_equal(bw["p"] * np.asarray(bw["nlay"]),
                                         2 * sl_c[1]))
                if not ok:
                    # the coarse slabs no longer halve the fine ones: the
                    # bottom level goes compact (cheap at p=1)
                    pt_b = Partition(sp_b, ndev, part=bot.pt.part,
                                     layout="compact")
                    bot = level(bot.op, pt_b, self.ess_list[-1])
                    self.levels[-1] = bot
                    tr = self.transfers[-1]
                    self.transfers[-1] = _ElementTransfer(
                        tr.I3, self.levels[-2], bot, tr.inv_mult, tr.via)
            if bot.pt.win is not None:
                bw = bot.pt.win
                nex_c, ney_c, _ = hs.elem_dims
                win_via = {
                    "p": 2, "dims": (nex_c, ney_c, int(sl_c[1].max())),
                    "ez0": sl_c[0], "nlay": sl_c[1],
                    "Dx": bw["Dx"], "Dy": bw["Dy"], "Dz_win": bw["Dz_win"],
                    "plane": bw["plane"], "periodic": bw["periodic"],
                }
                assert 2 * int(sl_c[1].max()) + 1 == bw["Dz_win"]
                lat_loc = (bot.pt.loc_of_dof, bot.pt.N_max, win_via)
            pt_c = Partition(sp_c, ndev, part=part_c)
            op_c = laplace_operator(sp_c, dtype, setup_dev)
            ess_c = _top_plane_dofs(sp_c.dof_dims)
            lvl_c = level(op_c, pt_c, ess_c)
            pt_via = Partition(hs, ndev, part=part_c, owner=bot.pt.owner,
                               lat_loc=lat_loc,
                               layout="compact" if lat_loc is None else "auto")
            assert pt_via.N_max == bot.pt.N_max
            via = ShardedExchange(pt_via, comm, device)
            mstack = pt_via.stack_dof(_node_mult(hs), fill=1.0)
            mstack[:, pt_via.N_max] = 1.0
            via.invm = torch.as_tensor(1.0 / comm.local(mstack)).to(
                device=device, dtype=dtype)
            self.transfers.append(_ElementTransfer(
                interp_3d(1, 2, dtype, device), bot, lvl_c, via.invm, via))
            self.levels.append(lvl_c)
            self.ess_list.append(ess_c)
            self.orders = self.orders + [1]

        if lmax is not None:
            if len(lmax) != len(self.levels):
                raise ValueError(f"lmax has {len(lmax)} entries for "
                                 f"{len(self.levels)} levels")
            self.lmax = [float(v) for v in lmax]
        elif lmax_mode == "sharded":
            self.lmax = [_estimate_lmax_sharded(lv) for lv in self.levels]
        elif lmax_mode == "host":
            self.lmax = []
            for lv, ess in zip(self.levels, self.ess_list):
                op = lv.op
                ess_t = torch.as_tensor(np.asarray(ess), device=op.device)
                diag = op.diag()
                diag[ess_t] = 1.0
                self.lmax.append(estimate_lmax(
                    lambda v, op=op, e=ess_t: op.constrained_apply(v, e),
                    1.0 / diag))
        else:
            raise ValueError(f"unknown lmax_mode {lmax_mode!r}")
        self.smoothers = [ChebyshevSmoother(lv.apply_c, lv.invd, lm,
                                            degree=smooth_degree)
                          for lv, lm in zip(self.levels, self.lmax)]
        cl = self.levels[-1]
        self.smoothers[-1] = ChebyshevSmoother(cl.apply_c, cl.invd,
                                               self.lmax[-1],
                                               degree=coarse_cheb_degree)
        self.coarse_solve = self.smoothers[-1]


def _check_supported(cfg) -> None:
    if cfg.hi_apply == "ds":
        raise NotImplementedError("hi_apply='ds': lpfem has no sharded "
                                  "double-single path")


class ShardedProblem:
    """The sharded form of :class:`~lpfem_torch.problem.Problem`
    (``lpfem/shard.py:1063-1366``): the surface state ``y`` replicated, the
    volume potential and every operator table sharded ``[ndev, ...]`` on
    ``device`` (the problem's unless given).

    ``lmax`` / ``lmax_mode``: the p-multigrid's smoother bounds, as
    :class:`ShardedPMG`. The preconditioner is the sharded p-multigrid
    under ``precond="pmg"`` (above p = 1), else Jacobi, as lpfem's.

    ``comm``: a :class:`GroupComm` runs the shards as the ranks of its
    process group (``n_shards`` its size), each rank with its own row of
    every table and of the potential; ``y`` stays replicated, the surface
    values and the non-finite guard ride the collectives."""

    def __init__(self, prob, n_shards: int, device=None,
                 lmax: list[float] | None = None, lmax_mode: str = "host",
                 comm: ShardComm | None = None):
        cfg = prob.cfg
        _check_supported(cfg)
        self.prob = prob
        self.device = resolve_device(prob.device if device is None
                                     else device)
        dev = self.device
        self.ndev = n_shards
        self.comm = ShardComm(n_shards) if comm is None else comm
        if self.comm.ndev != n_shards:
            raise ValueError(f"{n_shards} shards over a group of "
                             f"{self.comm.ndev}")
        sp = prob.space
        pt = Partition(sp, n_shards)
        self.pt = pt
        self.dtype = prob.dtype
        self.N_max = pt.N_max
        ess = np.asarray(prob.surf.surf_to_vol)
        exchange = cfg.shard_exchange
        # apply_mode="assembled": the solve runs on each shard's partial
        # assembly (``lpfem/shard.py:1080-1083``)
        self.fine = ShardedLevel(prob.op, pt, ess, self.comm, dev, exchange,
                                 ell=prob.op_solve is not None)
        self.fine_hi = (ShardedLevel(prob.op_hi, pt, ess, self.comm, dev,
                                     exchange)
                        if prob.op_hi is not None else None)
        self.pmg = None
        if cfg.precond == "pmg" and sp.p > 1:
            self.pmg = ShardedPMG(prob, pt, self.comm, dev,
                                  smooth_degree=cfg.cheb_degree,
                                  h_coarsen_min_dofs=cfg.h_coarsen_min_dofs,
                                  exchange=exchange, lmax=lmax,
                                  lmax_mode=lmax_mode)
        zlv = self.fine_hi if self.fine_hi is not None else self.fine
        self.free = zlv.free.to(self.dtype)
        self._init_zderiv(zlv, ess)
        self._init_surface(ess)
        self.relax = prob.relax
        if self.relax is not None:
            self.relax = dataclasses.replace(self.relax, **{
                f.name: getattr(self.relax, f.name).to(dev)
                for f in dataclasses.fields(self.relax)
                if isinstance(getattr(self.relax, f.name), torch.Tensor)})
        self.last_solver_stats = None
        self._last_ok = None

    @classmethod
    def from_config(cls, cfg, n_shards: int, device="cuda",
                    lmax: list[float] | None = None,
                    comm: ShardComm | None = None,
                    mesh=None) -> "ShardedProblem":
        """Set-up on the host, tables placed on ``device``
        (``lpfem/shard.py:1143-1166``): the problem (on ``mesh`` where
        given) is built on the CPU without its single-device
        preconditioner, and the smoother bounds come from power iteration
        through the sharded operators (unless ``lmax`` is given). Under a
        process group every rank builds the same tables (the set-up is
        deterministic) and keeps its row."""
        from .problem import Problem
        _check_supported(cfg)
        prob = Problem(cfg, device="cpu", build_precond=False, mesh=mesh)
        return cls(prob, n_shards, device=device, lmax=lmax,
                   lmax_mode="host" if lmax is not None else "sharded",
                   comm=comm)

    # ------------------------------------------------------------- tables
    def _init_zderiv(self, lv: ShardedLevel, ess: np.ndarray) -> None:
        """The nodal z-derivative at the surface dofs
        (``lpfem/shard.py:1118-1126, 1169-1189``) over the elements that
        touch the surface (the only ones that reach a surface dof): per
        shard their rows of the local element table and the inverse-Jacobian
        z-column (one per element where it is constant), gathered and folded
        through the level's exchange, then divided by the multiplicity."""
        sp, pt = self.prob.space, self.pt
        dev, dt = self.device, self.dtype
        elems = surface_elements(sp, ess)
        _, Jz = top_trace_geometry(sp, 1e-12, elems)     # [m, 1 or L, 3]
        pos = np.full(len(pt.part), -1, dtype=np.int64)
        pos[elems] = np.arange(len(elems))
        L = pt.local_elem_dofs.shape[2]
        rows = [np.flatnonzero(pos[es] >= 0) for es in pt.elems_of]
        Ez = max(max(len(r) for r in rows), 1)
        led = np.full((self.ndev, Ez, L), pt.N_max, dtype=np.int64)
        jz = np.zeros((self.ndev, Ez) + Jz.shape[1:])
        for d, r in enumerate(rows):
            led[d, : len(r)] = pt.local_elem_dofs[d, r]
            jz[d, : len(r)] = Jz[pos[pt.elems_of[d][r]]]
        local = self.comm.local
        gidx, table = lv.element_routes(local(led),
                                        local([len(r) for r in rows]))
        jz = local(jz)
        self._zd = dict(
            gidx=gidx, table=table,
            Jz=torch.as_tensor(jz.reshape((-1,) + Jz.shape[1:])).to(
                device=dev, dtype=dt),
            Dn=torch.tensor(basis_1d(sp.p).Dn).to(device=dev, dtype=dt),
            invm=lv.invm.to(dt))
        self._zlv = lv

    def _init_surface(self, s2v: np.ndarray) -> None:
        """Surface <-> volume tables (``lpfem/shard.py:1128-1141``): each
        surface dof's owner-local lane, and the gather that reads the
        surface vector back from the owners' rows."""
        pt = self.pt
        NSurf = len(s2v)
        self.NSurf = NSurf
        sp_owner = pt.owner[s2v]
        NSo = max(int(np.max(np.bincount(sp_owner, minlength=self.ndev))), 1)
        spos = np.full((self.ndev, NSo), NSurf, dtype=np.int64)
        sloc = np.full((self.ndev, NSo), pt.N_max, dtype=np.int64)
        for d in range(self.ndev):
            sel = np.where(sp_owner == d)[0]
            spos[d, : len(sel)] = sel
            sloc[d, : len(sel)] = pt.loc_of_dof[s2v[sel]]
        inv = np.zeros(NSurf, dtype=np.int64)
        flat = spos.ravel()
        inv[flat[flat < NSurf]] = np.flatnonzero(flat < NSurf)
        self.surf_pos = _index(self.comm.local(spos), self.device)
        self.surf_loc = _index(self.comm.local(sloc), self.device)
        self._surf_read = _index(inv, self.device)

    def _surface_values(self, v: torch.Tensor) -> torch.Tensor:
        """A sharded vector's values at the surface dofs, in surface order:
        read from the owners' rows (under a process group the owners'
        values summed over the ranks, every other term 0)."""
        vals = v.gather(1, self.surf_loc)
        if self.comm.stacked:
            return vals.reshape(-1)[self._surf_read]
        buf = vals.new_zeros(self.comm.rows, self.NSurf + 1).scatter_(
            1, self.surf_pos, vals)
        return self.comm.psum(buf)[: self.NSurf]

    # ------------------------------------------------------------ the rhs
    def _zderiv_surface(self, phi: torch.Tensor) -> torch.Tensor:
        """dphi/dz at the surface dofs, in surface order."""
        zd, lv = self._zd, self._zlv
        p1 = self.prob.space.p + 1
        u = lv.gather_routed(phi, zd["gidx"]).view(-1, p1, p1, p1)
        Dn = zd["Dn"]
        gx = (u @ Dn.T).reshape(-1, p1 ** 3)
        gy = (Dn @ u).reshape(-1, p1 ** 3)
        gz = torch.einsum("cz,ezyx->ecyx", Dn, u).reshape(-1, p1 ** 3)
        Jz = zd["Jz"]
        w = Jz[..., 0] * gx + Jz[..., 1] * gy + Jz[..., 2] * gz
        return self._surface_values(lv.fold(w, zd["table"]) * zd["invm"])

    def solve_laplace(self, phi_fs: torch.Tensor, phi_warm: torch.Tensor):
        """The Dirichlet Laplace solve with ``phi = phi_fs`` on the free
        surface from the stacked warm start (``lpfem/shard.py:1202-1235``,
        ``FreeSurfaceOperator.solve_laplace``'s sharded form, in its span
        and through its ``cg_solve``). Returns the stacked ``phi`` and the
        solve's ``SolveInfo``."""
        with span("surface.solve"):
            lv, hi, free = self.fine, self.fine_hi, self.free
            pfs_pad = torch.cat([phi_fs, phi_fs.new_zeros(1)])
            x_bc = phi_fs.new_zeros(self.comm.rows, self.N_max + 1).scatter_(
                1, self.surf_loc, pfs_pad[self.surf_pos])
            precond = self.pmg if self.pmg is not None else (
                lambda r: r * lv.invd)
            x0 = phi_warm * free + x_bc
            sop = lv if hi is None else hi
            B = -sop.apply_own(x_bc) * free + x_bc
            return self.prob.fso.cg_solve(sop.apply_c, lv.apply_c, B, x0,
                                          precond, dot_fn=self.comm.pdot)

    def _rhs(self, t: float, y: torch.Tensor, aux: SolveCarry):
        """The stage, as ``FreeSurfaceOperator.__call__`` (its spans
        ``surface.stage`` and ``surface.top_trace`` too)."""
        with span("surface.stage"):
            ns = self.NSurf
            eta, phi_fs = y[:ns], y[ns:]
            phi, info = self.solve_laplace(phi_fs, aux.phi)
            with span("surface.top_trace"):
                deta = self._zderiv_surface(phi)
            dphi_fs = -self.prob.fso.g * eta
            if self.relax is not None:
                deta, dphi_fs = self.relax.forcing(t, eta, phi_fs, deta,
                                                   dphi_fs)
            return torch.cat([deta, dphi_fs]), SolveCarry(
                phi, aux.stats.update(info))

    def initial_state(self, t: float = 0.0):
        """(y0, phi0 stacked) on the device: the problem's initial state."""
        y0, phi0 = self.prob.initial_state(t)
        return (y0.to(device=self.device, dtype=self.dtype),
                self.stack_state(phi0))

    # ------------------------------------------------------------------ API
    def stack_state(self, phi) -> torch.Tensor:
        """A volume potential as this process's rows ``[rows, N_max+1]`` of
        the stacked tensor, on the device: a stacked one (numpy or tensor;
        under a process group every shard's ``[ndev, N_max+1]`` or the
        rank's ``[1, N_max+1]``) as it is, a global ``[n]`` one through
        ``Partition.stack_dof``."""
        comm = self.comm
        if isinstance(phi, torch.Tensor):
            phi = phi.detach()
            if phi.dim() == 2 and phi.shape[0] == comm.rows:
                return phi.to(device=self.device, dtype=self.dtype)
            phi = phi.cpu().numpy()
        phi = np.asarray(phi)
        if phi.ndim == 1:
            phi = self.pt.stack_dof(phi.astype(np.float64))
        if phi.ndim == 2 and phi.shape[0] == self.ndev:
            phi = comm.local(phi)
        if phi.shape != (comm.rows, self.N_max + 1):
            raise ValueError(f"stacked potential of shape {phi.shape}, "
                             f"expected {(comm.rows, self.N_max + 1)}")
        return torch.as_tensor(phi).to(device=self.device, dtype=self.dtype)

    def run(self, n_steps: int | None = None, t0: float = 0.0, state=None,
            record=None):
        """Sharded RK4 run; returns ``(t, y, phi_stacked)``. ``state = (y,
        phi)`` with ``phi`` global ``[n]`` or stacked ``[ndev, N_max+1]``
        (``lpfem/shard.py:1288-1298``). ``record(t, y, aux)`` is called after
        every step with the replicated ``y`` and ``aux`` a
        :class:`~lpfem_torch.surface.SolveCarry` of the stacked potential.
        The non-finite guard reads every shard's potential, so one shard's
        NaN stops every shard at the same step (``lpfem/shard.py:1326-1328``;
        under a process group through an all-reduce of the flag).
        After the run ``last_solver_stats`` holds the solver telemetry; an
        unconverged stage emits a ``RuntimeWarning``."""
        prob = self.prob
        if n_steps is None:
            n_steps = prob.cfg.nsteps
        y0, phi0 = state if state is not None else self.initial_state(t0)
        y0 = torch.as_tensor(y0).to(device=self.device, dtype=self.dtype)
        aux0 = SolveCarry(self.stack_state(phi0), SolveStats())
        (t, y, aux), ok = rk4_run(
            self._rhs, y0, aux0, t0, prob.dt, n_steps, record=record,
            all_finite=None if self.comm.stacked else self.comm.all_true)
        self._last_ok = ok
        self.last_solver_stats = aux.stats
        if aux.stats.unconverged:
            warnings.warn(
                "Laplace CG did not converge in at least one RK4 stage "
                f"(worst solve: {aux.stats.max_iters} iterations)",
                RuntimeWarning, stacklevel=2)
        return t, y, aux.phi

    def phi_global(self, phi_stacked) -> np.ndarray | None:
        """The stacked potential as a global ``[n]`` numpy vector. Under a
        process group every rank calls it: the rows are gathered to rank 0,
        which gets the vector; the others get ``None``."""
        if isinstance(phi_stacked, torch.Tensor):
            if not self.comm.stacked:
                phi_stacked = self.comm.gather_rows(phi_stacked.detach())
                if phi_stacked is None:
                    return None
            phi_stacked = phi_stacked.detach().cpu().numpy()
        return self.pt.unstack_dof(np.asarray(phi_stacked))

    def check_state(self, y: torch.Tensor, phi: torch.Tensor) -> None:
        """Raise if the run diverged or the state is non-finite
        (``Problem.check_state``)."""
        if self._last_ok is False:
            raise FloatingPointError(
                "time integration diverged: a non-finite RK4 stage was "
                "detected and the run stopped at the last finite step")
        for name, v in (("free-surface state [eta; phi_fs]", y),
                        ("volume potential", phi)):
            if not bool(self.comm.all_true(torch.isfinite(v).all())):
                raise FloatingPointError(f"non-finite values in {name}")
