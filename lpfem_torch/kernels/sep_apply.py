"""Banded Kronecker Laplace apply: CUDA kernel wrapper and its plain version.

``y = (Mz (x) My (x) Kx + Mz (x) Ky (x) Mx + Kz (x) My (x) Mx) x`` on the
``[Dz, Dy, Dx]`` dof lattice, with ``bands = (Kx, Mx, Ky, My, Kz, Mz)`` in the
diagonal-offset form of ``lpfem.operators.SeparableLattice``
(``band[p + s, i] = G[i, i + s]``, shape ``[2p+1, D_a]``). ``ess_top`` gives
identity rows and columns on the top z-plane.

- :func:`sep_apply` runs ``csrc/sep_apply.cu`` (the port of the TPU kernel
  ``lpfem/kernels/sep_apply.py::lattice_sep_apply``) on CUDA tensors and
  counts each launch in ``LAUNCHES`` (and by order p in
  ``LAUNCHES_BY_P``). It takes the plain version only because its input
  lies on the CPU; on a CUDA tensor it launches the kernel or raises.
  At p = 8 in float64 the kernel takes its tensor-core route (DMMA,
  :func:`tensor_core_route`), whose launches ``LAUNCHES_TC_BY_P`` counts
  by order, from both entries.
- :func:`sep_apply_reference` is the plain PyTorch version, with the sums
  of ``SeparableLattice._axis/apply3`` in the same order.
- :func:`choose_tiles` picks the kernel's tiles (one launch per apply: a
  block owns the outputs of a ``Tx x Ty`` tile of (x, y) columns over a
  z-chunk of ``Tz`` planes) and :func:`sep_apply_mirror` runs the same
  decomposition in plain PyTorch, so the CPU tests check what each block
  reads and sums: x tiles with a wrapped or zero halo, y tiles, z-chunks
  whose halo planes are recomputed, and the ring of the last 2p+1 planes
  (on the tensor-core route: the dense banded tiles of the x, y and z
  products and the window of 24 planes that each batch of 8 output planes
  reads).
- Shard mode (the TPU kernel's ``shard_scal`` / ``p0`` mode, run on every
  z-slab window level of ``lpfem_torch.shard``): :func:`sep_apply_shard`
  applies ``ndev`` stacked windows in one launch, each with its own z bands
  and its row of ``scal = (zt, own0)``: ``zt`` the Dirichlet plane (read as
  zero, output the input) or -1, ``own0`` whether the shard owns its
  window's plane 0 (else plane 0 reads the exchanged halo plane ``p0`` and
  its outputs go to ``yhalo``, ``y``'s plane 0 being 0). It counts its
  launches in ``LAUNCHES_SHARD`` / ``LAUNCHES_SHARD_BY_P``;
  :func:`sep_apply_shard_reference` is its plain version, shard by shard,
  and :func:`sep_apply_mirror` takes the same mode for one window.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

__all__ = ["sep_apply", "sep_apply_reference", "sep_apply_mirror",
           "sep_apply_shard", "sep_apply_shard_reference", "choose_tiles",
           "tile_blocks", "tile_smem_bytes", "tensor_core_route"]

LAUNCHES = 0          # kernel launches through sep_apply (never the plain path)
LAUNCHES_BY_P: dict[int, int] = {}     # the same launches by order p
LAUNCHES_SHARD = 0    # kernel launches through sep_apply_shard
LAUNCHES_SHARD_BY_P: dict[int, int] = {}
# launches of the tensor-core route by order, through either entry: in a
# float64 order-8 run LAUNCHES_BY_P[8] + LAUNCHES_SHARD_BY_P[8]
LAUNCHES_TC_BY_P: dict[int, int] = {}

# The kernel's limits (csrc/sep_apply.cu: kMaxP, max_threads<T>()); its
# entry refuses tiles past them, and shared-memory bytes other than those of
# its own layout (TileSmem), so a drift of these or of tile_smem_bytes fails
# the launch.
MAX_P = 10            # the general instantiation's reach
MAX_THREADS = {4: 288, 8: 160}   # Tx * Ty by itemsize (__launch_bounds__)
# p = 8's fixed instantiation in float32 (bands and ring of 17 taps in
# registers, two blocks per SM): Tx and the threads of a block
P8_TX, P8_THREADS = 8, 160
# the tensor-core route (p = 8 in float64; csrc/sep_apply.cu, namespace tc):
# its fixed tile of 16 x-columns by 8 y-rows, the u tile's row stride (4
# modulo 16 doubles: the rows a DMMA fragment reads fall in distinct banks)
# and the SMs that hold one of its blocks each (132 on an H100)
TC_TX, TC_TY, TC_ROW_STRIDE, TC_SMS = 16, 8, 36, 132
TARGET_BLOCKS = 264   # two blocks per SM of an H100 (132 SMs)
SMEM_LIMIT = 232_448  # shared memory a block may use on Hopper (227 KB)

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_SHARD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])


def _shifts(u: torch.Tensor, axis: int, p: int, periodic: bool):
    """The 2p+1 views ``u_{i+s}``, s = -p..p, along ``axis`` (wraparound on a
    periodic axis, zeros past the ends otherwise)."""
    if periodic:
        return [torch.roll(u, -s, axis) for s in range(-p, p + 1)]
    D = u.shape[axis]
    up = F.pad(u, [0, 0] * (2 - axis) + [p, p])
    return [up.narrow(axis, k, D) for k in range(2 * p + 1)]


def _contract(c: torch.Tensor, us, axis: int) -> torch.Tensor:
    """y_i = sum_s c[p+s, i] u_{i+s}, summed in order s = -p..p like the
    reference's ``SeparableLattice._axis``."""
    shape = [c.shape[0], 1, 1, 1]
    shape[1 + axis] = c.shape[1]
    return sum(ck * uk for ck, uk in zip(c.reshape(shape).unbind(0), us))


def sep_apply_reference(x: torch.Tensor, bands, periodic,
                        ess_top: bool = False) -> torch.Tensor:
    """Plain PyTorch ``A x`` on the lattice view ``x [Dz, Dy, Dx]``;
    ``periodic = (px, py, pz)``. Each axis pass shifts its input once and
    feeds both of its bands, as the kernel does."""
    u = x
    if ess_top:
        u = x.clone()
        u[-1] = 0.0
    y = _apply(u, bands, periodic)
    if ess_top:
        y[-1] = x[-1]
    return y


def _apply(u: torch.Tensor, bands, periodic) -> torch.Tensor:
    """The seven contractions of :func:`sep_apply_reference`."""
    Kx, Mx, Ky, My, Kz, Mz = bands
    px, py, pz = periodic
    p = (Kx.shape[0] - 1) // 2
    us = _shifts(u, 2, p, px)
    t1, t2 = _contract(Kx, us, 2), _contract(Mx, us, 2)
    t1s, t2s = _shifts(t1, 1, p, py), _shifts(t2, 1, p, py)
    a = _contract(My, t1s, 1) + _contract(Ky, t2s, 1)
    b = _contract(My, t2s, 1)
    return (_contract(Mz, _shifts(a, 0, p, pz), 0)
            + _contract(Kz, _shifts(b, 0, p, pz), 0))


def _shard_rows(scal) -> list[tuple[int, int]]:
    """``scal [ndev, 2]`` (a tensor or nested lists) as host pairs."""
    rows = scal.tolist() if isinstance(scal, torch.Tensor) else list(scal)
    return [(int(zt), int(o)) for zt, o in rows]


def sep_apply_shard_reference(x: torch.Tensor, bands_xy, zbands,
                              periodic_x: bool, scal, p0: torch.Tensor,
                              dims) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch shard mode, one window at a time: ``x [ndev, W]``
    (window ``dims = (Dx, Dy, Dz)`` in the first ``Dx*Dy*Dz`` lanes of each
    row), ``bands_xy = (Kx, Mx, Ky, My)``, ``zbands = (Kz, Mz)`` each
    ``[ndev, 2p+1, Dz]``, ``scal [ndev, 2]`` rows ``(zt, own0)``, ``p0
    [ndev, >= Dx*Dy]``. Returns ``(y [ndev, W], yhalo [ndev, Dx*Dy])``,
    lanes of ``y`` past the window 0."""
    Dx, Dy, Dz = dims
    plane, n = Dx * Dy, Dx * Dy * Dz
    Kz, Mz = zbands
    y = torch.zeros_like(x)
    yhalo = x.new_zeros(x.shape[0], plane)
    for d, (zt, own0) in enumerate(_shard_rows(scal)):
        u = x[d, :n].reshape(Dz, Dy, Dx).clone()
        if not own0:
            u[0] = p0[d, :plane].reshape(Dy, Dx)
        if zt >= 0:
            u[zt] = 0.0
        yd = _apply(u, (*bands_xy, Kz[d], Mz[d]), (periodic_x, False, False))
        if zt >= 0:
            yd[zt] = x[d, zt * plane:(zt + 1) * plane].reshape(Dy, Dx)
        yd = yd.reshape(-1)
        if not own0:
            yhalo[d] = yd[:plane]
            yd[:plane] = 0.0
        y[d, :n] = yd
    return y, yhalo


def tensor_core_route(p: int, itemsize: int) -> bool:
    """Whether the kernel runs order ``p`` at ``itemsize`` bytes a value on
    the FP64 tensor cores (DMMA): p = 8 in float64."""
    return p == 8 and itemsize == 8


@functools.lru_cache(maxsize=64)
def choose_tiles(dims, p: int, itemsize: int,
                 nbatch: int = 1) -> tuple[int, int, int, int]:
    """``(Tx, Ty, Tz, S)`` of the kernel for the lattice ``dims = (Dx, Dy,
    Dz)``: Tx = 8 columns in float, 4 in double; Ty the whole y axis while
    ``Tx * Dy <= MAX_THREADS[itemsize]`` (the y halo then lies past the
    ends), else the axis split evenly; at p = 8 Tx = ``P8_TX`` and
    ``P8_THREADS`` in place of ``MAX_THREADS`` (a tile twice as wide reads
    fewer x halo columns per output); the z-chunk Tz such that the grid (over
    ``nbatch`` stacked lattices in shard mode) has at least
    ``TARGET_BLOCKS`` blocks, chunks as even as Dz allows; S the u tile's
    row stride, at least Tx + 2p and congruent to Tx modulo the row width
    of a bank line, so the rows a warp reads fall in distinct banks.

    The tensor-core route takes its fixed ``TC_TX x TC_TY`` tile and
    ``TC_ROW_STRIDE``, and the z-chunk (a multiple of 8, its batch) that
    makes the fewest batches in a row of waves of ``TC_SMS`` blocks (one
    block an SM; a chunk of Tz planes runs Tz / 8 + 2 batches)."""
    Dx, Dy, Dz = dims
    if tensor_core_route(p, itemsize):
        nxy = -(-Dx // TC_TX) * -(-Dy // TC_TY) * nbatch
        best = None
        for chunks in range(1, Dz + 1):
            tz = 8 * -(-Dz // (8 * chunks))
            n = -(-Dz // tz)
            cost = -(-nxy * n // TC_SMS) * (tz // 8 + 2)
            if best is None or cost < best[0]:
                best = (cost, tz)
        return TC_TX, TC_TY, best[1], TC_ROW_STRIDE
    if p == 8:
        tx = min(P8_TX, Dx)
        rows = P8_THREADS // tx
    else:
        tx = min(8 if itemsize == 4 else 4, Dx)
        rows = MAX_THREADS[itemsize] // tx
    ty = -(-Dy // -(-Dy // rows))
    nxy = -(-Dx // tx) * -(-Dy // ty) * nbatch
    chunks = min(Dz, max(1, -(-TARGET_BLOCKS // nxy)))
    tz = -(-Dz // chunks)
    line = 32 * 4 // itemsize           # values per 32 banks
    s = tx + 2 * p
    s += (tx - s) % line
    return tx, ty, tz, s


def tile_smem_bytes(p: int, tiles, itemsize: int) -> int:
    """Dynamic shared memory of one block: three u planes in flight, t1,
    t2, three planes' z bands, the row offsets and the load offsets (the
    kernel's ``TileSmem``; the entry takes these bytes and checks them).
    The tensor-core route (``TcSmem``): two u planes a warp of 8, the
    window's a and b over 24 planes (rows of 18 values, planes of 148),
    the row and load offsets."""
    tx, ty, _, s = tiles
    h, w = ty + 2 * p, tx + 2 * p
    if tensor_core_route(p, itemsize):
        return itemsize * (2 * 8 * h * s + 2 * 24 * (8 * 18 + 4)) + 4 * (
            h + h * w)
    return (itemsize * (3 * h * s + 2 * h * tx + 3 * 2 * (2 * p + 1))
            + 4 * (h + h * w))


def tile_blocks(dims, tiles):
    """The grid's blocks as the output ranges ``(x0, x1, y0, y1, z0, z1)``
    each one writes."""
    Dx, Dy, Dz = dims
    tx, ty, tz, _ = tiles
    return [(x0, min(x0 + tx, Dx), y0, min(y0 + ty, Dy), z0,
             min(z0 + tz, Dz))
            for z0 in range(0, Dz, tz) for y0 in range(0, Dy, ty)
            for x0 in range(0, Dx, tx)]


def sep_apply_mirror(x: torch.Tensor, bands, periodic, ess_top: bool = False,
                     tiles=None, shard=None):
    """Plain PyTorch ``A x`` in the kernel's decomposition (``tiles`` from
    :func:`choose_tiles` unless given): per block, each input plane of its
    z-chunk and the chunk's p halo planes on either side (within the
    lattice) is read as a ``(Ty+2p) x (Tx+2p)`` tile (x wrapped on a
    periodic axis, zero past the ends otherwise, y zero past the ends, the
    top plane zero under ``ess_top``), contracted in x on every tile row and
    in y on the output rows; the last 2p+1 planes' (a, b) form a ring, zero
    past the top, from which each output plane is emitted. Sums run
    s = -p..p in order.

    On the tensor-core route (:func:`tensor_core_route`) a block's x, y and
    z contractions are products with the kernel's dense banded tiles (the x
    bands over the tile's 16 + 2p columns, the y bands over its 8 + 2p
    rows, zero off the band and past the lattice), and each batch of 8
    output planes reads a window of the 24 planes around it, zero outside
    the lattice and past the last plane the chunk's outputs read; sums run
    over the tiles' full extent in the plain version's order (the kernel's
    DMMA sums differ in the last bits).

    ``shard = (zt, own0, p0 [Dy, Dx])``: one window of the shard mode (its
    own z bands in ``bands``), with the Dirichlet plane ``zt`` (-1: none)
    in place of ``ess_top``'s top plane and, when ``own0`` is false, plane 0
    read from ``p0``; returns ``(y, yhalo [Dy*Dx])`` then."""
    Kx, Mx, Ky, My, Kz, Mz = bands
    if periodic[1] or periodic[2]:
        raise ValueError("only the x axis may be periodic")
    Dz, Dy, Dx = x.shape
    p = (Kx.shape[0] - 1) // 2
    R = 2 * p + 1
    if tiles is None:
        tiles = choose_tiles((Dx, Dy, Dz), p, x.element_size())
    tx, ty, tz, _ = tiles
    zt, own0, p0 = (shard if shard is not None
                    else (Dz - 1 if ess_top else -1, True, None))
    y = torch.empty_like(x)
    zero = x.new_zeros(())
    if tensor_core_route(p, x.element_size()):
        _mirror_tc(x, bands, periodic[0], tiles, (zt, own0, p0), y)
        blocks = []
    else:
        blocks = tile_blocks((Dx, Dy, Dz), tiles)
    for x0, x1, y0, y1, z0, z1 in blocks:
        gx = torch.arange(x0 - p, x0 + tx + p)
        if periodic[0]:
            gx, xin = gx % Dx, torch.ones_like(gx, dtype=torch.bool)
        else:
            xin = (gx >= 0) & (gx < Dx)
        gy = torch.arange(y0 - p, y0 + ty + p)
        yin = (gy >= 0) & (gy < Dy)
        inside = yin[:, None] & xin[None, :]
        gxc, gyc = gx.clamp(0, Dx - 1), gy.clamp(0, Dy - 1)
        cx = torch.arange(x0, x0 + tx).clamp(max=Dx - 1)    # output columns
        cy = torch.arange(y0, y0 + ty).clamp(max=Dy - 1)    # output rows
        ring_a = [x.new_zeros(ty, tx) for _ in range(R)]
        ring_b = [x.new_zeros(ty, tx) for _ in range(R)]
        for z in range(max(0, z0 - p), z1 + p):
            if z < Dz:
                src = p0 if z == 0 and not own0 else x[z]
                u = torch.where(inside, src[gyc][:, gxc], zero)
                if z == zt:
                    u = torch.zeros_like(u)
                t1 = sum(Kx[k, cx] * u[:, k:k + tx] for k in range(R))
                t2 = sum(Mx[k, cx] * u[:, k:k + tx] for k in range(R))
                a1 = sum(My[k, cy, None] * t1[k:k + ty] for k in range(R))
                a2 = sum(Ky[k, cy, None] * t2[k:k + ty] for k in range(R))
                b = sum(My[k, cy, None] * t2[k:k + ty] for k in range(R))
                a = a1 + a2
            else:
                a = b = x.new_zeros(ty, tx)
            ring_a = ring_a[1:] + [a]
            ring_b = ring_b[1:] + [b]
            zo = z - p
            if zo < z0:
                continue
            out = (sum(Mz[k, zo] * ring_a[k] for k in range(R))
                   + sum(Kz[k, zo] * ring_b[k] for k in range(R)))
            if zo == zt:
                out = x[zo, y0:y0 + ty, x0:x0 + tx]
            y[zo, y0:y1, x0:x1] = out[:y1 - y0, :x1 - x0]
    if shard is None:
        return y
    yhalo = x.new_zeros(Dy * Dx)
    if not own0:
        yhalo = y[0].reshape(-1).clone()
        y[0] = 0.0
    return y, yhalo


def _band_tile(band, lo: int, n_out: int, n_in: int) -> torch.Tensor:
    """The dense banded tile ``T[o, i] = band[i - o, lo + o]`` (``[n_out,
    n_in]``), zero off the band and where ``lo + o`` lies past the axis."""
    D = band.shape[1]
    o = torch.arange(n_out)[:, None]
    k = torch.arange(n_in)[None, :] - o
    ok = (k >= 0) & (k < band.shape[0]) & (lo + o < D)
    return torch.where(ok, band[k.clamp(0, band.shape[0] - 1),
                                (lo + o).clamp(max=D - 1)],
                       band.new_zeros(()))


def _mirror_tc(x, bands, periodic_x: bool, tiles, shard, y) -> None:
    """:func:`sep_apply_mirror`'s blocks on the tensor-core route, into
    ``y``."""
    Kx, Mx, Ky, My, Kz, Mz = bands
    Dz, Dy, Dx = x.shape
    p = (Kx.shape[0] - 1) // 2
    tx, ty, tz, _ = tiles
    h, w = ty + 2 * p, tx + 2 * p
    zt, own0, p0 = shard
    zero = x.new_zeros(())
    for x0, x1, y0, y1, z0, z1 in tile_blocks((Dx, Dy, Dz), tiles):
        akx, amx = _band_tile(Kx, x0, tx, w), _band_tile(Mx, x0, tx, w)
        bmy, bky = _band_tile(My, y0, ty, h), _band_tile(Ky, y0, ty, h)
        gx = torch.arange(x0 - p, x0 + tx + p)
        if periodic_x:
            gx, xin = gx % Dx, torch.ones_like(gx, dtype=torch.bool)
        else:
            xin = (gx >= 0) & (gx < Dx)
        gy = torch.arange(y0 - p, y0 + ty + p)
        inside = ((gy >= 0) & (gy < Dy))[:, None] & xin[None, :]
        gxc, gyc = gx.clamp(0, Dx - 1), gy.clamp(0, Dy - 1)
        zhi = z1 - 1 + p                 # the last input plane read

        @functools.lru_cache(maxsize=None)
        def plane_ab(z):
            """(a, b) [ty, tx] of input plane z, zero where no output of
            the chunk reads it."""
            if not 0 <= z < Dz or z > zhi:
                return x.new_zeros(ty, tx), x.new_zeros(ty, tx)
            src = p0 if z == 0 and not own0 else x[z]
            u = torch.where(inside, src[gyc][:, gxc], zero)
            if z == zt:
                u = torch.zeros_like(u)
            t1 = sum(akx[:, j, None] * u[None, :, j] for j in range(w))
            t2 = sum(amx[:, j, None] * u[None, :, j] for j in range(w))
            a = (sum(t1[:, r, None] * bmy[None, :, r] for r in range(h))
                 + sum(t2[:, r, None] * bky[None, :, r] for r in range(h)))
            b = sum(t2[:, r, None] * bmy[None, :, r] for r in range(h))
            return a.T, b.T

        for zb in range(z0, z1, 8):
            win = [plane_ab(z) for z in range(zb - 8, zb + 16)]
            zm, zk = _band_tile(Mz, zb, 8, 24), _band_tile(Kz, zb, 8, 24)
            for n in range(min(8, z1 - zb)):
                zo = zb + n
                out = (sum(zm[n, k] * win[k][0] for k in range(24))
                       + sum(zk[n, k] * win[k][1] for k in range(24)))
                if zo == zt:
                    out = x[zo, y0:y0 + ty, x0:x0 + tx]
                y[zo, y0:y1, x0:x1] = out[:y1 - y0, :x1 - x0]


def _check(x: torch.Tensor, bands, periodic) -> int:
    """Validate what the kernel takes; returns the half-bandwidth p."""
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [Dz, Dy, Dx] tensor")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sep_apply takes float32 or float64, got {x.dtype}")
    if len(bands) != 6:
        raise ValueError("bands must be (Kx, Mx, Ky, My, Kz, Mz)")
    if periodic[1] or periodic[2]:
        raise ValueError("only the x axis may be periodic")
    Dz, Dy, Dx = x.shape
    p = (bands[0].shape[0] - 1) // 2
    for c, D in zip(bands, (Dx, Dx, Dy, Dy, Dz, Dz)):
        if c.shape != (2 * p + 1, D):
            raise ValueError(f"band of shape {tuple(c.shape)}, expected "
                             f"{(2 * p + 1, D)}")
        if c.dtype != x.dtype or c.device != x.device:
            raise ValueError("bands must match x in dtype and device")
        if not c.is_contiguous():
            raise ValueError("bands must be contiguous")
    if periodic[0] and Dx <= 2 * p:
        raise ValueError("periodic x needs Dx > 2p (band offsets alias)")
    if not 1 <= p <= MAX_P:
        raise ValueError(f"p = {p}: the kernel takes 1 <= p <= {MAX_P}")
    if x.numel() >= 2 ** 31:
        raise ValueError("lattice too large for the kernel's int sizes")
    return p


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    """The library's C entry for ``dtype`` (built at first use)."""
    from ._build import load_library
    lib = load_library("sep_apply")
    fn = lib.sep_apply_f32 if dtype == torch.float32 else lib.sep_apply_f64
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def sep_apply(x: torch.Tensor, bands, periodic,
              ess_top: bool = False) -> torch.Tensor:
    """``A x`` on ``x [Dz, Dy, Dx]``: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    global LAUNCHES
    if x.device.type == "cpu":
        return sep_apply_reference(x, bands, periodic, ess_top)
    if x.device.type != "cuda":
        raise ValueError(f"sep_apply: unsupported device {x.device}")
    p = _check(x, bands, periodic)
    fn = _entry(x.dtype)
    Dz, Dy, Dx = x.shape
    tiles = choose_tiles((Dx, Dy, Dz), p, x.element_size())
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), *(c.data_ptr() for c in bands),
                Dx, Dy, Dz, p, int(bool(periodic[0])), int(bool(ess_top)),
                *tiles, tile_smem_bytes(p, tiles, x.element_size()), stream)
    if rc != 0:
        raise RuntimeError(f"sep_apply kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    LAUNCHES_BY_P[p] = LAUNCHES_BY_P.get(p, 0) + 1
    _count_tc(p, x.element_size())
    return y


def _count_tc(p: int, itemsize: int) -> None:
    if tensor_core_route(p, itemsize):
        LAUNCHES_TC_BY_P[p] = LAUNCHES_TC_BY_P.get(p, 0) + 1


@functools.lru_cache(maxsize=None)
def _shard_entry(dtype: torch.dtype):
    """The library's shard-mode C entry for ``dtype``."""
    from ._build import load_library
    lib = load_library("sep_apply")
    fn = (lib.sep_apply_shard_f32 if dtype == torch.float32
          else lib.sep_apply_shard_f64)
    fn.argtypes = _SHARD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_shard(x, bands_xy, zbands, periodic_x, scal, p0, dims) -> int:
    """Validate what the shard entry takes; returns p."""
    Dx, Dy, Dz = dims
    if x.dim() != 2 or not x.is_contiguous() or x.shape[1] < Dx * Dy * Dz:
        raise ValueError("x must be a contiguous [ndev, >= Dx*Dy*Dz] tensor")
    ndev = x.shape[0]
    p = (bands_xy[0].shape[0] - 1) // 2
    if not 1 <= p <= MAX_P:
        raise ValueError(f"p = {p}: the kernel takes 1 <= p <= {MAX_P}")
    if periodic_x and Dx <= 2 * p:
        raise ValueError("periodic x needs Dx > 2p (band offsets alias)")
    shapes = [(b, (2 * p + 1, D)) for b, D in zip(bands_xy, (Dx, Dx, Dy, Dy))]
    shapes += [(z, (ndev, 2 * p + 1, Dz)) for z in zbands]
    for b, shape in shapes:
        if tuple(b.shape) != shape or not b.is_contiguous():
            raise ValueError(f"band of shape {tuple(b.shape)}, expected a "
                             f"contiguous {shape}")
        if b.dtype != x.dtype or b.device != x.device:
            raise ValueError("bands must match x in dtype and device")
    if (p0.dim() != 2 or p0.shape[0] != ndev or p0.shape[1] < Dx * Dy
            or p0.stride(1) != 1 or p0.dtype != x.dtype
            or p0.device != x.device):
        raise ValueError("p0 must be [ndev, >= Dx*Dy] rows in x's dtype")
    if (scal.shape != (ndev, 2) or scal.dtype != torch.int32
            or not scal.is_contiguous() or scal.device != x.device):
        raise ValueError("scal must be a contiguous int32 [ndev, 2] tensor "
                         "on x's device")
    if x.numel() >= 2 ** 31:
        raise ValueError("windows too large for the kernel's int sizes")
    return p


def check_scal(scal, Dz: int) -> None:
    """Raise unless every row ``(zt, own0)`` has ``zt`` -1 or in [1, Dz)
    and ``own0`` 0 or 1 (host values; the kernel reads them unchecked)."""
    for zt, own0 in _shard_rows(scal):
        if not (zt == -1 or 1 <= zt < Dz) or own0 not in (0, 1):
            raise ValueError(f"shard row ({zt}, {own0}) outside zt in "
                             f"{{-1}} U [1, {Dz}), own0 in {{0, 1}}")


def sep_apply_shard(x: torch.Tensor, bands_xy, zbands, periodic_x: bool,
                    scal: torch.Tensor, p0: torch.Tensor,
                    dims) -> tuple[torch.Tensor, torch.Tensor]:
    """Shard mode (the module docstring) on ``ndev`` stacked windows, the
    arguments of :func:`sep_apply_shard_reference` (``scal`` checked by
    :func:`check_scal` when the caller built it): one kernel launch for a
    CUDA tensor, the plain version for a CPU tensor."""
    global LAUNCHES_SHARD
    if x.device.type == "cpu":
        return sep_apply_shard_reference(x, bands_xy, zbands, periodic_x,
                                         scal, p0, dims)
    if x.device.type != "cuda":
        raise ValueError(f"sep_apply_shard: unsupported device {x.device}")
    p = _check_shard(x, bands_xy, zbands, periodic_x, scal, p0, dims)
    fn = _shard_entry(x.dtype)
    Dx, Dy, Dz = dims
    ndev = x.shape[0]
    tiles = choose_tiles((Dx, Dy, Dz), p, x.element_size(), ndev)
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        yhalo = torch.empty(ndev, Dx * Dy, dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(),
                *(b.data_ptr() for b in bands_xy),
                *(z.data_ptr() for z in zbands), Dx, Dy, Dz, p,
                int(bool(periodic_x)), *tiles,
                tile_smem_bytes(p, tiles, x.element_size()), scal.data_ptr(),
                p0.data_ptr(), yhalo.data_ptr(), ndev, x.shape[1],
                y.shape[1], p0.stride(0), stream)
    if rc != 0:
        raise RuntimeError(f"sep_apply_shard kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES_SHARD += 1
    LAUNCHES_SHARD_BY_P[p] = LAUNCHES_SHARD_BY_P.get(p, 0) + 1
    _count_tc(p, x.element_size())
    return y, yhalo
