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
- :func:`sep_apply_reference` is the plain PyTorch version, with the sums
  of ``SeparableLattice._axis/apply3`` in the same order.
- :func:`choose_tiles` picks the kernel's tiles (one launch per apply: a
  block owns the outputs of a ``Tx x Ty`` tile of (x, y) columns over a
  z-chunk of ``Tz`` planes) and :func:`sep_apply_mirror` runs the same
  decomposition in plain PyTorch, so the CPU tests check what each block
  reads and sums: x tiles with a wrapped or zero halo, y tiles, z-chunks
  whose halo planes are recomputed, and the ring of the last 2p+1 planes.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

__all__ = ["sep_apply", "sep_apply_reference", "sep_apply_mirror",
           "choose_tiles", "tile_blocks", "tile_smem_bytes"]

LAUNCHES = 0          # kernel launches through sep_apply (never the plain path)
LAUNCHES_BY_P: dict[int, int] = {}     # the same launches by order p

# The kernel's limits (csrc/sep_apply.cu: kMaxP, max_threads<T>()); its
# entry refuses tiles past them, and shared-memory bytes other than those of
# its own layout (TileSmem), so a drift of these or of tile_smem_bytes fails
# the launch.
MAX_P = 10            # the general instantiation's reach
MAX_THREADS = {4: 288, 8: 160}   # Tx * Ty by itemsize (__launch_bounds__)
TARGET_BLOCKS = 264   # two blocks per SM of an H100 (132 SMs)
SMEM_LIMIT = 232_448  # shared memory a block may use on Hopper (227 KB)

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


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
    Kx, Mx, Ky, My, Kz, Mz = bands
    px, py, pz = periodic
    p = (Kx.shape[0] - 1) // 2
    u = x
    if ess_top:
        u = x.clone()
        u[-1] = 0.0
    us = _shifts(u, 2, p, px)
    t1, t2 = _contract(Kx, us, 2), _contract(Mx, us, 2)
    t1s, t2s = _shifts(t1, 1, p, py), _shifts(t2, 1, p, py)
    a = _contract(My, t1s, 1) + _contract(Ky, t2s, 1)
    b = _contract(My, t2s, 1)
    y = (_contract(Mz, _shifts(a, 0, p, pz), 0)
         + _contract(Kz, _shifts(b, 0, p, pz), 0))
    if ess_top:
        y[-1] = x[-1]
    return y


@functools.lru_cache(maxsize=64)
def choose_tiles(dims, p: int, itemsize: int) -> tuple[int, int, int, int]:
    """``(Tx, Ty, Tz, S)`` of the kernel for the lattice ``dims = (Dx, Dy,
    Dz)``: Tx = 8 columns in float, 4 in double; Ty the whole y axis while
    ``Tx * Dy <= MAX_THREADS[itemsize]`` (the y halo then lies past the
    ends), else
    the axis split evenly; the z-chunk Tz such that the grid has at least
    ``TARGET_BLOCKS`` blocks, chunks as even as Dz allows; S the u tile's
    row stride, at least Tx + 2p and congruent to Tx modulo the row width
    of a bank line, so the rows a warp reads fall in distinct banks."""
    Dx, Dy, Dz = dims
    tx = min(8 if itemsize == 4 else 4, Dx)
    rows = MAX_THREADS[itemsize] // tx
    ty = -(-Dy // -(-Dy // rows))
    nxy = -(-Dx // tx) * -(-Dy // ty)
    chunks = min(Dz, max(1, -(-TARGET_BLOCKS // nxy)))
    tz = -(-Dz // chunks)
    line = 32 * 4 // itemsize           # values per 32 banks
    s = tx + 2 * p
    s += (tx - s) % line
    return tx, ty, tz, s


def tile_smem_bytes(p: int, tiles, itemsize: int) -> int:
    """Dynamic shared memory of one block: three u planes in flight, t1,
    t2, three planes' z bands, the row offsets and the load offsets (the
    kernel's ``TileSmem``; the entry takes these bytes and checks them)."""
    tx, ty, _, s = tiles
    h, w = ty + 2 * p, tx + 2 * p
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
                     tiles=None) -> torch.Tensor:
    """Plain PyTorch ``A x`` in the kernel's decomposition (``tiles`` from
    :func:`choose_tiles` unless given): per block, each input plane of its
    z-chunk and the chunk's p halo planes on either side (within the
    lattice) is read as a ``(Ty+2p) x (Tx+2p)`` tile (x wrapped on a
    periodic axis, zero past the ends otherwise, y zero past the ends, the
    top plane zero under ``ess_top``), contracted in x on every tile row and
    in y on the output rows; the last 2p+1 planes' (a, b) form a ring, zero
    past the top, from which each output plane is emitted. Sums run
    s = -p..p in order."""
    Kx, Mx, Ky, My, Kz, Mz = bands
    if periodic[1] or periodic[2]:
        raise ValueError("only the x axis may be periodic")
    Dz, Dy, Dx = x.shape
    p = (Kx.shape[0] - 1) // 2
    R = 2 * p + 1
    if tiles is None:
        tiles = choose_tiles((Dx, Dy, Dz), p, x.element_size())
    tx, ty, tz, _ = tiles
    y = torch.empty_like(x)
    zero = x.new_zeros(())
    for x0, x1, y0, y1, z0, z1 in tile_blocks((Dx, Dy, Dz), tiles):
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
                u = torch.where(inside, x[z][gyc][:, gxc], zero)
                if ess_top and z == Dz - 1:
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
            if ess_top and zo == Dz - 1:
                out = x[zo, y0:y0 + ty, x0:x0 + tx]
            y[zo, y0:y1, x0:x1] = out[:y1 - y0, :x1 - x0]
    return y


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
    return y
