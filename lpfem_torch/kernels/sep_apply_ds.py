"""Double-single banded Kronecker apply: CUDA kernel wrapper and its plain version.

B1's operator ``A = Mz (x) My (x) Kx + Mz (x) Ky (x) Mx + Kz (x) My (x) Mx``
on a DS pair: ``(yh, yl) = A (xh, xl)`` with every value a pair of float32
tensors ``[Dz, Dy, Dx]`` and every product and sum error-free, dropping only
``c.lo * u.lo`` (about 2^-48 relative). ``ds_bands`` are the six bands
``(Kx, Mx, Ky, My, Kz, Mz)`` as :class:`~lpfem_torch.ds.DS` pairs of the
float64 tables ``[2p+1, D_a]`` (``SeparableDS.bands``). ``ess_top`` gives
identity rows and columns on the top z-plane.

- :func:`sep_apply_ds` runs ``csrc/sep_apply_ds.cu`` (the port of the TPU
  kernel ``lpfem/kernels/sep_apply_ds.py::lattice_sep_apply_ds``) on CUDA
  tensors and counts each launch in ``LAUNCHES``. It takes the plain version
  only because its input lies on the CPU; on a CUDA tensor it launches the
  kernel or raises.
- :func:`sep_apply_ds_reference` is the plain PyTorch version: three
  passes, each shifting its input once and feeding all of its
  accumulators, every accumulator starting from zero and taking its terms
  s = -p..p in order, as the kernel's do. Its Dekker product gives the same
  exact error as the kernel's ``fmaf``, so the two agree bit for bit.
- :func:`choose_ds_tiles` picks the kernel's tiles (one launch per apply,
  B1's design: a block owns the outputs of a ``Tx x Ty`` tile of (x, y)
  columns over a z-chunk of ``Tz`` planes) and :func:`sep_apply_ds_mirror`
  runs the same decomposition with the same eager operations, so the CPU
  tests check, bit for bit, what each block reads and sums.

lpfem's per-layer z tables (``build_sep_tables_ds``) and its VMEM estimate
serve the TPU kernel's sequential layer carry and have no counterpart: the
kernel reads the global z bands, as B1's port does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ds import DS, ds_add, ds_norm, split, two_prod_presplit, two_sum
from .sep_apply import SMEM_LIMIT, TARGET_BLOCKS, _shifts, tile_blocks

__all__ = ["sep_apply_ds", "sep_apply_ds_reference", "sep_apply_ds_mirror",
           "choose_ds_tiles", "ds_tile_smem_bytes"]

LAUNCHES = 0     # kernel launches through sep_apply_ds (never the plain path)

# The kernel's limits (csrc/sep_apply_ds.cu: kMaxP, kMaxThreads, kTx,
# fixed_order); its entry refuses tiles past them, and shared-memory bytes
# other than those of its own layout (TileSmem), so a drift of these or of
# ds_tile_smem_bytes fails the launch.
MAX_P = 10            # the general instantiation's reach
MAX_THREADS = 288     # Tx * Ty (__launch_bounds__, two blocks per SM)
FIXED_P = (1, 2, 4)   # ring in registers; other orders keep it in shared
TX = 8                # tile columns (kTx), also where Dx is narrower

_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


class _Acc:
    """Compensated accumulator of the terms ``c * u`` (both DS), the
    kernel's: ``pr + e = c.hi * u.hi`` exactly, plus the cross terms
    ``c.hi * u.lo`` and ``c.lo * u.hi`` in the error; ``pr`` summed exactly
    with ``two_sum``, errors into the lo stream. Separate eager operations
    only (no fused multiply-add: module docstring of ``lpfem_torch.ds``)."""

    def __init__(self, like: torch.Tensor):
        self.h = torch.zeros_like(like)
        self.l = torch.zeros_like(like)

    def add(self, ch, cl, u, ulo):
        pr, err = two_prod_presplit(ch, u, *split(ch), *split(u))
        err = (err + ch * ulo) + cl * u
        self.h, t = two_sum(self.h, pr)
        self.l = self.l + (t + err)

    def norm(self) -> DS:
        return ds_norm(self.h, self.l)


def _coef(c: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    shape = [1, 1, 1]
    shape[axis] = c.shape[1]
    return c[k].reshape(shape)


def _pass(inputs, terms, axis: int, p: int, periodic: bool):
    """One axis pass: ``terms`` = [(band, index into inputs)] per
    accumulator; returns the normalised accumulators."""
    sh = [(_shifts(v.hi, axis, p, periodic), _shifts(v.lo, axis, p, periodic))
          for v in inputs]
    accs = [_Acc(inputs[0].hi) for _ in terms]
    for k in range(2 * p + 1):
        for acc, (band, j) in zip(accs, terms):
            acc.add(_coef(band.hi, k, axis), _coef(band.lo, k, axis),
                    sh[j][0][k], sh[j][1][k])
    return [acc.norm() for acc in accs]


def sep_apply_ds_reference(xh: torch.Tensor, xl: torch.Tensor, ds_bands,
                           periodic, ess_top: bool = False) -> DS:
    """Plain PyTorch ``A (xh, xl)`` on the lattice view ``[Dz, Dy, Dx]``;
    ``periodic = (px, py, pz)``."""
    Kx, Mx, Ky, My, Kz, Mz = ds_bands
    px, py, pz = periodic
    p = (Kx.hi.shape[0] - 1) // 2
    u = DS(xh, xl)
    if ess_top:
        u = DS(xh.clone(), xl.clone())
        u.hi[-1] = 0.0
        u.lo[-1] = 0.0
    t1, t2 = _pass([u], [(Kx, 0), (Mx, 0)], 2, p, px)
    a1, a2, b = _pass([t1, t2], [(My, 0), (Ky, 1), (My, 1)], 1, p, py)
    ya, yb = _pass([ds_add(a1, a2), b], [(Mz, 0), (Kz, 1)], 0, p, pz)
    y = ds_add(ya, yb)
    if ess_top:
        y.hi[-1] = xh[-1]
        y.lo[-1] = xl[-1]
    return y


def ds_tile_smem_bytes(p: int, tiles) -> int:
    """Dynamic shared memory of one block (the kernel's ``TileSmem``; the
    entry takes these bytes and checks them): three u planes of both
    streams in float, then in float4 two t tiles, the ring of 2p+1 planes
    per thread (orders outside ``FIXED_P`` only), the x bands of the tile's
    columns, the y bands of its rows and four planes' z bands; then the
    copy table in int2 and the row offsets in int."""
    tx, ty, _, s = tiles
    h, w, r = ty + 2 * p, tx + 2 * p, 2 * p + 1
    threads = -(-tx * ty // 32) * 32
    ring = 0 if p in FIXED_P else 16 * r * threads
    u = -(-(4 * 3 * 2 * h * s) // 16) * 16
    return (u + 2 * 16 * h * tx + ring + 16 * r * tx + 16 * r * ty
            + 16 * 4 * r + 8 * h * w + 4 * h)


@functools.lru_cache(maxsize=64)
def choose_ds_tiles(dims, p: int) -> tuple[int, int, int, int]:
    """``(Tx, Ty, Tz, S)`` of the kernel for the lattice ``dims = (Dx, Dy,
    Dz)``: Tx = ``TX`` columns; Ty the whole y axis while ``Tx * Dy <=
    MAX_THREADS`` (the y halo then lies past the ends), else the axis split
    evenly, and split further while a block's shared memory exceeds
    Hopper's; the z-chunk Tz such that the grid has at most
    ``TARGET_BLOCKS`` blocks (one wave of two blocks per SM; the chunks'
    halo planes are recomputed, so deep chunks do less work), chunks as even
    as Dz allows; S the u tile's row stride, at least Tx + 2p and congruent
    to Tx modulo 32, so the rows a warp reads fall in distinct banks."""
    Dx, Dy, Dz = dims
    tx = TX
    s = tx + 2 * p
    s += (tx - s) % 32
    ny = -(-Dy // (MAX_THREADS // tx))
    ty = -(-Dy // ny)
    while ds_tile_smem_bytes(p, (tx, ty, 1, s)) > SMEM_LIMIT:
        ny += 1
        ty = -(-Dy // ny)
    nxy = -(-Dx // tx) * -(-Dy // ty)
    chunks = min(Dz, max(1, TARGET_BLOCKS // nxy))
    tz = -(-Dz // chunks)
    return tx, ty, tz, s


def sep_apply_ds_mirror(xh: torch.Tensor, xl: torch.Tensor, ds_bands,
                        periodic, ess_top: bool = False, tiles=None) -> DS:
    """Plain PyTorch ``A (xh, xl)`` in the kernel's decomposition (``tiles``
    from :func:`choose_ds_tiles` unless given): per block, each input plane
    of its z-chunk and the chunk's p halo planes on either side (within the
    lattice) is read as a ``(Ty+2p) x (Tx+2p)`` tile of both streams (x
    wrapped on a periodic axis, zero past the ends otherwise, y zero past
    the ends, the top plane zero under ``ess_top``), contracted in x on the
    tile rows inside the lattice (t = 0 on the others) and in y on the
    output rows; the last 2p+1 planes' (a, b) form a ring, zero past the
    top, from which each output plane is emitted. Every accumulator is the
    kernel's and the plain version's, terms s = -p..p in order, so the three
    agree bit for bit."""
    Kx, Mx, Ky, My, Kz, Mz = ds_bands
    if periodic[1] or periodic[2]:
        raise ValueError("only the x axis may be periodic")
    Dz, Dy, Dx = xh.shape
    p = (Kx.hi.shape[0] - 1) // 2
    R = 2 * p + 1
    if tiles is None:
        tiles = choose_ds_tiles((Dx, Dy, Dz), p)
    tx, ty, tz, _ = tiles
    yh, yl = torch.empty_like(xh), torch.empty_like(xl)
    zero = xh.new_zeros(())

    def pick(band, idx, ok):          # band values at idx, zero where not ok
        return DS(torch.where(ok, band.hi[:, idx], zero),
                  torch.where(ok, band.lo[:, idx], zero))

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
        cx, cy = torch.arange(x0, x0 + tx), torch.arange(y0, y0 + ty)
        kx = pick(Kx, cx.clamp(max=Dx - 1), cx < Dx)   # [R, tx]
        mx = pick(Mx, cx.clamp(max=Dx - 1), cx < Dx)
        ky = pick(Ky, cy.clamp(max=Dy - 1), cy < Dy)   # [R, ty]
        my = pick(My, cy.clamp(max=Dy - 1), cy < Dy)
        nil = DS(xh.new_zeros(ty, tx), xh.new_zeros(ty, tx))
        ring = [(nil, nil)] * R
        for z in range(max(0, z0 - p), z1 + p):
            a = b = nil
            if z < Dz:
                uh = torch.where(inside, xh[z][gyc][:, gxc], zero)
                ul = torch.where(inside, xl[z][gyc][:, gxc], zero)
                if ess_top and z == Dz - 1:
                    uh, ul = torch.zeros_like(uh), torch.zeros_like(ul)
                s1, s2 = _Acc(uh[:, :tx]), _Acc(uh[:, :tx])
                for k in range(R):
                    u, ulo = uh[:, k:k + tx], ul[:, k:k + tx]
                    s1.add(kx.hi[k], kx.lo[k], u, ulo)
                    s2.add(mx.hi[k], mx.lo[k], u, ulo)
                t1, t2 = (DS(torch.where(yin[:, None], v.hi, zero),
                             torch.where(yin[:, None], v.lo, zero))
                          for v in (s1.norm(), s2.norm()))
                a1, a2, bb = _Acc(nil.hi), _Acc(nil.hi), _Acc(nil.hi)
                for k in range(R):
                    ch, cl = my.hi[k, :, None], my.lo[k, :, None]
                    a1.add(ch, cl, t1.hi[k:k + ty], t1.lo[k:k + ty])
                    a2.add(ky.hi[k, :, None], ky.lo[k, :, None],
                           t2.hi[k:k + ty], t2.lo[k:k + ty])
                    bb.add(ch, cl, t2.hi[k:k + ty], t2.lo[k:k + ty])
                a, b = ds_add(a1.norm(), a2.norm()), bb.norm()
            ring = ring[1:] + [(a, b)]
            zo = z - p
            if zo < z0:
                continue
            if ess_top and zo == Dz - 1:
                out = DS(xh[zo, y0:y1, x0:x1], xl[zo, y0:y1, x0:x1])
            else:
                ya, yb = _Acc(nil.hi), _Acc(nil.hi)
                for k in range(R):
                    ya.add(Mz.hi[k, zo], Mz.lo[k, zo], *ring[k][0])
                    yb.add(Kz.hi[k, zo], Kz.lo[k, zo], *ring[k][1])
                y = ds_add(ya.norm(), yb.norm())
                out = DS(y.hi[:y1 - y0, :x1 - x0], y.lo[:y1 - y0, :x1 - x0])
            yh[zo, y0:y1, x0:x1] = out.hi
            yl[zo, y0:y1, x0:x1] = out.lo
    return DS(yh, yl)


def _check(xh: torch.Tensor, xl: torch.Tensor, ds_bands, periodic) -> int:
    """Validate what the kernel takes; returns the half-bandwidth p."""
    for v in (xh, xl):
        if v.dim() != 3 or not v.is_contiguous():
            raise ValueError("xh, xl must be contiguous [Dz, Dy, Dx] tensors")
        if v.dtype != torch.float32 or v.device != xh.device:
            raise ValueError("xh, xl must be float32 on one device")
    if xl.shape != xh.shape:
        raise ValueError("xh and xl differ in shape")
    if len(ds_bands) != 6:
        raise ValueError("ds_bands must be (Kx, Mx, Ky, My, Kz, Mz)")
    if periodic[1] or periodic[2]:
        raise ValueError("only the x axis may be periodic")
    Dz, Dy, Dx = xh.shape
    p = (ds_bands[0].hi.shape[0] - 1) // 2
    for band, D in zip(ds_bands, (Dx, Dx, Dy, Dy, Dz, Dz)):
        for c in band:
            if c.shape != (2 * p + 1, D):
                raise ValueError(f"band of shape {tuple(c.shape)}, expected "
                                 f"{(2 * p + 1, D)}")
            if c.dtype != torch.float32 or c.device != xh.device:
                raise ValueError("bands must be float32 on x's device")
            if not c.is_contiguous():
                raise ValueError("bands must be contiguous")
    if periodic[0] and Dx <= 2 * p:
        raise ValueError("periodic x needs Dx > 2p (band offsets alias)")
    if not 1 <= p <= MAX_P:
        raise ValueError(f"p = {p}: the kernel takes 1 <= p <= {MAX_P}")
    if xh.numel() >= 2 ** 31:
        raise ValueError("lattice too large for the kernel's int sizes")
    return p


@functools.lru_cache(maxsize=None)
def _entry():
    """The library's C entry (built at first use)."""
    from ._build import load_library
    fn = load_library("sep_apply_ds").sep_apply_ds_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def sep_apply_ds(xh: torch.Tensor, xl: torch.Tensor, ds_bands, periodic,
                 ess_top: bool = False) -> DS:
    """``A (xh, xl)`` on ``[Dz, Dy, Dx]`` float32 pairs: the CUDA kernel for
    CUDA tensors (one launch), the plain version for CPU tensors."""
    global LAUNCHES
    if xh.device.type == "cpu":
        return sep_apply_ds_reference(xh, xl, ds_bands, periodic, ess_top)
    if xh.device.type != "cuda":
        raise ValueError(f"sep_apply_ds: unsupported device {xh.device}")
    p = _check(xh, xl, ds_bands, periodic)
    fn = _entry()
    Dz, Dy, Dx = xh.shape
    tiles = choose_ds_tiles((Dx, Dy, Dz), p)
    with torch.cuda.device(xh.device):
        yh = torch.empty_like(xh)
        yl = torch.empty_like(xl)
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        rc = fn(xh.data_ptr(), xl.data_ptr(), yh.data_ptr(), yl.data_ptr(),
                *(c.data_ptr() for band in ds_bands for c in band),
                Dx, Dy, Dz, p, int(bool(periodic[0])), int(bool(ess_top)),
                *tiles, ds_tile_smem_bytes(p, tiles), stream)
    if rc != 0:
        raise RuntimeError(f"sep_apply_ds kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return DS(yh, yl)
