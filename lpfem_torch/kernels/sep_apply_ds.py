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
- :func:`sep_apply_ds_reference` is the plain PyTorch version in the
  kernel's form: three passes, each shifting its input once and feeding
  all of its accumulators, every accumulator starting from zero and taking
  its terms s = -p..p in order. Its Dekker product gives the same exact
  error as the kernel's ``fmaf``, so the two agree bit for bit.

lpfem's per-layer z tables (``build_sep_tables_ds``) and its VMEM estimate
serve the TPU kernel's sequential layer carry and have no counterpart: the
kernel reads the global z bands, as B1's port does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ds import DS, ds_add, ds_norm, split, two_prod_presplit, two_sum
from .sep_apply import _shifts

__all__ = ["sep_apply_ds", "sep_apply_ds_reference"]

LAUNCHES = 0     # kernel launches through sep_apply_ds (never the plain path)

_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


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
    CUDA tensors, the plain version for CPU tensors."""
    global LAUNCHES
    if xh.device.type == "cpu":
        return sep_apply_ds_reference(xh, xl, ds_bands, periodic, ess_top)
    if xh.device.type != "cuda":
        raise ValueError(f"sep_apply_ds: unsupported device {xh.device}")
    p = _check(xh, xl, ds_bands, periodic)
    fn = _entry()
    Dz, Dy, Dx = xh.shape
    with torch.cuda.device(xh.device):
        yh = torch.empty_like(xh)
        yl = torch.empty_like(xl)
        # t1, t2, a, b, each a (hi, lo) pair
        scratch = torch.empty(8 * xh.numel(), dtype=torch.float32,
                              device=xh.device)
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        rc = fn(xh.data_ptr(), xl.data_ptr(), yh.data_ptr(), yl.data_ptr(),
                scratch.data_ptr(),
                *(c.data_ptr() for band in ds_bands for c in band),
                Dx, Dy, Dz, p, int(bool(periodic[0])), int(bool(ess_top)),
                stream)
    if rc != 0:
        raise RuntimeError(f"sep_apply_ds kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return DS(yh, yl)
