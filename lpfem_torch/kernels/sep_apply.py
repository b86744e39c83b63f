"""Banded Kronecker Laplace apply: CUDA kernel wrapper and its plain version.

``y = (Mz (x) My (x) Kx + Mz (x) Ky (x) Mx + Kz (x) My (x) Mx) x`` on the
``[Dz, Dy, Dx]`` dof lattice, with ``bands = (Kx, Mx, Ky, My, Kz, Mz)`` in the
diagonal-offset form of ``lpfem.operators.SeparableLattice``
(``band[p + s, i] = G[i, i + s]``, shape ``[2p+1, D_a]``). ``ess_top`` gives
identity rows and columns on the top z-plane.

- :func:`sep_apply` runs ``csrc/sep_apply.cu`` (the port of the TPU kernel
  ``lpfem/kernels/sep_apply.py::lattice_sep_apply``) on CUDA tensors and
  counts each launch in ``LAUNCHES``. It takes the plain version only
  because its input lies on the CPU; on a CUDA tensor it launches the
  kernel or raises.
- :func:`sep_apply_reference` is the plain PyTorch version, with the sums
  of ``SeparableLattice._axis/apply3`` in the same order.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

__all__ = ["sep_apply", "sep_apply_reference"]

LAUNCHES = 0          # kernel launches through sep_apply (never the plain path)

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


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
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        scratch = torch.empty(4 * x.numel(), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), scratch.data_ptr(),
                *(c.data_ptr() for c in bands),
                Dx, Dy, Dz, p, int(bool(periodic[0])), int(bool(ess_top)),
                stream)
    if rc != 0:
        raise RuntimeError(f"sep_apply kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return y
