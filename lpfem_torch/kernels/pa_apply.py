"""Element-form Laplace apply on curved hexes: CUDA kernel wrapper and its
plain version.

``ye[e] = Jr2^T (G6[e] o (Jr2 u[e]))`` for every element: the reference
gradient at the q^3 Gauss points, the symmetric metric per point, and the
transposed gradient. ``u [ne, (p+1)^3]`` is the E-vector (z, y, x; x
fastest), ``G6q [ne, 6Q]`` the metric in component-major layout
``(xx, xy, xz, yy, yz, zz)`` (``lpfem/operators.py:544-545``), ``B``/``D``
``[q, p+1]`` the 1D basis values and derivatives at the Gauss points, from
which ``Jr2 = [B(x)B(x)D; B(x)D(x)B; D(x)B(x)B]`` [3Q, (p+1)^3] is formed
(:func:`grad_interp`).

- :func:`pa_apply_element` runs ``csrc/pa_apply.cu`` (the port of the TPU
  kernel ``lpfem/kernels/pa_apply.py::pa_apply_element_kernel``, B3b,
  sum-factorised) on CUDA tensors and counts each launch in ``LAUNCHES``.
  It takes the plain version only because its input lies on the CPU; on a
  CUDA tensor it launches the kernel or raises.
- :func:`pa_apply_element_reference` is the plain PyTorch version: two
  dense matmuls with the metric between, lpfem's ``fused`` mode
  (``lpfem/operators.py:701-714``), in full float32 / float64 precision.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["grad_interp", "pa_apply_element", "pa_apply_element_reference"]

LAUNCHES = 0          # kernel launches through pa_apply_element

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_MAX_P1 = 8           # the kernel's shared-memory plan (csrc/pa_apply.cu)


def grad_interp(B: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Jr2 [3Q, (p+1)^3] from the 1D tables ``B``, ``D`` [q, p+1]
    (``lpfem.operators._grad_interp_matrix`` stacked)."""
    q, p1 = B.shape
    Q, L = q ** 3, p1 ** 3
    g_x = torch.einsum("cz,by,ax->cbazyx", B, B, D)
    g_y = torch.einsum("cz,by,ax->cbazyx", B, D, B)
    g_z = torch.einsum("cz,by,ax->cbazyx", D, B, B)
    return torch.cat([g.reshape(Q, L) for g in (g_x, g_y, g_z)], dim=0)


def pa_apply_element_reference(u: torch.Tensor, G6q: torch.Tensor,
                               B: torch.Tensor, D: torch.Tensor
                               ) -> torch.Tensor:
    """Plain PyTorch ``ye = Jr2^T (G6 o (Jr2 u))``, as lpfem's fused mode."""
    Q = B.shape[0] ** 3
    Jr2 = grad_interp(B, D)
    g = u @ Jr2.T                                       # [ne, 3Q]
    gx, gy, gz = g[:, :Q], g[:, Q:2 * Q], g[:, 2 * Q:]
    Gxx, Gxy, Gxz = G6q[:, :Q], G6q[:, Q:2 * Q], G6q[:, 2 * Q:3 * Q]
    Gyy, Gyz, Gzz = G6q[:, 3 * Q:4 * Q], G6q[:, 4 * Q:5 * Q], G6q[:, 5 * Q:]
    h = torch.cat([Gxx * gx + Gxy * gy + Gxz * gz,
                   Gxy * gx + Gyy * gy + Gyz * gz,
                   Gxz * gx + Gyz * gy + Gzz * gz], dim=1)
    return h @ Jr2                                      # [ne, L]


def _check(u, G6q, B, D) -> tuple[int, int, int]:
    """Validate what the kernel takes; returns (ne, p+1, q)."""
    if u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pa_apply_element takes float32 or float64, got "
                        f"{u.dtype}")
    for name, t in (("u", u), ("G6q", G6q), ("B", B), ("D", D)):
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
        if t.dtype != u.dtype or t.device != u.device:
            raise ValueError("u, G6q, B and D must match in dtype and device")
    q, p1 = B.shape
    ne = u.shape[0]
    if D.shape != (q, p1) or u.shape != (ne, p1 ** 3):
        raise ValueError(f"shapes u {tuple(u.shape)}, B {tuple(B.shape)}, "
                         f"D {tuple(D.shape)} do not fit")
    if G6q.shape != (ne, 6 * q ** 3):
        raise ValueError(f"G6q of shape {tuple(G6q.shape)}, expected "
                         f"{(ne, 6 * q ** 3)}")
    if not (2 <= p1 <= _MAX_P1 and 1 <= q <= _MAX_P1):
        raise ValueError(f"p+1 = {p1}, q = {q}: the kernel takes 2 <= p+1 "
                         f"<= {_MAX_P1} and q <= {_MAX_P1}")
    if G6q.numel() >= 2 ** 31:
        raise ValueError("too many elements for the kernel's int sizes")
    return ne, p1, q


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    """The library's C entry for ``dtype`` (built at first use)."""
    from ._build import load_library
    lib = load_library("pa_apply")
    fn = (lib.pa_apply_element_f32 if dtype == torch.float32
          else lib.pa_apply_element_f64)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def pa_apply_element(u: torch.Tensor, G6q: torch.Tensor, B: torch.Tensor,
                     D: torch.Tensor) -> torch.Tensor:
    """``ye [ne, (p+1)^3]``: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    global LAUNCHES
    if u.device.type == "cpu":
        return pa_apply_element_reference(u, G6q, B, D)
    if u.device.type != "cuda":
        raise ValueError(f"pa_apply_element: unsupported device {u.device}")
    ne, p1, q = _check(u, G6q, B, D)
    fn = _entry(u.dtype)
    with torch.cuda.device(u.device):
        ye = torch.empty_like(u)
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = fn(u.data_ptr(), G6q.data_ptr(), B.data_ptr(), D.data_ptr(),
                ye.data_ptr(), ne, p1, q, stream)
    if rc != 0:
        raise RuntimeError(f"pa_apply_element kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return ye
