"""Element-form Laplace apply on hexes: CUDA kernel wrappers and their plain
versions.

``ye[e] = Jr2^T (G[e] o (Jr2 u[e]))`` for every element: the reference
gradient at the q^3 Gauss points, the symmetric metric per point, and the
transposed gradient. ``u [ne, (p+1)^3]`` is the E-vector (z, y, x; x
fastest), ``B``/``D`` ``[q, p+1]`` the 1D basis values and derivatives at
the Gauss points, from which ``Jr2 = [B(x)B(x)D; B(x)D(x)B; D(x)B(x)B]``
[3Q, (p+1)^3] is formed (:func:`grad_interp`). The metric comes in two
forms, each a TPU kernel of ``lpfem/kernels/pa_apply.py`` and here a kernel
of one CUDA source, ``csrc/pa_apply.cu`` (sum-factorised on the column body
of ``csrc/affine_body.cuh``, with the metric as its policy and the orders
fixed at compile time for p = 1..4, q = p+1; p+1, q <= 11 in all):

- full, on curved elements: ``G6q [ne, 6Q]`` in component-major layout
  ``(xx, xy, xz, yy, yz, zz)`` (``lpfem/operators.py:544-545``) —
  :func:`pa_apply_element`, the port of ``pa_apply_element_kernel`` (B3b);
- affine: ``G[e, k] = w3[k] C6[e]`` with ``C6 [ne, 6]`` constants per element
  and ``w3 [Q]`` the Gauss-weight products — :func:`pa_apply_affine`, the
  port of ``pa_apply_affine_kernel`` (B3a).

Each wrapper counts its launches (``LAUNCHES`` / ``LAUNCHES_AFFINE``, and
by element order p in ``LAUNCHES_BY_P`` / ``LAUNCHES_AFFINE_BY_P``) and
takes its plain version only because its input lies on the CPU; on a CUDA
tensor it launches the kernel or raises. The plain versions
(:func:`pa_apply_element_reference`, :func:`pa_apply_affine_reference`) are
two dense matmuls with the metric between, lpfem's ``fused`` mode
(``lpfem/operators.py:701-714``, ``_apply_G6`` / ``_apply_G6_affine``), in
full float32 / float64 precision. :func:`pa_apply_element_mirror` runs
the kernel's column body stage by stage in plain PyTorch (x, y forward on
the element's planes, z forward per column, the full metric read at
``(qz, qy, qx)``, z, y, x back), so the CPU tests check its decomposition.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["grad_interp", "pa_apply_element", "pa_apply_element_reference",
           "pa_apply_element_mirror", "pa_apply_affine",
           "pa_apply_affine_reference"]

LAUNCHES = 0          # kernel launches through pa_apply_element (B3b)
LAUNCHES_BY_P: dict[int, int] = {}          # the same by element order p
LAUNCHES_AFFINE = 0   # kernel launches through pa_apply_affine (B3a)
LAUNCHES_AFFINE_BY_P: dict[int, int] = {}   # the same by element order p

_MAX_P1 = 11          # the column body's reach (csrc/affine_body.cuh kMaxN)


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
                               B: torch.Tensor, D: torch.Tensor,
                               Jr2: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Plain PyTorch ``ye = Jr2^T (G6 o (Jr2 u))``, as lpfem's fused mode
    (``Jr2``: :func:`grad_interp` of ``B``, ``D``, formed when not given)."""
    Q = B.shape[0] ** 3
    Jr2 = grad_interp(B, D) if Jr2 is None else Jr2
    g = u @ Jr2.T                                       # [ne, 3Q]
    gx, gy, gz = g[:, :Q], g[:, Q:2 * Q], g[:, 2 * Q:]
    Gxx, Gxy, Gxz = G6q[:, :Q], G6q[:, Q:2 * Q], G6q[:, 2 * Q:3 * Q]
    Gyy, Gyz, Gzz = G6q[:, 3 * Q:4 * Q], G6q[:, 4 * Q:5 * Q], G6q[:, 5 * Q:]
    h = torch.cat([Gxx * gx + Gxy * gy + Gxz * gz,
                   Gxy * gx + Gyy * gy + Gyz * gz,
                   Gxz * gx + Gyz * gy + Gzz * gz], dim=1)
    return h @ Jr2                                      # [ne, L]


def pa_apply_element_mirror(u: torch.Tensor, G6q: torch.Tensor,
                            B: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``ye`` in the column body's stages (``csrc/
    affine_body.cuh`` with the full-metric policy): x forward on every
    (z, y) row, y forward on every (z, qx) line, then per (qy, qx) column
    the z contractions forward, the metric at (qz, qy, qx) and z back, then
    y back and x back."""
    ne = u.shape[0]
    q, p1 = B.shape
    U = u.reshape(ne, p1, p1, p1)                           # [e, z, y, x]
    s1 = torch.einsum("ax,ezyx->ezya", B, U)                # B_x u
    s2 = torch.einsum("ax,ezyx->ezya", D, U)                # D_x u
    a0 = torch.einsum("by,ezya->ezba", B, s2)               # B_y D_x
    a1 = torch.einsum("by,ezya->ezba", D, s1)               # D_y B_x
    a2 = torch.einsum("by,ezya->ezba", B, s1)               # B_y B_x
    gx = torch.einsum("cz,ezba->ecba", B, a0)               # columns (b, a)
    gy = torch.einsum("cz,ezba->ecba", B, a1)
    gz = torch.einsum("cz,ezba->ecba", D, a2)
    G = G6q.reshape(ne, 6, q, q, q)                         # [e, comp, c, b, a]
    h0 = G[:, 0] * gx + G[:, 1] * gy + G[:, 2] * gz
    h1 = G[:, 1] * gx + G[:, 3] * gy + G[:, 4] * gz
    h2 = G[:, 2] * gx + G[:, 4] * gy + G[:, 5] * gz
    b0 = torch.einsum("cz,ecba->ezba", B, h0)
    b1 = torch.einsum("cz,ecba->ezba", B, h1)
    b2 = torch.einsum("cz,ecba->ezba", D, h2)
    t0 = torch.einsum("by,ezba->ezya", B, b0)               # then D_x
    t1 = (torch.einsum("by,ezba->ezya", D, b1)
          + torch.einsum("by,ezba->ezya", B, b2))           # then B_x
    ye = (torch.einsum("ax,ezya->ezyx", D, t0)
          + torch.einsum("ax,ezya->ezyx", B, t1))
    return ye.reshape(ne, p1 ** 3)


def pa_apply_affine_reference(u: torch.Tensor, C6: torch.Tensor,
                              w3: torch.Tensor, B: torch.Tensor,
                              D: torch.Tensor,
                              Jr2: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Plain PyTorch ``ye = Jr2^T (w3 C6 (Jr2 u))``, as lpfem's fused mode
    with the compact metric (``_apply_G6_affine``)."""
    Q = B.shape[0] ** 3
    Jr2 = grad_interp(B, D) if Jr2 is None else Jr2
    g = u @ Jr2.T                                       # [ne, 3Q]
    gx, gy, gz = g[:, :Q], g[:, Q:2 * Q], g[:, 2 * Q:]
    cx, cxy, cxz, cy, cyz, cz = (C6[:, i:i + 1] for i in range(6))
    h = torch.cat([(cx * gx + cxy * gy + cxz * gz) * w3,
                   (cxy * gx + cy * gy + cyz * gz) * w3,
                   (cxz * gx + cyz * gy + cz * gz) * w3], dim=1)
    return h @ Jr2                                      # [ne, L]


def check_tables(name: str, x: torch.Tensor, tables) -> tuple[int, int]:
    """Validate the dtype of ``x`` and the tables an element kernel takes
    beside it (``(name, tensor, shape or None)``: contiguous, of the dtype
    and on the device of ``x``; the first two are B and D); returns
    (p+1, q)."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, got {x.dtype}")
    (_, B, _), (_, D, _) = tables[:2]
    if B.dim() != 2 or D.shape != B.shape:
        raise ValueError(f"shapes B {tuple(B.shape)}, D {tuple(D.shape)} do "
                         "not fit")
    for tname, t, shape in tables:
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{tname} must match the input in dtype and "
                             "device")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{tname} of shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
    q, p1 = B.shape
    if not (2 <= p1 <= _MAX_P1 and 1 <= q <= _MAX_P1):
        raise ValueError(f"p+1 = {p1}, q = {q}: the kernel takes 2 <= p+1 "
                         f"<= {_MAX_P1} and q <= {_MAX_P1}")
    return p1, q


def _check(name: str, u, metric, B, D, extra=()) -> tuple[int, int, int]:
    """Validate what an element kernel takes; returns (ne, p+1, q)."""
    if u.dim() != 2 or not u.is_contiguous():
        raise ValueError("u must be a contiguous 2-D tensor")
    ne = u.shape[0]
    p1, q = check_tables(name, u, [("B", B, None), ("D", D, None),
                                   ("the metric", metric, None), *extra])
    if u.shape != (ne, p1 ** 3):
        raise ValueError(f"shapes u {tuple(u.shape)}, B {tuple(B.shape)}, "
                         f"D {tuple(D.shape)} do not fit")
    return ne, p1, q


@functools.lru_cache(maxsize=None)
def _entry(name: str, dtype: torch.dtype, n_ptr: int):
    """The library's C entry ``name`` for ``dtype`` (built at first use):
    ``n_ptr`` pointers, (ne, p+1, q), the stream."""
    from ._build import load_library
    lib = load_library("pa_apply")
    fn = getattr(lib, f"{name}_{'f32' if dtype == torch.float32 else 'f64'}")
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, u: torch.Tensor, tables, dims) -> torch.Tensor:
    """Run entry ``name`` on ``u`` and ``tables``; returns ye."""
    fn = _entry(name, u.dtype, len(tables) + 2)
    with torch.cuda.device(u.device):
        ye = torch.empty_like(u)
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = fn(u.data_ptr(), *(t.data_ptr() for t in tables),
                ye.data_ptr(), *dims, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return ye


def pa_apply_element(u: torch.Tensor, G6q: torch.Tensor, B: torch.Tensor,
                     D: torch.Tensor) -> torch.Tensor:
    """``ye [ne, (p+1)^3]`` with the full metric: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    global LAUNCHES
    if u.device.type == "cpu":
        return pa_apply_element_reference(u, G6q, B, D)
    if u.device.type != "cuda":
        raise ValueError(f"pa_apply_element: unsupported device {u.device}")
    ne, p1, q = _check("pa_apply_element", u, G6q, B, D)
    if G6q.shape != (ne, 6 * q ** 3):
        raise ValueError(f"G6q of shape {tuple(G6q.shape)}, expected "
                         f"{(ne, 6 * q ** 3)}")
    if G6q.numel() >= 2 ** 31:
        raise ValueError("too many elements for the kernel's int sizes")
    ye = _launch("pa_apply_element", u, (G6q, B, D), (ne, p1, q))
    LAUNCHES += 1
    LAUNCHES_BY_P[p1 - 1] = LAUNCHES_BY_P.get(p1 - 1, 0) + 1
    return ye


def pa_apply_affine(u: torch.Tensor, C6: torch.Tensor, w3: torch.Tensor,
                    B: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """``ye [ne, (p+1)^3]`` with the affine metric ``w3[k] C6[e]``: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    global LAUNCHES_AFFINE
    if u.device.type == "cpu":
        return pa_apply_affine_reference(u, C6, w3, B, D)
    if u.device.type != "cuda":
        raise ValueError(f"pa_apply_affine: unsupported device {u.device}")
    q3 = B.shape[0] ** 3 if B.dim() == 2 else 0
    ne, p1, q = _check("pa_apply_affine", u, C6, B, D,
                       extra=[("w3", w3, (q3,))])
    if C6.shape != (ne, 6):
        raise ValueError(f"C6 of shape {tuple(C6.shape)}, expected "
                         f"{(ne, 6)}")
    if u.numel() >= 2 ** 31:
        raise ValueError("too many elements for the kernel's int sizes")
    ye = _launch("pa_apply_affine", u, (C6, w3, B, D), (ne, p1, q))
    LAUNCHES_AFFINE += 1
    LAUNCHES_AFFINE_BY_P[p1 - 1] = LAUNCHES_AFFINE_BY_P.get(p1 - 1, 0) + 1
    return ye
