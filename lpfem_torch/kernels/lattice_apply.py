"""Fused element-form Laplace apply on an affine structured lattice: CUDA
kernel wrapper and its plain version.

``y = A x`` with ``A = sum_e P_e^T Jr2^T diag(w3) C6[e] Jr2 P_e`` on the dof
lattice ``ix + Dx*(iy + Dy*iz)`` of ``dims = (nex, ney, nez)`` order-p
elements (``Dx = p*nex`` on a periodic x axis, else ``p*nex + 1``; y and z
are never periodic): every element's (p+1)^3 window of ``x``, the reference
gradient at the Gauss points, the affine metric ``w3[k] C6[e]`` (``C6
[ne, 6]`` lattice-major, ``w3 [Q]``), the transposed gradient, and the sum
over the elements that share a dof. ``ess_top`` makes the top z-plane an
essential boundary: read as zero, and the output's top plane is the input's
(``lpfem/operators.py:835-837``).

- :func:`lattice_affine_apply` runs ``csrc/lattice_apply.cu`` (the port of
  the TPU kernel ``lpfem/kernels/lattice_apply.py::lattice_affine_apply``,
  B2: two launches, the elements into an E-vector scratch and the fold) on
  CUDA tensors and counts each call in ``LAUNCHES`` and, by order, in
  ``LAUNCHES_BY_P``. It takes the plain version only because its input lies
  on the CPU; on a CUDA tensor it launches the kernel or raises.
- :func:`lattice_affine_apply_reference` is the plain PyTorch version: the
  index gather of every element's window, ``pa_apply_affine_reference``, and
  the fold with ``index_add_`` (the three steps the kernel fuses).
- :func:`fold_table` and :func:`lattice_affine_apply_mirror` mirror the
  kernel's fold in plain PyTorch: its closed-form map from a dof to the
  elements and local nodes that hold it, and its summation order (ascending
  element index), so the CPU tests check the arithmetic the fold launch
  does.
- Shard mode (the TPU kernel's ``shard_scal`` / ``p0`` mode, run on the
  sheared lattices' z-slab windows by ``lpfem_torch.shard``):
  :func:`lattice_affine_apply_shard` applies ``ndev`` stacked windows in the
  same two launches, each window with its metric rows (zero on a slab's
  padding layers) and its row of ``scal = (zt, own0)`` as
  ``kernels.sep_apply``'s shard mode: ``zt`` the Dirichlet plane or -1,
  ``own0`` whether plane 0 is the shard's own (else it reads the halo plane
  ``p0`` and its outputs go to ``yhalo``). It counts its calls in
  ``LAUNCHES_SHARD`` / ``LAUNCHES_SHARD_BY_P``;
  :func:`lattice_affine_apply_shard_reference` is its plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .pa_apply import check_tables, pa_apply_affine_reference

__all__ = ["lattice_elem_dofs", "lattice_affine_apply",
           "lattice_affine_apply_reference", "fold_table",
           "lattice_affine_apply_mirror", "lattice_affine_apply_shard",
           "lattice_affine_apply_shard_reference"]

LAUNCHES = 0          # calls of the kernel entry through lattice_affine_apply
LAUNCHES_BY_P: dict[int, int] = {}     # the same calls by element order p
LAUNCHES_SHARD = 0    # calls of the shard entry through ..._shard
LAUNCHES_SHARD_BY_P: dict[int, int] = {}

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_SHARD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])


def _dof_dims(p: int, dims, periodic) -> tuple[int, int, int]:
    if periodic[1] or periodic[2]:
        raise ValueError("only the x axis may be periodic")
    nex, ney, nez = dims
    return p * nex + (0 if periodic[0] else 1), p * ney + 1, p * nez + 1


@functools.lru_cache(maxsize=8)
def _elem_dofs(p: int, dims, periodic, device: str) -> torch.Tensor:
    Dx, Dy, _ = _dof_dims(p, dims, periodic)
    ar = torch.arange(p + 1)
    gx, gy, gz = (torch.arange(n)[:, None] * p + ar for n in dims)
    if periodic[0]:
        gx = gx % Dx
    ed = (gx[None, None, :, None, None, :]
          + Dx * (gy[None, :, None, None, :, None]
                  + Dy * gz[:, None, None, :, None, None]))
    return ed.reshape(-1, (p + 1) ** 3).to(device)


def lattice_elem_dofs(p: int, dims, periodic, device) -> torch.Tensor:
    """[ne, (p+1)^3] int64: the lattice dofs of every element, elements
    lattice-major, local nodes x fastest (the last few tables are kept)."""
    return _elem_dofs(p, tuple(int(n) for n in dims),
                      tuple(bool(a) for a in periodic), str(device))


def lattice_affine_apply_reference(x: torch.Tensor, C6: torch.Tensor,
                                   w3: torch.Tensor, B: torch.Tensor,
                                   D: torch.Tensor, dims, periodic,
                                   ess_top: bool = False) -> torch.Tensor:
    """Plain PyTorch ``A x``: gather, per-element apply, fold."""
    p = B.shape[1] - 1
    Dx, Dy, Dz = _dof_dims(p, dims, periodic)
    ed = lattice_elem_dofs(p, dims, periodic, x.device)
    u = x
    if ess_top:
        u = x.clone()
        u[-Dx * Dy:] = 0.0
    ye = pa_apply_affine_reference(u[ed], C6, w3, B, D)
    y = torch.zeros_like(x).index_add_(0, ed.reshape(-1), ye.reshape(-1))
    if ess_top:
        y[-Dx * Dy:] = x[-Dx * Dy:]
    return y


def _axis_elems(D: int, p: int, n: int, periodic: bool):
    """For every lattice index g < D along one axis, the (up to two)
    elements that hold it in ascending order and g's local index in each,
    as the fold kernel finds them: ``g % p != 0`` lies inside element
    ``g // p``; otherwise g is shared by elements ``k - 1`` (local p) and
    ``k`` (local 0), ``k = g // p``, where they exist, and on a periodic
    axis index 0 by elements 0 and n - 1 across the seam. Returns (e0, l0,
    e1, l1, has1), each [D]."""
    g = torch.arange(D)
    k, r = g // p, g % p
    inner = r != 0
    seam = (k == 0) & ~inner & periodic
    e0 = torch.where(inner, k, (k - 1).clamp(min=0))
    l0 = torch.where(inner, r, torch.where(k > 0, p, 0))
    has1 = ~inner & (((k > 0) & (k < n)) | seam)
    e1 = torch.where(seam, n - 1, k)
    l1 = torch.where(seam, p, 0)
    return e0, l0, e1, l1, has1


@functools.lru_cache(maxsize=8)
def _fold_table(p: int, dims, periodic, device: str) -> torch.Tensor:
    Dx, Dy, Dz = _dof_dims(p, dims, periodic)
    nex, ney, _ = dims
    p1 = p + 1
    L = p1 ** 3
    axes = [_axis_elems(D, p, n, per) for D, n, per in
            zip((Dx, Dy, Dz), dims, periodic)]

    def pick(a, k):                # the k-th holder of every index: e, l, ok
        e0, l0, e1, l1, has1 = a
        return ((e0, l0, torch.ones_like(has1)) if k == 0
                else (e1, l1, has1))

    cols = []
    for kz in (0, 1):              # the kernel's loop order: z, y, x
        ez, lz, vz = (t[:, None, None] for t in pick(axes[2], kz))
        for ky in (0, 1):
            ey, ly, vy = (t[None, :, None] for t in pick(axes[1], ky))
            for kx in (0, 1):
                ex, lx, vx = (t[None, None, :] for t in pick(axes[0], kx))
                idx = (((ez * ney + ey) * nex + ex) * L
                       + (lz * p1 + ly) * p1 + lx)
                cols.append(torch.where(vz & vy & vx, idx, -1).reshape(-1))
    return torch.stack(cols, dim=1).to(device)


def fold_table(p: int, dims, periodic, device) -> torch.Tensor:
    """[n_dofs, 8] int64: for every dof, the flat E-vector indices
    ``e * (p+1)^3 + local node`` of the element values the fold kernel adds,
    in its order (ascending element index); -1 where a dof has fewer than 8
    holders (the last few tables are kept)."""
    return _fold_table(p, tuple(int(n) for n in dims),
                       tuple(bool(a) for a in periodic), str(device))


def lattice_affine_apply_mirror(x: torch.Tensor, C6: torch.Tensor,
                                w3: torch.Tensor, B: torch.Tensor,
                                D: torch.Tensor, dims, periodic,
                                ess_top: bool = False) -> torch.Tensor:
    """Plain PyTorch ``A x`` in the kernel's two steps: every element's
    window (the top plane read as zero under ``ess_top``) through
    ``pa_apply_affine_reference`` into an E-vector, then the fold of
    :func:`fold_table` in its fixed order, the top plane from ``x``."""
    p = B.shape[1] - 1
    Dx, Dy, Dz = _dof_dims(p, dims, periodic)
    ed = lattice_elem_dofs(p, dims, periodic, x.device)
    u = x[ed]
    if ess_top:
        u = torch.where(ed >= Dx * Dy * (Dz - 1), 0.0, u)
    ye = pa_apply_affine_reference(u, C6, w3, B, D).reshape(-1)
    table = fold_table(p, dims, periodic, x.device)
    y = torch.zeros_like(x)
    for k in range(table.shape[1]):
        col = table[:, k]
        y = y + torch.where(col >= 0, ye[col.clamp(min=0)], 0.0)
    if ess_top:
        y[-Dx * Dy:] = x[-Dx * Dy:]
    return y


def _check(x, C6, w3, B, D, dims, periodic) -> tuple[int, int]:
    """Validate what the kernel takes; returns (p, q)."""
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous dof vector")
    ne = dims[0] * dims[1] * dims[2]
    q3 = B.shape[0] ** 3 if B.dim() == 2 else 0
    p1, q = check_tables("lattice_affine_apply", x,
                         [("B", B, None), ("D", D, None),
                          ("C6", C6, (ne, 6)), ("w3", w3, (q3,))])
    Dx, Dy, Dz = _dof_dims(p1 - 1, dims, periodic)
    if min(dims) < 1 or x.shape[0] != Dx * Dy * Dz:
        raise ValueError(f"x of {x.shape[0]} dofs, expected {Dx * Dy * Dz} "
                         f"for {tuple(dims)} elements of order {p1 - 1}")
    if periodic[0] and dims[0] < 2:
        raise ValueError("periodic x needs at least 2 elements (an element "
                         "would meet itself across the seam)")
    if ne * p1 ** 3 >= 2 ** 31:
        raise ValueError("lattice too large for the kernel's int sizes")
    return p1 - 1, q


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    """The library's C entry for ``dtype`` (built at first use)."""
    from ._build import load_library
    lib = load_library("lattice_apply")
    fn = (lib.lattice_affine_apply_f32 if dtype == torch.float32
          else lib.lattice_affine_apply_f64)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def lattice_affine_apply(x: torch.Tensor, C6: torch.Tensor, w3: torch.Tensor,
                         B: torch.Tensor, D: torch.Tensor, dims, periodic,
                         ess_top: bool = False) -> torch.Tensor:
    """``A x`` on the flat dof vector ``x``: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    global LAUNCHES
    if x.device.type == "cpu":
        return lattice_affine_apply_reference(x, C6, w3, B, D, dims,
                                              periodic, ess_top)
    if x.device.type != "cuda":
        raise ValueError(f"lattice_affine_apply: unsupported device "
                         f"{x.device}")
    p, q = _check(x, C6, w3, B, D, dims, periodic)
    fn = _entry(x.dtype)
    with torch.cuda.device(x.device):
        # the E-vector between the two launches (from the caching allocator)
        ye = torch.empty(C6.shape[0], (p + 1) ** 3, dtype=x.dtype,
                         device=x.device)
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), C6.data_ptr(), w3.data_ptr(), B.data_ptr(),
                D.data_ptr(), ye.data_ptr(), y.data_ptr(),
                *(int(n) for n in dims), p, q, int(bool(periodic[0])),
                int(bool(ess_top)), stream)
    if rc != 0:
        raise RuntimeError(f"lattice_affine_apply kernel launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES += 1
    LAUNCHES_BY_P[p] = LAUNCHES_BY_P.get(p, 0) + 1
    return y


def lattice_affine_apply_shard_reference(x: torch.Tensor, C6: torch.Tensor,
                                         w3: torch.Tensor, B: torch.Tensor,
                                         D: torch.Tensor, dims, periodic,
                                         scal, p0: torch.Tensor):
    """Plain PyTorch shard mode, one window at a time: ``x [ndev, W]``
    (the window of ``dims = (nex, ney, nez)`` elements in the first lanes
    of each row), ``C6 [ndev * ne, 6]``, ``scal [ndev, 2]`` rows ``(zt,
    own0)``, ``p0 [ndev, >= Dx*Dy]``. Returns ``(y [ndev, W], yhalo [ndev,
    Dx*Dy])``, lanes of ``y`` past the window 0."""
    from .sep_apply import _shard_rows
    p = B.shape[1] - 1
    Dx, Dy, Dz = _dof_dims(p, dims, periodic)
    plane, n = Dx * Dy, Dx * Dy * Dz
    ed = lattice_elem_dofs(p, dims, periodic, x.device)
    C6 = C6.reshape(x.shape[0], ed.shape[0], 6)
    y = torch.zeros_like(x)
    yhalo = x.new_zeros(x.shape[0], plane)
    for d, (zt, own0) in enumerate(_shard_rows(scal)):
        u = x[d, :n].clone()
        if not own0:
            u[:plane] = p0[d, :plane]
        if zt >= 0:
            u[zt * plane:(zt + 1) * plane] = 0.0
        ye = pa_apply_affine_reference(u[ed], C6[d], w3, B, D)
        yd = torch.zeros_like(u).index_add_(0, ed.reshape(-1), ye.reshape(-1))
        if zt >= 0:
            yd[zt * plane:(zt + 1) * plane] = x[d, zt * plane:(zt + 1) * plane]
        if not own0:
            yhalo[d] = yd[:plane]
            yd[:plane] = 0.0
        y[d, :n] = yd
    return y, yhalo


@functools.lru_cache(maxsize=None)
def _shard_entry(dtype: torch.dtype):
    """The library's shard-mode C entry for ``dtype``."""
    from ._build import load_library
    lib = load_library("lattice_apply")
    fn = (lib.lattice_affine_apply_shard_f32 if dtype == torch.float32
          else lib.lattice_affine_apply_shard_f64)
    fn.argtypes = _SHARD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def lattice_affine_apply_shard(x: torch.Tensor, C6: torch.Tensor,
                               w3: torch.Tensor, B: torch.Tensor,
                               D: torch.Tensor, dims, periodic,
                               scal: torch.Tensor, p0: torch.Tensor):
    """Shard mode (the module docstring) on ``ndev`` stacked windows, the
    arguments of :func:`lattice_affine_apply_shard_reference` (``scal``
    as ``kernels.sep_apply.check_scal`` passes it): the two launches for a
    CUDA tensor, the plain version for a CPU tensor."""
    global LAUNCHES_SHARD
    if x.device.type == "cpu":
        return lattice_affine_apply_shard_reference(x, C6, w3, B, D, dims,
                                                    periodic, scal, p0)
    if x.device.type != "cuda":
        raise ValueError(f"lattice_affine_apply_shard: unsupported device "
                         f"{x.device}")
    ndev = x.shape[0]
    ne = dims[0] * dims[1] * dims[2]
    p1 = B.shape[1]
    Dx, Dy, Dz = _dof_dims(p1 - 1, dims, periodic)
    if x.dim() != 2 or not x.is_contiguous() or x.shape[1] < Dx * Dy * Dz:
        raise ValueError("x must be a contiguous [ndev, >= n] tensor")
    p, q = _check(x.new_empty(Dx * Dy * Dz), C6.reshape(ndev, ne, 6)[0],
                  w3, B, D, dims, periodic)
    if not C6.is_contiguous() or C6.numel() != ndev * ne * 6:
        raise ValueError(f"C6 must be contiguous [ndev * {ne}, 6]")
    if (p0.dim() != 2 or p0.shape[0] != ndev or p0.shape[1] < Dx * Dy
            or p0.stride(1) != 1 or p0.dtype != x.dtype
            or p0.device != x.device):
        raise ValueError("p0 must be [ndev, >= Dx*Dy] rows in x's dtype")
    if (scal.shape != (ndev, 2) or scal.dtype != torch.int32
            or not scal.is_contiguous() or scal.device != x.device):
        raise ValueError("scal must be a contiguous int32 [ndev, 2] tensor "
                         "on x's device")
    if ndev * ne * p1 ** 3 >= 2 ** 31:
        raise ValueError("windows too large for the kernel's int sizes")
    fn = _shard_entry(x.dtype)
    with torch.cuda.device(x.device):
        ye = torch.empty(ndev * ne, p1 ** 3, dtype=x.dtype, device=x.device)
        y = torch.empty_like(x)
        yhalo = torch.empty(ndev, Dx * Dy, dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), p0.data_ptr(), C6.data_ptr(), w3.data_ptr(),
                B.data_ptr(), D.data_ptr(), ye.data_ptr(), y.data_ptr(),
                yhalo.data_ptr(), *(int(n) for n in dims), p, q,
                int(bool(periodic[0])), scal.data_ptr(), ndev, x.shape[1],
                y.shape[1], p0.stride(0), stream)
    if rc != 0:
        raise RuntimeError(f"lattice_affine_apply_shard kernel launch "
                           f"failed: CUDA error {rc}")
    LAUNCHES_SHARD += 1
    LAUNCHES_SHARD_BY_P[p] = LAUNCHES_SHARD_BY_P.get(p, 0) + 1
    return y, yhalo
