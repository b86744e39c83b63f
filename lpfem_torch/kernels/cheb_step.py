"""One step of the Chebyshev-Jacobi smoother in one launch: CUDA kernel
wrapper and its plain version.

The vector update of :class:`lpfem_torch.multigrid.ChebyshevSmoother`
around the level's apply (which the caller runs and passes in as ``Az``):

- :func:`cheb_first`: ``d = inv_diag * res / theta`` with ``res = r - Az0``
  from a start vector ``z0`` (``res = r`` from zero), then ``z = z0 + d``
  (``0 + d`` from zero);
- :func:`cheb_step`: ``d = c1 * d + c2 * (inv_diag * (r - Az))``, then
  ``z = z + d``.

Both write ``d`` and ``z``, buffers of the caller's, in place. On CUDA
tensors they launch ``csrc/cheb_step.cu`` (one launch a step, every
operand read once and ``d`` and ``z`` written once, bit for bit the eager
expressions on the card), counted in ``LAUNCHES`` and by dtype name in
``LAUNCHES_BY_DTYPE``. On CPU tensors they evaluate the eager expressions
(:func:`cheb_first_reference`, :func:`cheb_step_reference`: plain
PyTorch on any device, returning new tensors) and copy the results into
``d`` and ``z``. Every operand is a contiguous float32 or float64 tensor
of ``r``'s shape, dtype and device; anything else raises, on either
device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["LAUNCHES", "LAUNCHES_BY_DTYPE", "cheb_first", "cheb_step",
           "cheb_first_reference", "cheb_step_reference"]

LAUNCHES = 0                          # kernel launches (never the plain path)
LAUNCHES_BY_DTYPE: dict[str, int] = {}

_DTYPES = (torch.float32, torch.float64)


def _check(name: str, r: torch.Tensor, **operands) -> None:
    """Raise unless every operand is a contiguous tensor of ``r``'s shape,
    dtype and device, and ``r`` float32 or float64."""
    if r.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or float64, got {r.dtype}")
    for key, t in (("r", r), *operands.items()):
        if t.shape != r.shape:
            raise ValueError(f"{name}: {key} of shape {tuple(t.shape)}, "
                             f"expected {tuple(r.shape)}")
        if t.dtype != r.dtype or t.device != r.device:
            raise ValueError(f"{name}: {key} must match r in dtype and "
                             f"device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


@functools.lru_cache(maxsize=None)
def _entry(name: str, dtype: torch.dtype):
    """The library's C entry ``cheb_<name>`` for ``dtype`` (built at first
    use)."""
    from ._build import load_library
    lib = load_library("cheb_step")
    fn = getattr(lib, f"cheb_{name}_"
                      f"{'f32' if dtype == torch.float32 else 'f64'}")
    n_ptr = 6 if name == "first" else 5
    fn.argtypes = ([ctypes.c_void_p] * n_ptr
                   + [ctypes.c_double] * (1 if name == "first" else 2)
                   + [ctypes.c_int64, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, r: torch.Tensor, ptrs, scalars) -> None:
    global LAUNCHES
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = _entry(name, r.dtype)(*ptrs, *scalars, r.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"cheb_{name} kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    key = str(r.dtype).removeprefix("torch.")
    LAUNCHES_BY_DTYPE[key] = LAUNCHES_BY_DTYPE.get(key, 0) + 1


def _device(name: str, r: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU tensor."""
    if r.device.type == "cuda":
        return True
    if r.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {r.device}")
    return False


def cheb_first(r: torch.Tensor, inv_diag: torch.Tensor, theta: float,
               d: torch.Tensor, z: torch.Tensor,
               z0: torch.Tensor | None = None,
               Az0: torch.Tensor | None = None) -> None:
    """The smoother's first step into ``d`` and ``z``: from zero, or from
    ``z0`` with its apply ``Az0`` (both or neither)."""
    if (z0 is None) != (Az0 is None):
        raise ValueError("cheb_first: give z0 and Az0 together")
    start = {} if z0 is None else {"z0": z0, "Az0": Az0}
    _check("cheb_first", r, inv_diag=inv_diag, d=d, z=z, **start)
    if _device("cheb_first", r):
        ptrs = (r.data_ptr(), None if z0 is None else Az0.data_ptr(),
                inv_diag.data_ptr(), None if z0 is None else z0.data_ptr(),
                d.data_ptr(), z.data_ptr())
        _launch("first", r, ptrs, (theta,))
        return
    d_new, z_new = cheb_first_reference(r, inv_diag, theta, z0, Az0)
    d.copy_(d_new)
    z.copy_(z_new)


def cheb_step(r: torch.Tensor, Az: torch.Tensor, inv_diag: torch.Tensor,
              d: torch.Tensor, z: torch.Tensor, c1: float, c2: float) -> None:
    """A recurrence step, ``d`` and ``z`` in place (``Az``: the apply of
    ``z`` before the step)."""
    _check("cheb_step", r, Az=Az, inv_diag=inv_diag, d=d, z=z)
    if _device("cheb_step", r):
        _launch("step", r, (r.data_ptr(), Az.data_ptr(), inv_diag.data_ptr(),
                            d.data_ptr(), z.data_ptr()), (c1, c2))
        return
    d_new, z_new = cheb_step_reference(r, Az, inv_diag, d, z, c1, c2)
    d.copy_(d_new)
    z.copy_(z_new)


def cheb_first_reference(r: torch.Tensor, inv_diag: torch.Tensor,
                         theta: float, z0: torch.Tensor | None = None,
                         Az0: torch.Tensor | None = None):
    """(d, z) of the first step, the eager expressions."""
    res = r if z0 is None else r - Az0
    d = inv_diag * res / theta
    return d, (torch.zeros_like(r) if z0 is None else z0) + d


def cheb_step_reference(r: torch.Tensor, Az: torch.Tensor,
                        inv_diag: torch.Tensor, d: torch.Tensor,
                        z: torch.Tensor, c1: float, c2: float):
    """(d, z) after a recurrence step, the eager expressions."""
    d = c1 * d + c2 * (inv_diag * (r - Az))
    return d, z + d
