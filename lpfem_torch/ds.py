"""Double-single (two-float32) arithmetic and the double-single Kronecker apply.

Counterpart of ``lpfem.ds``. A double-single (DS) value is a pair of float32
tensors ``(hi, lo)`` with ``value = hi + lo`` and ``|lo| <= ulp(hi)/2``: about
2^-48 relative, without any float64. The mixed solve's outer loop with
``hi_apply="ds"`` (``solvers.pcg_ir_ds``) needs three DS vector operations,
``r = b - A x`` (:func:`ds_sub`), ``x += e`` (:func:`ds_add_f32`) and a norm
of ``r.hi`` (:func:`ds_dot_hi`), and the DS operator :class:`SeparableDS`.

Every primitive is a chain of separate eager float32 operations, as lpfem's:
Knuth's ``two_sum``, Dekker's ``fast_two_sum``, Veltkamp's ``split`` and
Dekker's ``two_prod_presplit``. They are exact only if no two of those
operations are fused into one with a single rounding (a multiply-add).
Eager PyTorch runs each operation as its own kernel and never fuses across
them, so lpfem's ``_opaque`` (an ``optimization_barrier`` against XLA's
rewriter) has no counterpart here. For the same reason nothing in this
module may use ``addcmul``, ``addcdiv``, an ``alpha=`` other than 1, or run
under ``torch.compile``: each would contract a product into a sum and demote
the stream to float32 accuracy (the failure ``lpfem/kernels/sep_apply_ds.py:
39-53`` records for XLA:CPU). ``a - b`` is ``a + (-1) b``, exact as it is.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .kernels.sep_apply import _shifts

__all__ = ["DS", "ds_from_f64", "ds_from_f32", "ds_to_f64", "two_sum",
           "fast_two_sum", "split", "two_prod_presplit", "ds_norm", "ds_add",
           "ds_add_f32", "ds_neg", "ds_sub", "ds_where", "ds_dot_hi",
           "SeparableDS"]

_SPLIT = 4097.0          # 2^12 + 1 (Veltkamp, float32)


class DS(NamedTuple):
    """A double-single value or tensor: ``value = hi + lo`` (both float32).
    A tuple, so that the RK4 guard checks both tensors."""
    hi: torch.Tensor
    lo: torch.Tensor


def ds_from_f64(x: torch.Tensor) -> DS:
    """Split a float64 tensor into a DS pair (hi = round(x), lo = round of
    the remainder; the pair keeps ~49 of x's 53 bits)."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(x.dtype)).to(torch.float32)
    return DS(hi, lo)


def ds_from_f32(x: torch.Tensor) -> DS:
    return DS(x, torch.zeros_like(x))


def ds_to_f64(d: DS) -> torch.Tensor:
    return d.hi.to(torch.float64) + d.lo.to(torch.float64)


def two_sum(a, b):
    """Knuth's exact addition: a + b = s + e with s = fl(a + b); no
    precondition on the magnitudes."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Dekker's exact addition; requires |a| >= |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Veltkamp's split: a = h + l, each with at most 12 significant bits,
    so that products of split halves are exact in float32."""
    c = _SPLIT * a
    h = c - (c - a)
    return h, a - h


def two_prod_presplit(a, b, ah, al, bh, bl):
    """Dekker's product: a * b = p + e exactly, with (ah, al) = split(a) and
    (bh, bl) = split(b) given by the caller (hoisted out of loops)."""
    p = a * b
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def ds_norm(hi, lo) -> DS:
    """Renormalise a pair so that |lo| <= ulp(hi)/2."""
    return DS(*fast_two_sum(hi, lo))


def ds_add_f32(x: DS, e: torch.Tensor) -> DS:
    """x + e with e a float32 tensor (the refinement update)."""
    s, err = two_sum(x.hi, e)
    return ds_norm(s, x.lo + err)


def ds_add(x: DS, y: DS) -> DS:
    """DS + DS as the separable apply sums its terms (lpfem's
    ``SeparableDS._ds_add``): the hi parts exactly, then both lo parts."""
    s, e = two_sum(x.hi, y.hi)
    return ds_norm(s, e + x.lo + y.lo)


def ds_neg(x: DS) -> DS:
    return DS(-x.hi, -x.lo)


def ds_sub(x: DS, y: DS) -> DS:
    """Accurate DS subtraction (the residual ``b - A x``)."""
    s, e = two_sum(x.hi, -y.hi)
    t, f = two_sum(x.lo, -y.lo)
    s, e = fast_two_sum(s, e + t)
    return ds_norm(s, e + f)


def ds_where(c: torch.Tensor, x: DS, y: DS) -> DS:
    return DS(torch.where(c, x.hi, y.hi), torch.where(c, x.lo, y.lo))


def ds_dot_hi(x: DS, y: DS) -> torch.Tensor:
    """float32 dot of the hi parts: only convergence tests read it, whose
    thresholds span 16 orders of magnitude."""
    return torch.dot(x.hi, y.hi)


class SeparableDS:
    """DS twin of :class:`~lpfem_torch.operators.SeparableLattice`
    (``lpfem.ds.SeparableDS``): the operator's float64 1D bands
    (``sep.bands64``) as DS pairs on its device, which carry the float64
    operator to ~2^-48, and every banded contraction in compensated float32
    (exact products, exact sums with the error in the lo stream; only the
    ``c.lo * u.lo`` term, ~2^-48 relative, is dropped).

    ``apply`` / ``constrained_apply_top`` take and return flat DS pairs. On
    CUDA tensors they launch the kernel ``kernels.sep_apply_ds`` (B4); on CPU
    tensors they run :meth:`apply3`, lpfem's XLA form with its sums in the
    same order.
    """

    def __init__(self, sep):
        self.p = sep.p
        self.dof_dims = sep.dof_dims
        self.periodic = sep.periodic
        dev = sep.device
        self.bands = tuple(ds_from_f64(torch.tensor(b, device=dev))
                           for b in sep.bands64)      # Kx, Mx, Ky, My, Kz, Mz

    def _axis(self, u: DS, c: DS, axis: int) -> DS:
        """Compensated banded contraction y_i = sum_s c[p+s, i] u_{i+s}
        along ``axis`` of the [Dz, Dy, Dx] view, s = -p..p in order."""
        p = self.p
        shape = [1, 1, 1]
        shape[axis] = u.hi.shape[axis]
        uhh, uhl = split(u.hi)                 # splits commute with shifts
        chh, chl = split(c.hi)
        per = self.periodic[2 - axis]
        su, suh, sul, slo = (_shifts(v, axis, p, per)
                             for v in (u.hi, uhh, uhl, u.lo))
        acc_h = acc_l = None
        for k in range(2 * p + 1):
            ch = c.hi[k].reshape(shape)
            pr, err = two_prod_presplit(ch, su[k], chh[k].reshape(shape),
                                        chl[k].reshape(shape), suh[k], sul[k])
            err = err + ch * slo[k] + c.lo[k].reshape(shape) * su[k]
            if acc_h is None:
                acc_h, acc_l = pr, err
            else:
                acc_h, t = two_sum(acc_h, pr)
                acc_l = acc_l + (t + err)
        return ds_norm(acc_h, acc_l)

    def apply3(self, u: DS) -> DS:
        """A u on the [Dz, Dy, Dx] view, every stage in DS."""
        Kx, Mx, Ky, My, Kz, Mz = self.bands
        t1 = self._axis(u, Kx, 2)
        t2 = self._axis(u, Mx, 2)
        a = ds_add(self._axis(t1, My, 1), self._axis(t2, Ky, 1))
        b = self._axis(t2, My, 1)
        return ds_add(self._axis(a, Mz, 0), self._axis(b, Kz, 0))

    def _apply(self, x: DS, ess_top: bool) -> DS:
        Dx, Dy, Dz = self.dof_dims
        xh, xl = x.hi.view(Dz, Dy, Dx), x.lo.view(Dz, Dy, Dx)
        if x.hi.device.type != "cpu":
            # the kernel module builds on this one's primitives
            from .kernels.sep_apply_ds import sep_apply_ds
            y = sep_apply_ds(xh, xl, self.bands, self.periodic, ess_top)
        elif ess_top:
            u = DS(xh.clone(), xl.clone())
            u.hi[-1] = 0.0
            u.lo[-1] = 0.0
            y = self.apply3(u)
            y.hi[-1] = xh[-1]
            y.lo[-1] = xl[-1]
        else:
            y = self.apply3(DS(xh, xl))
        return DS(y.hi.reshape(-1), y.lo.reshape(-1))

    def apply(self, x: DS) -> DS:
        """A x on flat DS vectors."""
        return self._apply(x, False)

    def constrained_apply_top(self, x: DS) -> DS:
        """Identity rows and columns on the top z-plane (the free-surface
        essential set), the DS twin of
        ``SeparableLattice.constrained_apply_top``."""
        return self._apply(x, True)
