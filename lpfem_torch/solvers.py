"""Preconditioned CG and mixed-precision iterative refinement.

Counterpart of ``lpfem.solvers.pcg`` / ``pcg_ir`` / ``pcg_ir_ds`` /
``pcg_refined`` with every
rule kept: MFEM's threshold ``r.z <= max(rz0 * rtol_sq, atol_sq)``, the
zero-denominator guards on ``alpha`` and ``beta``, the ``grow_limit``
breakdown guard, and the outer true-residual loop (float64 or double-single)
with ``max_outer`` / ``inner_rtol_sq``.

The reference's ``lax.while_loop`` becomes a host loop: the iteration's
arithmetic stays on the device, and the exit test reads one boolean back,
so every test is one host-device synchronisation. ``CGResult.syncs`` counts
them, on the lines that count them in the record of
:mod:`lpfem_torch.profiling` by site (``solvers.exit_test``,
``solvers.ir_pass``). (CUDA graphs that remove them are later work.)

Spans (:func:`~lpfem_torch.profiling.span`): ``solvers.cg_iteration`` (one
iteration's body and the exit test that ends it), ``solvers.apply`` (the
CG's own operator applies) and ``solvers.ir_pass`` (one outer pass: its
test, its inner solve and its high-precision residual); the detail
``solvers.exit_test`` (:func:`~lpfem_torch.profiling.detail`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .ds import DS, ds_add_f32, ds_sub
from .profiling import detail, span, sync

__all__ = ["CGResult", "pcg", "pcg_ir", "pcg_ir_ds", "pcg_refined",
           "jacobi_preconditioner"]


class CGResult(NamedTuple):
    x: torch.Tensor | DS     # a DS pair from pcg_ir_ds
    iters: int
    rz: torch.Tensor     # final preconditioned residual measure (r.z)
    rz0: torch.Tensor
    syncs: int           # host reads of the exit test


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a, b)


def pcg(apply_fn: Callable, b: torch.Tensor, x0: torch.Tensor | None = None,
        precond_fn: Callable = lambda r: r,
        rtol_sq: float = 1e-24, atol_sq: float = 0.0,
        max_iter: int = 1000,
        grow_limit: float | None = 1e6,
        dot_fn: Callable = _dot) -> CGResult:
    """Preconditioned conjugate gradients (Hestenes-Stiefel, MFEM update
    order). ``x0=None`` starts from zero without an apply (r = b).
    ``dot_fn``: the inner product (the sharded solver passes its sum of
    per-shard dots, lpfem's ``dot_fn``).

    ``grow_limit``: exit once r.z exceeds ``grow_limit`` times its running
    minimum — a stalled finite-precision recurrence that breaks down grows
    without bound while staying finite. ``None`` disables. A NaN r.z fails
    the ``rz > threshold`` test and exits too; callers see it in ``rz``.
    """
    if x0 is None:
        x = torch.zeros_like(b)
        r = b.clone()
    else:
        x = x0
        with span("solvers.apply"):
            r = b - apply_fn(x0)
    z = precond_fn(r)
    d = z
    rz = dot_fn(r, z)
    rz0 = rz
    threshold = torch.clamp_min(rz0 * rtol_sq, atol_sq)
    rz_min = rz
    it = 0
    syncs = 0
    go = it < max_iter
    if go:
        syncs += sync("solvers.exit_test")
        go = _exit_test(rz, threshold, rz_min, grow_limit)
    while go:
        with span("solvers.cg_iteration"):
            with span("solvers.apply"):
                Ad = apply_fn(d)
            dAd = dot_fn(d, Ad)
            # zero-denominator guards: hold the iterate instead of making
            # NaNs
            pos = dAd > 0
            alpha = torch.where(pos, rz / torch.where(pos, dAd, 1.0), 0.0)
            x = x + alpha * d
            r = r - alpha * Ad
            z = precond_fn(r)
            rz_new = dot_fn(r, z)
            pos = rz > 0
            beta = torch.where(pos, rz_new / torch.where(pos, rz, 1.0), 0.0)
            d = z + beta * d
            rz = rz_new
            rz_min = torch.minimum(rz_min, rz_new)
            it += 1
            go = it < max_iter
            if go:
                syncs += sync("solvers.exit_test")
                go = _exit_test(rz, threshold, rz_min, grow_limit)
    return CGResult(x=x, iters=it, rz=rz, rz0=rz0, syncs=syncs)


def _exit_test(rz, threshold, rz_min, grow_limit) -> bool:
    """Whether the CG goes on: one host read of the device."""
    with detail("solvers.exit_test"):
        go = rz > threshold
        if grow_limit is not None:
            go = go & (rz < grow_limit * rz_min)
        return bool(go)


def jacobi_preconditioner(diag: torch.Tensor) -> Callable:
    """Diagonal (Jacobi) preconditioner, ``r -> r / diag`` (MFEM's
    ``OperatorJacobiSmoother`` over the assembled PA diagonal; the caller
    sets the essential dofs' entries to 1, the identity there)."""
    inv = 1.0 / diag
    return lambda r: r * inv


def pcg_ir(apply_hi: Callable, apply_lo: Callable, b: torch.Tensor,
           x0: torch.Tensor, precond_lo: Callable = lambda r: r,
           rtol_sq: float = 1e-24, atol_sq: float = 0.0,
           max_outer: int = 4, inner_rtol_sq: float = 1e-8,
           inner_max_iter: int = 1000,
           lo_dtype: torch.dtype = torch.float32,
           dot_fn: Callable = _dot) -> CGResult:
    """Mixed-precision CG by iterative refinement: an outer loop on the
    high-precision true residual ``||b - A x||^2`` around an inner
    ``lo_dtype`` :func:`pcg` solve of the error equation. ``b``/``x0`` set
    the high precision. ``iters`` counts the inner iterations, ``rz``/``rz0``
    are the outer ``||r||^2``. ``inner_rtol_sq`` must stay well above the f32
    CG floor (~1e-10 on r.z): the outer passes supply the depth. ``dot_fn``
    as :func:`pcg`'s, for both loops.
    """
    x = x0.to(b.dtype)
    r = b - apply_hi(x)
    rr0 = dot_fn(r, r)
    threshold = torch.clamp_min(rr0 * rtol_sq, atol_sq)
    rr = rr0
    it = 0
    syncs = 0
    for _ in range(max_outer):
        with span("solvers.ir_pass"):
            syncs += sync("solvers.ir_pass")
            if not bool(rr > threshold):
                break
            inner = pcg(apply_lo, r.to(lo_dtype), None,
                        precond_fn=precond_lo, rtol_sq=inner_rtol_sq,
                        max_iter=inner_max_iter, dot_fn=dot_fn)
            x = x + inner.x.to(b.dtype)
            r = b - apply_hi(x)
            rr = dot_fn(r, r)
            it += inner.iters
            syncs += inner.syncs
    return CGResult(x=x, iters=it, rz=rr, rz0=rr0, syncs=syncs)


def pcg_ir_ds(apply_ds: Callable, apply_lo: Callable, b: DS, x0: DS,
              precond_lo: Callable = lambda r: r,
              rtol_sq: float = 1e-24, atol_sq: float = 0.0,
              max_outer: int = 4, inner_rtol_sq: float = 1e-8,
              inner_max_iter: int = 1000) -> CGResult:
    """:func:`pcg_ir` with the whole outer loop in double-single arithmetic
    (``lpfem/solvers.py:158-210``): ``b``/``x0`` are
    :class:`~lpfem_torch.ds.DS` pairs, ``apply_ds`` maps DS to DS
    (``SeparableDS``), the residual ``r = b - A x`` and the update
    ``x += e`` are error-free float32 transforms, and the inner float32 CG
    solves for ``r.hi``. Convergence is tested on the float32
    ``||r.hi||^2`` against ``max(rr0 * f32(rtol_sq), f32(atol_sq))``, in
    float32 as lpfem does. ``x`` comes back as a DS pair; ``rz``/``rz0`` are
    the outer float32 ``||r.hi||^2``."""
    r = ds_sub(b, apply_ds(x0))
    rr0 = _dot(r.hi, r.hi)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=rr0.device)

    threshold = torch.maximum(rr0 * f32(rtol_sq), f32(atol_sq))
    x, rr = x0, rr0
    it = 0
    syncs = 0
    for _ in range(max_outer):
        with span("solvers.ir_pass"):
            syncs += sync("solvers.ir_pass")
            if not bool(rr > threshold):
                break
            inner = pcg(apply_lo, r.hi, None, precond_fn=precond_lo,
                        rtol_sq=inner_rtol_sq, max_iter=inner_max_iter)
            x = ds_add_f32(x, inner.x)
            r = ds_sub(b, apply_ds(x))
            rr = _dot(r.hi, r.hi)
            it += inner.iters
            syncs += inner.syncs
    return CGResult(x=x, iters=it, rz=rr, rz0=rr0, syncs=syncs)


def pcg_refined(apply_hi: Callable, apply_lo: Callable, b: torch.Tensor,
                x0: torch.Tensor, precond_lo: Callable = lambda r: r,
                rtol_sq: float = 1e-24, atol_sq: float = 0.0,
                max_outer: int = 6, inner_rtol_sq: float = 1e-8,
                inner_max_iter: int = 1000,
                lo_dtype: torch.dtype = torch.float32) -> CGResult:
    """Mixed-precision CG by iterative refinement for one stationary solve
    (``lpfem/solvers.py:213-254``, the stationary drivers' form): lpfem's
    defaults on :func:`pcg_ir`'s loop, which runs the same arithmetic. (On a
    NaN residual lpfem's host loop runs on to ``max_outer``; here the loop
    ends, as in the time loop's solve.)"""
    return pcg_ir(apply_hi, apply_lo, b, x0, precond_lo=precond_lo,
                  rtol_sq=rtol_sq, atol_sq=atol_sq, max_outer=max_outer,
                  inner_rtol_sq=inner_rtol_sq,
                  inner_max_iter=inner_max_iter, lo_dtype=lo_dtype)
