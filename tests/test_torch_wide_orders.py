"""The element kernels B2, B3a and B3b at p = 8, 9, 10 (the column body's
second general instantiation, ``csrc/affine_body.cuh``) in plain PyTorch,
against lpfem on the CPU.

- B3b: :func:`pa_apply_element_mirror` (the column body's stages, full
  metric) at p = 8..10, q = p+1, against the plain version (float64, 1e-13
  of max|ye|: another summation order) and lpfem's
  ``pa_apply_element_kernel`` in TPU interpret mode (float32, 1e-5, the
  float tolerance of ``tests/test_lattice_kernel.py:62``); 3 elements.
- B3a: the same stages with the affine metric ``w3[k] C6[e]`` against
  ``pa_apply_affine_reference`` and lpfem's ``pa_apply_affine_kernel`` in
  interpret mode, as above.
- B2: :func:`lattice_affine_apply_mirror` (windows, the element body, the
  closed-form fold) on a 3 x 1 x 1 leaning lattice against the plain
  version (1e-15) and lpfem's float64 ``fused`` apply (1e-13), without and
  with the top-plane constraint.
- The wrappers' reach: p+1 and q up to 11 pass their checks, 12 does not.

The CUDA kernels are held against the plain versions on the card by
``chip_smoke.py`` (phase 10a) and ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lpfem.kernels.pa_apply import (pa_apply_affine_kernel,
                                    pa_apply_element_kernel)
from lpfem.mesh import Mesh as LMesh
from lpfem.operators import LaplacePA
from lpfem.space import H1Space as LH1Space
from lpfem.space import SurfaceSpace as LSurfaceSpace

from lpfem_torch.experiments.leaning_tank import leaning_tank
from lpfem_torch.kernels import lattice_apply as klat
from lpfem_torch.kernels import pa_apply as kpa
from lpfem_torch.operators import AffineLatticeLaplace
from lpfem_torch.space import CurvedLatticeSpace

ORDERS = [8, 9, 10]
TANK = dict(Lx=1.0, Ly=0.1, Lz=1.0 / (2 * np.pi))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _tables(p, seed):
    rng = np.random.default_rng(seed)
    q = p + 1
    B = rng.standard_normal((q, p + 1))
    D = rng.standard_normal((q, p + 1))
    return rng, q, B, D


@pytest.mark.parametrize("p", ORDERS)
def test_element_mirror_at_wide_orders(p):
    rng, q, B, D = _tables(p, 300 + p)
    ne, Q = 3, q ** 3
    A = rng.standard_normal((ne * Q, 3, 3))
    M = A @ A.transpose(0, 2, 1) + np.eye(3)
    G6 = np.stack([M[:, 0, 0], M[:, 0, 1], M[:, 0, 2], M[:, 1, 1],
                   M[:, 1, 2], M[:, 2, 2]], axis=1)
    G6q = G6.reshape(ne, Q, 6).transpose(0, 2, 1).reshape(ne, 6 * Q)
    u = rng.standard_normal((ne, (p + 1) ** 3))
    Bt, Dt, ut, Gt = (torch.tensor(a) for a in (B, D, u, G6q))
    ye_m = kpa.pa_apply_element_mirror(ut, Gt, Bt, Dt)
    ye_ref = kpa.pa_apply_element_reference(ut, Gt, Bt, Dt)
    assert _rel(ye_m.numpy(), ye_ref.numpy()) < 1e-13
    Jr2 = kpa.grad_interp(Bt, Dt).numpy()
    with pltpu.force_tpu_interpret_mode():
        ye_k = pa_apply_element_kernel(jnp.asarray(u, jnp.float32),
                                       jnp.asarray(G6q, jnp.float32),
                                       jnp.asarray(Jr2, jnp.float32), Q=Q)
    assert _rel(ye_m.numpy(), np.asarray(ye_k)) < 1e-5


@pytest.mark.parametrize("p", ORDERS)
def test_affine_mirror_at_wide_orders(p):
    """The column body with G[e, k] = w3[k] C6[e], B3a's metric."""
    rng, q, B, D = _tables(p, 400 + p)
    ne, Q = 3, q ** 3
    A = rng.standard_normal((ne, 3, 3))
    M = A @ A.transpose(0, 2, 1) + np.eye(3)
    C6 = np.stack([M[:, 0, 0], M[:, 0, 1], M[:, 0, 2], M[:, 1, 1],
                   M[:, 1, 2], M[:, 2, 2]], axis=1)
    w3 = rng.random(Q) + 0.5
    G6q = (C6[:, :, None] * w3[None, None, :]).reshape(ne, 6 * Q)
    u = rng.standard_normal((ne, (p + 1) ** 3))
    Bt, Dt, ut = (torch.tensor(a) for a in (B, D, u))
    ye_m = kpa.pa_apply_element_mirror(ut, torch.tensor(G6q), Bt, Dt)
    ye_ref = kpa.pa_apply_affine_reference(ut, torch.tensor(C6),
                                           torch.tensor(w3), Bt, Dt)
    assert _rel(ye_m.numpy(), ye_ref.numpy()) < 1e-13
    Jr2 = kpa.grad_interp(Bt, Dt).numpy()
    with pltpu.force_tpu_interpret_mode():
        ye_k = pa_apply_affine_kernel(jnp.asarray(u, jnp.float32),
                                      jnp.asarray(C6, jnp.float32),
                                      jnp.asarray(w3, jnp.float32),
                                      jnp.asarray(Jr2, jnp.float32), Q=Q)
    assert _rel(ye_m.numpy(), np.asarray(ye_k)) < 1e-5


@pytest.mark.parametrize("p", ORDERS)
def test_lattice_mirror_at_wide_orders(p):
    mesh = leaning_tank(3, 1, 1, **TANK, lean="z")
    st = CurvedLatticeSpace(mesh, p)
    op = AffineLatticeLaplace(st, torch.float64, "cpu")
    lm = LMesh(mesh.verts, mesh.elems, mesh.corner_coords, mesh.bdr_quads,
               mesh.bdr_attrs, mesh.periodic, mesh.geom_nodes,
               mesh.geom_order, periodic_axes=mesh.periodic_axes,
               elem_lattice=mesh.elem_lattice, lattice_dims=mesh.lattice_dims)
    sl = LH1Space(lm, p)
    np.testing.assert_array_equal(st.elem_dofs, sl.elem_dofs)
    lop = LaplacePA(sl, dtype=jnp.float64, mode="fused")
    ess = np.asarray(LSurfaceSpace(sl, attr=2).surf_to_vol)
    x = np.random.default_rng(500 + p).standard_normal(sl.n_dofs)
    xt = torch.tensor(x)
    args = (op.C6, op.w3, op.B, op.D, st.elem_dims, st.periodic)
    for ess_top in (False, True):
        y_ref = klat.lattice_affine_apply_reference(xt, *args, ess_top)
        y_m = klat.lattice_affine_apply_mirror(xt, *args, ess_top)
        assert _rel(y_m.numpy(), y_ref.numpy()) <= 1e-15
        y_l = (lop.constrained_apply(jnp.asarray(x), jnp.asarray(ess))
               if ess_top else lop.apply(jnp.asarray(x)))
        assert _rel(y_m.numpy(), np.asarray(y_l)) < 1e-13


def test_wrappers_reach_p10_and_refuse_beyond():
    for p1, q, ok in ((11, 11, True), (9, 11, True), (11, 9, True),
                      (12, 12, False), (11, 12, False)):
        B = torch.zeros(q, p1)
        x = torch.zeros(4)
        if ok:
            assert kpa.check_tables("t", x, [("B", B, None),
                                             ("D", B, None)]) == (p1, q)
        else:
            with pytest.raises(ValueError, match="<= 11"):
                kpa.check_tables("t", x, [("B", B, None), ("D", B, None)])
