"""The decompositions of the two Hopper kernels redesigned for one launch
and the column body, in plain PyTorch, against lpfem on the CPU.

- B1 (``kernels.sep_apply``): :func:`sep_apply_mirror` runs the fused
  kernel's tiling (x tiles with a wrapped or zero halo, y tiles, z-chunks
  whose halo planes are recomputed, the ring of the last 2p+1 planes) with
  tiles that leave ragged edges in x, y and z. Against the plain version
  (float64, 1e-15 of max|y|: the same sums in the same order), lpfem's B1
  Pallas kernel in interpret mode (float32, 1e-5: the float tolerance of
  ``tests/test_lattice_kernel.py:62``) and lpfem's float64 apply (1e-13).
  The tile chooser's blocks cover every output dof once, and a block's
  shared memory fits Hopper's 227 KB up to p = 10 in float64.
- B3b (``kernels.pa_apply``): :func:`pa_apply_element_mirror` runs the
  column body's stages with the full metric. Against the plain version
  (float64, 1e-13 of max|ye|: another summation order) and lpfem's
  ``pa_apply_element_kernel`` in TPU interpret mode (float32, 1e-5).

The CUDA kernels themselves are held against the plain versions on the card
by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lpfem.kernels.pa_apply import pa_apply_element_kernel
from lpfem.mesh import make_wave_tank, make_wave_tank_finite
from lpfem.operators import LaplacePA
from lpfem.space import H1Space, SurfaceSpace as LSurfaceSpace

from lpfem_torch.kernels import pa_apply as kpa
from lpfem_torch.kernels import sep_apply as ksep
from lpfem_torch.operators import SeparableLattice
from lpfem_torch.space import LatticeSpace, grid_lines

LZ = 1.0 / (2 * np.pi)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# (p, periodic x, (nx, ny, nz) elements, tiles (Tx, Ty, Tz)): odd Dx and
# Dx = 2p+1, and tiles that divide none of Dx, Dy, Dz
CASES = [
    (1, True, (3, 2, 3), (2, 2, 3)),     # Dx = 3 = 2p+1
    (1, True, (5, 2, 3), (3, 2, 3)),     # Dx = 5
    (2, True, (6, 2, 3), (5, 4, 4)),     # 12 x 5 x 7
    (2, False, (3, 2, 2), (3, 3, 2)),    # Dx = 7
    (3, True, (3, 1, 2), (4, 3, 4)),     # Dx = 9
    (3, False, (4, 1, 2), (5, 3, 3)),    # Dx = 13
    (4, True, (3, 1, 2), (5, 3, 5)),     # 12 x 5 x 9
    (4, False, (2, 1, 2), (4, 2, 4)),    # Dx = 9
]


@pytest.mark.parametrize("ess_top", [False, True])
@pytest.mark.parametrize("p,periodic,elems,tiles", CASES)
def test_sep_mirror_matches_reference_and_lpfem(p, periodic, elems, tiles,
                                                ess_top):
    nx, ny, nz = elems
    Lx, Ly = (1.0, 0.1) if periodic else (12.0, 1.0)
    mk = make_wave_tank if periodic else make_wave_tank_finite
    sl = H1Space(mk(nx, ny, nz, Lx, Ly, LZ), p)
    ls = LatticeSpace((grid_lines(nx, Lx), grid_lines(ny, Ly),
                       grid_lines(nz, LZ)), p, (periodic, False, False))
    Dx, Dy, Dz = ls.dof_dims
    assert Dx % tiles[0] and Dy % tiles[1] and Dz % tiles[2]
    tiles = (*tiles, tiles[0] + 2 * p)
    x = np.random.default_rng(10 * p + nx).standard_normal(sl.n_dofs)
    s2v = np.asarray(LSurfaceSpace(sl, attr=2).surf_to_vol)

    op64 = SeparableLattice(ls, torch.float64, "cpu")
    x64 = torch.tensor(x).reshape(Dz, Dy, Dx)
    y_m = ksep.sep_apply_mirror(x64, op64.bands, op64.periodic, ess_top,
                                tiles)
    y_ref = ksep.sep_apply_reference(x64, op64.bands, op64.periodic, ess_top)
    assert _rel(y_m.numpy(), y_ref.numpy()) <= 1e-15

    lop64 = LaplacePA(sl, dtype=jnp.float64, mode="fused")
    y_l64 = (lop64.sep.constrained_apply_top(jnp.asarray(x)) if ess_top
             else lop64.sep.apply(jnp.asarray(x)))
    assert _rel(y_m.numpy().reshape(-1), y_l64) < 1e-13

    lop32 = LaplacePA(sl, dtype=jnp.float32, mode="fused")
    lop32._init_fused_lattice(force=True)          # interpret-mode pallas
    assert lop32.sepk is not None, "B1 did not engage"
    x32 = x.astype(np.float32)
    if ess_top:
        assert lop32.enable_top_plane_ess(s2v)
        y_k = lop32.constrained_apply(jnp.asarray(x32),
                                      jnp.asarray(s2v.astype(np.int32)))
    else:
        y_k = lop32.apply(jnp.asarray(x32))
    op32 = SeparableLattice(ls, torch.float32, "cpu")
    y_m32 = ksep.sep_apply_mirror(torch.tensor(x32).reshape(Dz, Dy, Dx),
                                  op32.bands, op32.periodic, ess_top, tiles)
    assert _rel(y_m32.numpy().reshape(-1), np.asarray(y_k)) < 1e-5


@pytest.mark.parametrize("ess_top", [False, True])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_sep_mirror_wraps_a_short_periodic_axis(p, ess_top):
    """Dx = 2p+1 on a periodic axis with random bands, x tiles of 2 and 4
    columns: a tile's halo wraps around the axis more than once."""
    rng = np.random.default_rng(p)
    dims = (2 * p + 1, 4, 5)
    bands = tuple(torch.tensor(rng.standard_normal((2 * p + 1, D)))
                  for D in (dims[0], dims[0], dims[1], dims[1], dims[2],
                            dims[2]))
    x = torch.tensor(rng.standard_normal(dims[::-1]))
    per = (True, False, False)
    y_ref = ksep.sep_apply_reference(x, bands, per, ess_top)
    for tx in (2, 4):
        y_m = ksep.sep_apply_mirror(x, bands, per, ess_top,
                                    (tx, 3, 2, tx + 2 * p))
        assert _rel(y_m.numpy(), y_ref.numpy()) <= 1e-15


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("dims,p", [((512, 33, 129), 4), ((256, 17, 65), 2),
                                    ((128, 9, 33), 1), ((64, 5, 17), 1),
                                    ((21, 100, 30), 10), ((9, 3, 4), 4),
                                    ((300, 70, 11), 3),
                                    ((1024, 65, 257), 8), ((20, 41, 7), 8)])
def test_tile_chooser_covers_each_dof_once(dims, p, itemsize):
    """The blocks of choose_tiles write every output dof exactly once, a
    block has at most MAX_THREADS threads and fits the shared memory of a
    Hopper block; on the ss.cpp lattices the grid has >= 264 blocks (p = 8
    in float64: the tensor-core route's fixed tile)."""
    tiles = ksep.choose_tiles(dims, p, itemsize)
    tx, ty, tz, s = tiles
    assert tx * ty <= ksep.MAX_THREADS[itemsize]
    if ksep.tensor_core_route(p, itemsize):
        # the DMMA route's fixed tile; its fragments read rows s apart
        assert (tx, ty) == (ksep.TC_TX, ksep.TC_TY) and tz % 8 == 0
        assert s >= tx + 2 * p and s % 16 == 4
    else:
        if p == 8:
            assert tx == min(ksep.P8_TX, dims[0])
            assert tx * ty <= ksep.P8_THREADS
        assert s >= tx + 2 * p and (s - tx) % (32 * 4 // itemsize) == 0
    Dx, Dy, Dz = dims
    hits = torch.zeros(Dz, Dy, Dx, dtype=torch.int32)
    blocks = ksep.tile_blocks(dims, tiles)
    for x0, x1, y0, y1, z0, z1 in blocks:
        hits[z0:z1, y0:y1, x0:x1] += 1
    assert bool((hits == 1).all())
    assert ksep.tile_smem_bytes(p, tiles, itemsize) <= ksep.SMEM_LIMIT
    if Dx * Dy * Dz > 100_000:
        assert len(blocks) >= ksep.TARGET_BLOCKS


def test_tile_shared_memory_fits_up_to_p10_in_float64():
    worst = max(ksep.tile_smem_bytes(p, ksep.choose_tiles(dims, p, 8), 8)
                for p in range(1, ksep.MAX_P + 1)
                for dims in ((2 * p + 1, 3, 4), (4097, 33, 129),
                             (513, 1000, 65), (40, 200, 3000)))
    assert worst <= ksep.SMEM_LIMIT


def test_sep_wrapper_on_cpu_counts_nothing_and_rejects_high_orders():
    op = SeparableLattice(LatticeSpace((grid_lines(6, 1.0), grid_lines(2, 0.1),
                                        grid_lines(3, LZ)), 2,
                                       (True, False, False)),
                          torch.float64, "cpu")
    x = torch.randn(op.dof_dims[::-1], dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    before = dict(ksep.LAUNCHES_BY_P)
    y = ksep.sep_apply(x, op.bands, op.periodic, True)
    assert torch.equal(y, ksep.sep_apply_reference(x, op.bands, op.periodic,
                                                   True))
    assert ksep.LAUNCHES_BY_P == before
    p = ksep.MAX_P + 1
    big = tuple(torch.zeros(2 * p + 1, D, dtype=torch.float64)
                for D in (30, 30, 3, 3, 4, 4))
    with pytest.raises(ValueError, match="1 <= p"):
        ksep._check(torch.zeros(4, 3, 30, dtype=torch.float64), big,
                    (True, False, False))


@pytest.mark.parametrize("p,q", [(1, 2), (2, 3), (4, 5), (2, 4), (3, 5)])
def test_element_mirror_matches_reference_and_lpfem_kernel(p, q):
    """The column body's stages with the full metric (random symmetric
    positive definite at each Gauss point, 37 elements) against the plain
    version and lpfem's B3b in TPU interpret mode."""
    rng = np.random.default_rng(100 + 10 * p + q)
    B = rng.standard_normal((q, p + 1))
    D = rng.standard_normal((q, p + 1))
    ne, Q = 37, q ** 3
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

    f = torch.float32
    ye_m32 = kpa.pa_apply_element_mirror(ut.to(f), Gt.to(f), Bt.to(f),
                                         Dt.to(f))
    Jr2 = kpa.grad_interp(Bt, Dt).numpy()
    with pltpu.force_tpu_interpret_mode():
        ye_k = pa_apply_element_kernel(jnp.asarray(u, jnp.float32),
                                       jnp.asarray(G6q, jnp.float32),
                                       jnp.asarray(Jr2, jnp.float32), Q=Q)
    assert _rel(ye_m32.numpy(), np.asarray(ye_k)) < 1e-5
    assert _rel(ye_m.numpy(), np.asarray(ye_k)) < 1e-5


def test_element_wrapper_on_cpu_counts_nothing():
    rng = np.random.default_rng(7)
    B, D = (torch.tensor(rng.standard_normal((3, 3))) for _ in range(2))
    u = torch.tensor(rng.standard_normal((5, 27)))
    G = torch.tensor(rng.random((5, 6 * 27)))
    before = (kpa.LAUNCHES, dict(kpa.LAUNCHES_BY_P))
    assert torch.equal(kpa.pa_apply_element(u, G, B, D),
                       kpa.pa_apply_element_reference(u, G, B, D))
    assert (kpa.LAUNCHES, kpa.LAUNCHES_BY_P) == before
