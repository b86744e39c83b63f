"""The decomposition of the Hopper kernel B4 (``kernels.sep_apply_ds``), one
fused launch per apply, in plain PyTorch, against the plain version and
lpfem on the CPU.

:func:`sep_apply_ds_mirror` runs the kernel's tiling (x tiles with a wrapped
or zero halo, y tiles, z-chunks whose halo planes are recomputed, the ring
of the last 2p+1 planes) with the kernel's double-single accumulators, made
of the same eager float32 operations as the plain version's. Tolerances,
with their reasons:

- against ``sep_apply_ds_reference``: bit for bit, on random bands and on
  the bands of a tank, with tiles that leave ragged edges in x, y and z, a
  tile wider than the lattice and a periodic axis of 2p+1 values;
- against lpfem's B4 Pallas kernel in interpret mode at float64: 1e-13
  relative in the 2-norm (lpfem's own structural test; at float32 XLA:CPU
  contracts the error-free transforms, ``tests/test_torch_ds.py``).

The tile chooser's blocks cover every output dof once, and a block's shared
memory fits Hopper's 227 KB up to p = 10. The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpfem import ds as L
from lpfem.configs import preset as lp_preset
from lpfem.kernels.sep_apply_ds import lattice_sep_apply_ds
from lpfem.operators import SeparableLattice as LSeparableLattice
from lpfem.problem import build_mesh as lp_build_mesh
from lpfem.space import H1Space as LH1Space

import lpfem_torch
from lpfem_torch import ds as P
from lpfem_torch.kernels import sep_apply as ksep
from lpfem_torch.kernels import sep_apply_ds as kds
from lpfem_torch.operators import SeparableLattice
from lpfem_torch.space import LatticeSpace, grid_lines


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _pair(rng, shape):
    """A DS pair of float64 values with magnitudes spread over 1e-4..1e4."""
    x = rng.standard_normal(shape) * 10.0 ** rng.uniform(-4, 4, shape)
    return P.ds_from_f64(torch.tensor(x))


def _random_bands(rng, dims, p):
    return tuple(P.ds_from_f64(torch.tensor(rng.standard_normal((2 * p + 1,
                                                                 D))))
                 for D in (dims[0], dims[0], dims[1], dims[1], dims[2],
                           dims[2]))


def _equal(a, b):
    return torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo)


def _tiles(tx, ty, tz, p):
    s = tx + 2 * p
    return tx, ty, tz, s + (tx - s) % 32


# (dims (Dx, Dy, Dz), periodic x, tiles (Tx, Ty, Tz) or None for the
# chooser's): Dx = 2p+1 on a periodic axis, an odd Dx, a tile wider than the
# lattice, y split in tiles, chunks that do not divide Dz
def _cases(p):
    return [((2 * p + 1, 4, 5), True, None),
            ((2 * p + 1, 4, 5), True, (8, 3, 2)),
            ((2 * p + 3, 5, 7), False, (8, 2, 3)),
            ((13, 6, 9), True, (8, 4, 4)),
            ((11, 3, 10), False, None)]


@pytest.mark.parametrize("ess_top", [False, True])
@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_ds_mirror_is_the_plain_version_bitwise(p, case, ess_top):
    dims, periodic, tiles = _cases(p)[case]
    rng = np.random.default_rng(100 * p + 10 * case + ess_top)
    bands = _random_bands(rng, dims, p)
    x = _pair(rng, dims[::-1])
    per = (periodic, False, False)
    if tiles is not None:
        tiles = _tiles(*tiles, p)
        assert dims[1] % tiles[1] and dims[2] % tiles[2]
    y_m = kds.sep_apply_ds_mirror(x.hi, x.lo, bands, per, ess_top, tiles)
    y_ref = kds.sep_apply_ds_reference(x.hi, x.lo, bands, per, ess_top)
    assert _equal(y_m, y_ref)


@pytest.mark.parametrize("ess_top", [False, True])
@pytest.mark.parametrize("periodic,nx,p", [(True, 6, 1), (False, 3, 2),
                                           (True, 3, 3), (False, 2, 4)])
def test_ds_mirror_on_tank_bands_is_bitwise_and_near_float64(periodic, nx, p,
                                                              ess_top):
    """The DS bands of a tank (``SeparableDS``), chooser's tiles: bit for bit
    with the plain version, and within lpfem's 1e-13 of the float64
    operator."""
    space = LatticeSpace((grid_lines(nx, 1.0 if periodic else 12.0),
                          grid_lines(2, 0.1), grid_lines(3, 0.2)), p,
                         (periodic, False, False))
    op = SeparableLattice(space, torch.float64, "cpu")
    dsop = P.SeparableDS(op)
    x64 = np.random.default_rng(nx + p).standard_normal(space.n_dofs)
    x = P.ds_from_f64(torch.tensor(x64))
    sh = space.dof_dims[::-1]
    xh, xl = x.hi.view(sh), x.lo.view(sh)
    y_m = kds.sep_apply_ds_mirror(xh, xl, dsop.bands, space.periodic, ess_top)
    y_ref = kds.sep_apply_ds_reference(xh, xl, dsop.bands, space.periodic,
                                       ess_top)
    assert _equal(y_m, y_ref)
    t = torch.tensor(x64)
    y64 = (op.constrained_apply_top(t) if ess_top else op.apply(t)).numpy()
    assert _rel(P.ds_to_f64(y_m).numpy().reshape(-1), y64) <= 1e-13


def _lpfem_spaces(periodic, p, nx, ny=1, nz=2):
    name = "pf_linear_periodic" if periodic else "pf_linear_serial"
    kw = dict(nx=nx, ny=ny, nz=nz, order=p, ref_levels=0)
    sep = LSeparableLattice.build(
        LH1Space(lp_build_mesh(lp_preset(name, **kw)), p), p + 1,
        jnp.float64)
    return sep, LatticeSpace.from_config(lpfem_torch.preset(name, **kw))


@pytest.mark.parametrize("ess_top", [False, True])
@pytest.mark.parametrize("periodic", [True, False])
def test_ds_mirror_matches_lpfem_pallas_kernel(periodic, ess_top):
    """lpfem's B4 in interpret mode at float64 (its structural test) against
    the mirror with tiles that split y and z."""
    p = 2
    sep_l, space = _lpfem_spaces(periodic, p, nx=4)
    kds_l = L.SeparableDS(sep_l, q=3, use_kernel="interpret")
    k = kds_l._kern
    x64 = np.random.default_rng(7).standard_normal(space.n_dofs)
    xj = L.ds_from_f64(jnp.asarray(x64))
    yh, yl = lattice_sep_apply_ds(
        xj.hi, xj.lo, kds_l._kcx, kds_l._kcy, kds_l._kzt, p=sep_l.p,
        dims=k["dims"], periodic=k["periodic"], ess_top=ess_top,
        interpret=True, dtype=jnp.float64)
    y_pallas = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    dsop = P.SeparableDS(SeparableLattice(space, torch.float64, "cpu"))
    x = P.ds_from_f64(torch.tensor(x64))
    sh = space.dof_dims[::-1]
    Dx, Dy, Dz = space.dof_dims
    tiles = _tiles(8, Dy - 2, Dz - 3, p)
    y_m = kds.sep_apply_ds_mirror(x.hi.view(sh), x.lo.view(sh), dsop.bands,
                                  space.periodic, ess_top, tiles)
    assert _rel(P.ds_to_f64(y_m).numpy().reshape(-1), y_pallas) <= 1e-13


@pytest.mark.parametrize("dims,p", [((512, 33, 129), 4), ((256, 17, 65), 2),
                                    ((128, 9, 33), 1), ((3, 4, 5), 1),
                                    ((21, 100, 30), 10), ((9, 3, 4), 4),
                                    ((267, 41, 19), 6), ((300, 70, 11), 3)])
def test_ds_tile_chooser_covers_each_dof_once(dims, p):
    """The blocks of choose_ds_tiles write every output dof exactly once,
    a block has at most MAX_THREADS threads and fits the shared memory of a
    Hopper block, and the grid is one wave of TARGET_BLOCKS at most; on the
    ss.cpp fine lattice 8 x 33 x 33 (256 blocks)."""
    tiles = kds.choose_ds_tiles(dims, p)
    tx, ty, tz, s = tiles
    assert tx == kds.TX and tx * ty <= kds.MAX_THREADS
    assert s >= tx + 2 * p and (s - tx) % 32 == 0
    Dx, Dy, Dz = dims
    hits = torch.zeros(Dz, Dy, Dx, dtype=torch.int32)
    blocks = ksep.tile_blocks(dims, tiles)
    for x0, x1, y0, y1, z0, z1 in blocks:
        hits[z0:z1, y0:y1, x0:x1] += 1
    assert bool((hits == 1).all())
    assert kds.ds_tile_smem_bytes(p, tiles) <= ksep.SMEM_LIMIT
    assert len(blocks) <= max(kds.TARGET_BLOCKS,
                              -(-Dx // tx) * -(-Dy // ty))
    if dims == (512, 33, 129):
        assert tiles == (8, 33, 33, 40) and len(blocks) == 256


def test_ds_tile_shared_memory_fits_up_to_p10():
    worst = max(kds.ds_tile_smem_bytes(p, kds.choose_ds_tiles(dims, p))
                for p in range(1, kds.MAX_P + 1)
                for dims in ((2 * p + 1, 3, 4), (4097, 33, 129),
                             (513, 1000, 65), (40, 200, 3000),
                             (p + 1, 500, 7)))
    assert worst <= ksep.SMEM_LIMIT


def test_ds_wrapper_on_cpu_counts_nothing_and_rejects_high_orders():
    rng = np.random.default_rng(11)
    dims = (7, 3, 4)
    bands = _random_bands(rng, dims, 2)
    x = _pair(rng, dims[::-1])
    before = kds.LAUNCHES
    y = kds.sep_apply_ds(x.hi, x.lo, bands, (True, False, False), True)
    assert _equal(y, kds.sep_apply_ds_reference(x.hi, x.lo, bands,
                                                (True, False, False), True))
    assert kds.LAUNCHES == before
    p = kds.MAX_P + 1
    big = tuple(P.DS(torch.zeros(2 * p + 1, D), torch.zeros(2 * p + 1, D))
                for D in (30, 30, 3, 3, 4, 4))
    z = torch.zeros(4, 3, 30)
    with pytest.raises(ValueError, match="1 <= p"):
        kds._check(z, z, big, (True, False, False))
