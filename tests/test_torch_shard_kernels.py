"""The shard modes of B1 and B2, in plain PyTorch, against lpfem's Pallas
kernels in their ``shard_scal`` / ``p0`` mode (TPU interpret mode, CPU).

- B1 (``kernels.sep_apply``): :func:`sep_apply_shard_reference` on the
  z-slab windows of ``scaling_base`` (4 x 2 x 8 hexes; order 2 and 3; 3 and
  4 shards, the 3-shard slabs padded: 3, 3, 2 layers) with each shard's z
  bands from ``ShardedLevel``, against ``lpfem.kernels.sep_apply.
  lattice_sep_apply`` with the tables of lpfem's ``ShardedLevel``, shard by
  shard: float32 within 1e-5 of max|y| (the float tolerance of
  ``tests/test_lattice_kernel.py:62``). The port's float64 plain version
  against its float32 one within 1e-5 of max|y|. Inputs are random on every
  lane of the windows, padding planes and the halo plane included, from
  ``numpy.random.default_rng``.
- B1's tiling in shard mode: :func:`sep_apply_mirror` with ``shard=(zt,
  own0, p0)`` on each window against the plain version (float64, 1e-15 of
  max|y|: the same sums in the same order), with tiles that leave ragged
  edges.
- B2 (``kernels.lattice_apply``): :func:`lattice_affine_apply_shard_
  reference` on the leaning tank's windows (``x += a z``, 4 x 2 x 8 hexes,
  order 2 and 3; 3 and 4 shards), against ``lpfem.kernels.lattice_apply.
  lattice_affine_apply`` in shard mode, float32 within 1e-5.

The ``scal`` rows ``(zt, own0)``: as the sharded solver passes them for the
constrained apply (the Dirichlet plane on the top slab's shard, plane 0
owned by shard 0 only) and for the unconstrained one (zt = -1), and with
``own0`` flipped on every shard. The CUDA kernels are held against these
plain versions on the card by ``chip_smoke.py`` (phase 9) and
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpfem.configs import preset as lp_preset
from lpfem.kernels.lattice_apply import lattice_affine_apply
from lpfem.kernels.sep_apply import lattice_sep_apply
from lpfem.operators import LaplacePA
from lpfem.problem import Problem as LProblem
from lpfem.shard import Partition as LPartition
from lpfem.shard import ShardedLevel as LShardedLevel
from lpfem.space import H1Space as LH1Space
from lpfem.space import SurfaceSpace as LSurfaceSpace

import lpfem_torch
from lpfem_torch.experiments.leaning_tank import leaning_tank
from lpfem_torch.kernels import lattice_apply as klat
from lpfem_torch.kernels import sep_apply as ksep
from lpfem_torch.operators import AffineLatticeLaplace, SeparableLattice
from lpfem_torch.shard import Partition, ShardComm, ShardedLevel
from lpfem_torch.space import CurvedLatticeSpace

from test_torch_meshspace import TANK, to_lpfem

SCAL = ["constrained", "unconstrained", "own0 flipped"]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _scal(lv: ShardedLevel, kind: str) -> torch.Tensor:
    s = (lv.scal_o if kind == "unconstrained" else lv.scal_c).clone()
    if kind == "own0 flipped":
        s[:, 1] = 1 - s[:, 1]
    return s


def _inputs(lv: ShardedLevel, seed: int, dtype=np.float32):
    """Random windows (every lane but the trash lane) and halo planes."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((lv.ndev, lv.N_max + 1)).astype(dtype)
    x[:, lv.N_max] = 0.0
    p0 = rng.standard_normal((lv.ndev, lv.pt.win["plane"])).astype(dtype)
    return x, p0


def _lpfem_level(sl, op32, ndev, ess):
    pt = LPartition(sl, ndev)
    assert pt.win is not None
    lv = LShardedLevel(op32, pt, ess)
    assert lv._fused is not None and lv._ess_top
    return lv


@pytest.mark.parametrize("kind", SCAL)
@pytest.mark.parametrize("ndev", [3, 4])
@pytest.mark.parametrize("order", [2, 3])
def test_sep_shard_matches_lpfem(order, ndev, kind):
    kw = dict(nx=4, ny=2, nz=8, order=order)
    lp = LProblem(lp_preset("scaling_base", **kw))
    ess = np.asarray(lp.surf.surf_to_vol)
    op32 = LaplacePA(lp.space, dtype=jnp.float32, mode="fused")
    op32._init_fused_lattice(force=True)          # interpret-mode pallas
    assert op32.sepk is not None, "B1 did not engage"
    llv = _lpfem_level(lp.space, op32, ndev, ess)
    f = llv._fused

    prob = lpfem_torch.Problem(lpfem_torch.preset("scaling_base", **kw),
                               device="cpu", build_precond=False)
    comm = ShardComm(ndev)
    pt = Partition(prob.space, ndev)
    lv = ShardedLevel(SeparableLattice(prob.space, torch.float32, "cpu"), pt,
                      prob.surf.surf_to_vol, comm, "cpu")
    assert lv.mode == "sep"
    w = pt.win
    if ndev == 3:
        assert list(w["nlay"]) == [3, 3, 2]       # a padded top slab
    scal = _scal(lv, kind)
    x, p0 = _inputs(lv, 10 * order + ndev)
    y, yh = ksep.sep_apply_shard_reference(
        torch.tensor(x), lv.bands_xy, lv.zbands, w["periodic"][0], scal,
        torch.tensor(p0), lv.dims)
    Dx, Dy, Dz = lv.dims
    for d, (zt, own0) in enumerate(scal.tolist()):
        assert zt == -1 or zt % order == 0
        topb = zt // order - 1 if zt >= 0 else -1
        y_l, yh_l = lattice_sep_apply(
            jnp.asarray(x[d, :lv.N_max]), llv.tables["sep_cx"][d],
            llv.tables["sep_cy"][d], llv.tables["sep_zfac"][d], p=f["p"],
            dims=f["dims"], periodic=f["periodic"], Khat=f["sepk"][0],
            Mhat=f["sepk"][1], interpret=True,
            shard_scal=jnp.asarray([topb, own0], dtype=jnp.int32),
            p0=jnp.asarray(p0[d].reshape(1, Dy, Dx)))
        scale = float(np.max(np.abs(np.asarray(y_l))))
        assert np.max(np.abs(y[d, :lv.N_max].numpy() - np.asarray(y_l))) \
            < 1e-5 * scale
        assert np.max(np.abs(yh[d].numpy() - np.asarray(yh_l))) \
            < 1e-5 * scale
        assert float(y[d, lv.N_max]) == 0.0
        if own0:
            assert not torch.any(yh[d])
        else:
            assert not torch.any(y[d, :Dx * Dy])

    # the port's float64 plain version against its float32 one
    lv64 = ShardedLevel(SeparableLattice(prob.space, torch.float64, "cpu"),
                        pt, prob.surf.surf_to_vol, comm, "cpu")
    y64, yh64 = ksep.sep_apply_shard_reference(
        torch.tensor(x.astype(np.float64)), lv64.bands_xy, lv64.zbands,
        w["periodic"][0], scal, torch.tensor(p0.astype(np.float64)),
        lv.dims)
    assert _rel(y.numpy(), y64.numpy()) < 1e-5
    if torch.any(yh64):
        assert _rel(yh.numpy(), yh64.numpy()) < 1e-5


@pytest.mark.parametrize("kind", SCAL)
@pytest.mark.parametrize("ndev,order,tiles", [(3, 2, (5, 3, 4)),
                                              (4, 3, (5, 4, 5)),
                                              (3, 4, (6, 2, 7)),
                                              (3, 8, None)])
def test_sep_shard_mirror_matches_plain(ndev, order, tiles, kind):
    """The kernel's tiling in shard mode, window by window, on windows from
    the solver's tables and tiles that divide none of Dx, Dy, Dz; at order
    8 (float64: the tensor-core route) the tiles of ``choose_tiles``."""
    prob = lpfem_torch.Problem(lpfem_torch.preset(
        "scaling_base", nx=4, ny=2, nz=8, order=order), device="cpu",
        build_precond=False)
    pt = Partition(prob.space, ndev)
    lv = ShardedLevel(SeparableLattice(prob.space, torch.float64, "cpu"), pt,
                      prob.surf.surf_to_vol, ShardComm(ndev), "cpu")
    Dx, Dy, Dz = lv.dims
    if tiles is None:                  # the tensor-core route's own tile
        tiles = ksep.choose_tiles(lv.dims, order, 8, ndev)
    else:
        assert Dx % tiles[0] and Dy % tiles[1] and Dz % tiles[2]
        tiles = (*tiles, tiles[0] + 2 * order)
    scal = _scal(lv, kind)
    x, p0 = _inputs(lv, 7 * order + ndev, np.float64)
    x, p0 = torch.tensor(x), torch.tensor(p0)
    y, yh = ksep.sep_apply_shard_reference(
        x, lv.bands_xy, lv.zbands, pt.win["periodic"][0], scal, p0, lv.dims)
    n = Dx * Dy * Dz
    for d, (zt, own0) in enumerate(scal.tolist()):
        bands = (*lv.bands_xy, lv.zbands[0][d], lv.zbands[1][d])
        ym, yhm = ksep.sep_apply_mirror(
            x[d, :n].reshape(Dz, Dy, Dx), bands, (True, False, False),
            tiles=tiles, shard=(zt, bool(own0), p0[d].reshape(Dy, Dx)))
        assert _rel(ym.reshape(-1).numpy(), y[d, :n].numpy()) <= 1e-15
        if own0:
            assert not torch.any(yhm)
        else:
            assert _rel(yhm.numpy(), yh[d].numpy()) <= 1e-15


@pytest.mark.parametrize("kind", SCAL)
@pytest.mark.parametrize("ndev", [3, 4])
@pytest.mark.parametrize("order", [2, 3])
def test_affine_shard_matches_lpfem(order, ndev, kind):
    mesh = leaning_tank(4, 2, 8, **TANK, lean="z")
    sl = LH1Space(to_lpfem(mesh), order)
    ess = np.asarray(LSurfaceSpace(sl, attr=2).surf_to_vol)
    op32 = LaplacePA(sl, dtype=jnp.float32, mode="fused")
    op32._init_fused_lattice(force=True)          # interpret-mode pallas
    assert op32.C6r is not None and op32.sepk is None, "B2 did not engage"
    llv = _lpfem_level(sl, op32, ndev, ess)
    f = llv._fused

    st = CurvedLatticeSpace(mesh, order)
    op = AffineLatticeLaplace(st, torch.float32, "cpu")
    pt = Partition(st, ndev)
    lv = ShardedLevel(op, pt, ess, ShardComm(ndev), "cpu")
    assert lv.mode == "affine"
    w = pt.win
    scal = _scal(lv, kind)
    x, p0 = _inputs(lv, 20 * order + ndev)
    y, yh = klat.lattice_affine_apply_shard_reference(
        torch.tensor(x), lv.C6, lv.w3, lv.B, lv.D, w["dims"],
        (w["periodic"][0], False, False), scal, torch.tensor(p0))
    Dx, Dy = w["Dx"], w["Dy"]
    for d, (zt, own0) in enumerate(scal.tolist()):
        topb = zt // order - 1 if zt >= 0 else -1
        y_l, yh_l = lattice_affine_apply(
            jnp.asarray(x[d, :lv.N_max]), llv.tables["C6k"][d], llv._w3col,
            llv.Jr2.astype(jnp.float32), p=f["p"], dims=f["dims"],
            periodic=f["periodic"], precision=f["precision"],
            interpret=True,
            shard_scal=jnp.asarray([topb, own0], dtype=jnp.int32),
            p0=jnp.asarray(p0[d].reshape(1, Dy, Dx)))
        scale = float(np.max(np.abs(np.asarray(y_l))))
        assert np.max(np.abs(y[d, :lv.N_max].numpy() - np.asarray(y_l))) \
            < 1e-5 * scale
        assert np.max(np.abs(yh[d].numpy() - np.asarray(yh_l))) \
            < 1e-5 * scale
        assert float(y[d, lv.N_max]) == 0.0


def test_shard_wrappers_take_plain_path_on_cpu_without_counting():
    """On CPU tensors the shard wrappers run their plain versions and leave
    the launch counts alone; a bad ``scal`` row is refused."""
    prob = lpfem_torch.Problem(lpfem_torch.preset(
        "scaling_base", nx=4, ny=2, nz=8, order=2), device="cpu",
        build_precond=False)
    pt = Partition(prob.space, 4)
    lv = ShardedLevel(SeparableLattice(prob.space, torch.float32, "cpu"), pt,
                      prob.surf.surf_to_vol, ShardComm(4), "cpu")
    x, p0 = _inputs(lv, 1)
    n0, m0 = ksep.LAUNCHES_SHARD, klat.LAUNCHES_SHARD
    y, yh = ksep.sep_apply_shard(torch.tensor(x), lv.bands_xy, lv.zbands,
                                 True, lv.scal_c, torch.tensor(p0), lv.dims)
    y_ref, _ = ksep.sep_apply_shard_reference(
        torch.tensor(x), lv.bands_xy, lv.zbands, True, lv.scal_c,
        torch.tensor(p0), lv.dims)
    assert torch.equal(y, y_ref)
    assert (ksep.LAUNCHES_SHARD, klat.LAUNCHES_SHARD) == (n0, m0)
    for bad in ([[0, 1]] * 4, [[-1, 2]] * 4, [[lv.dims[2], 1]] * 4):
        with pytest.raises(ValueError, match="shard row"):
            ksep.check_scal(bad, lv.dims[2])
