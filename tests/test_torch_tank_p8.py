"""The tank at order 8 on the CPU: what the benchmark's ``tank_p8`` runs at
17,105,920 dofs, checked at a size the CPU holds.

- One and two RK4 steps of the ``scaling_base`` tank at order 8 in float64
  (r.z <= rz0 * 1e-28) against the benchmark's plain reference
  (``benchmark.reference.tank.TankReference``: exact solves by fast
  diagonalisation) from seeded states, within 1e-12 of max|y| and
  max|phi|, the numberings matched by coordinates as
  ``benchmark/checks/test_bm_reference.py`` does; the same at order 2 as a
  control of the test itself. The benchmark's own CPU checks cut every
  preset cell to order 2, so order 8 is checked here.
- B1's plain mirror (``sep_apply_mirror``: the kernel's tiles, halos and
  ring) at p = 8 on lattices where ``choose_tiles`` splits the y axis,
  against the plain version in float32 and float64.
- The p-multigrid at order 8: the ladder 8 -> 4 -> 2 -> 1 -> 1 (h) and one
  V-cycle against lpfem's on the same input, with lpfem's lambda_max
  injected (1e-12 of max|z|, as ``tests/test_torch_multigrid.py``).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lpfem_torch
from benchmark.harness import initial_state, load_cell
from benchmark.reference.tank import TankReference
from lpfem.mesh import make_wave_tank
from lpfem.multigrid import PMultigrid as LPMultigrid
from lpfem.operators import LaplacePA
from lpfem.space import H1Space, SurfaceSpace as LSurfaceSpace
from lpfem_torch import convert
from lpfem_torch.kernels import sep_apply as ksep
from lpfem_torch.multigrid import PMultigrid
from lpfem_torch.operators import SeparableLattice
from lpfem_torch.space import LatticeSpace, grid_lines

LZ = 1.0 / (2 * np.pi)


@functools.lru_cache(maxsize=None)
def _tank(order):
    cfg = lpfem_torch.preset("scaling_base", nx=4, ny=1, nz=1, order=order,
                             ref_levels=0, dtype="float64", cg_rtol_sq=1e-28,
                             cg_max_iter=2000, nsteps=150)
    prob = lpfem_torch.Problem(cfg, device="cpu")
    return prob, TankReference(dataclasses.asdict(cfg), "cpu")


@pytest.mark.parametrize("seed", [7, 2 ** 33 + 5])
@pytest.mark.parametrize("order", [8, 2])
def test_steps_match_the_plain_reference(order, seed):
    prob, ref = _tank(order)
    assert ref.n_dofs == prob.space.n_dofs
    assert abs(ref.dt - prob.dt) <= 1e-15 * prob.dt
    s_idx, s_dist = ref.surface_index(
        np.asarray(prob.surf.node_coords)[:, :2])
    v_idx, v_dist = ref.volume_index(np.asarray(prob.space.node_coords))
    assert max(s_dist, v_dist) < 1e-12
    assert len(np.unique(s_idx)) == ref.n_surf
    assert len(np.unique(v_idx)) == ref.n_dofs

    # the seeded m = 2 wave of the benchmark's cell
    y, phi, _ = initial_state(prob, load_cell("tank_p8.f64_refs2"), seed)
    ns = ref.n_surf
    s_t, v_t = torch.as_tensor(s_idx), torch.as_tensor(v_idx)
    t = 0.0
    for _ in range(2):
        t1, y1, phi1 = prob.run(n_steps=1, t0=t, state=(y, phi))
        assert not prob.last_solver_stats.unconverged
        y_ref = torch.empty_like(y)
        y_ref[s_t], y_ref[ns + s_t] = y[:ns], y[ns:]
        yr, phir = ref.step(t, y_ref)
        yr = torch.cat([yr[s_t], yr[ns + s_t]])
        assert float((y1 - yr).abs().max() / yr.abs().max()) < 1e-12
        phir = phir[v_t]
        assert float((phi1 - phir).abs().max() / phir.abs().max()) < 1e-12
        y, phi, t = y1, phi1, t1


# lattices (Dx, Dy, Dz) at p = 8 whose y axis choose_tiles splits in float32
# (8 x 36 threads at most) and in float64 (4 x 40): x periodic with the
# shortest axis the kernel takes (Dx = 2p + 2) and x finite
@pytest.mark.parametrize("ess_top", [False, True])
@pytest.mark.parametrize("dims,periodic", [((18, 41, 5), True),
                                           ((13, 45, 4), False)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-15)])
def test_mirror_at_p8_with_y_split(dims, periodic, dtype, tol, ess_top):
    p = 8
    tiles = ksep.choose_tiles(dims, p, torch.tensor([], dtype=dtype)
                              .element_size())
    assert tiles[1] < dims[1]                   # y split into tiles
    gen = torch.Generator().manual_seed(dims[1])
    bands = tuple(torch.randn(2 * p + 1, D, generator=gen,
                              dtype=torch.float64).to(dtype)
                  for D in (dims[0], dims[0], dims[1], dims[1], dims[2],
                            dims[2]))
    x = torch.randn(dims[::-1], generator=gen, dtype=torch.float64).to(dtype)
    per = (periodic, False, False)
    y_m = ksep.sep_apply_mirror(x, bands, per, ess_top)
    y_ref = ksep.sep_apply_reference(x, bands, per, ess_top)
    err = float((y_m - y_ref).abs().max() / y_ref.abs().max())
    assert err < tol, err


NX, NY, NZ = 8, 2, 4          # p = 1 level: 8 x 3 x 5 = 120 dofs


@functools.lru_cache(maxsize=None)
def _lpfem_pmg():
    sp = H1Space(make_wave_tank(NX, NY, NZ), 8)
    s2v = np.asarray(LSurfaceSpace(sp, attr=2).surf_to_vol)
    op = LaplacePA(sp, dtype=jnp.float64, mode="fused")
    return LPMultigrid(op, ess_dofs=s2v, coarse_dense_limit=100,
                       h_coarsen_min_dofs=100, smooth_degree=4)


def test_pmultigrid_at_p8_matches_lpfem():
    lpm = _lpfem_pmg()
    ls = LatticeSpace((grid_lines(NX, 1.0), grid_lines(NY, 0.1),
                       grid_lines(NZ, LZ)), 8, (True, False, False))
    pm = PMultigrid(SeparableLattice(ls, torch.float64, "cpu"),
                    coarse_dense_limit=100, h_coarsen_min_dofs=100,
                    smooth_degree=4, lmax=convert.smoother_lmax(lpm))
    assert pm.orders == lpm.orders == [8, 4, 2, 1, 1]
    assert [lv.op.space.dof_dims for lv in pm.levels] == \
        [lv.op.space.struct.dof_dims for lv in lpm.levels]
    assert pm.coarse_route == "dense"

    n = lpm.levels[0].op.n_dofs
    r = np.random.default_rng(8).standard_normal(n)
    r[np.asarray(lpm.levels[0].ess)] = 0.0      # CG residuals vanish there
    z_ref = np.asarray(lpm(jnp.asarray(r)))
    z = pm(torch.tensor(r)).numpy()
    rel = np.max(np.abs(z - z_ref)) / np.max(np.abs(z_ref))
    assert rel < 1e-12, rel
