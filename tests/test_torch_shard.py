"""lpfem_torch.shard against lpfem.shard on the CPU (lpfem on a virtual
8-device mesh, the port's shards stacked on one tensor axis).

- ``Partition``: every table equal integer for integer (``part``, ``owner``,
  ``loc_of_dof``, ``N_max``, ``NS``, ``H_max``, ``E_max``,
  ``local_elem_dofs``, ``halo_pos``, ``own_if_*``, ``win``) and the
  neighbour-exchange tables (``gslf``, ``gslw``, ``hr``, ``hsf``, ``hsw``)
  with the exchange lpfem picks, on the z-slab window layout (periodic and
  finite tanks, 3 shards with a padded slab and 4) and the compact layout
  (the periodic tank's x-slabs with the wrap seam, the flagship's), and the
  levels and "via" partitions of the p-multigrid with h-levels (window
  vias at 4 shards, the compact rebuild at 3 shards, compact x-slabs).
- ``ShardedPMG`` applied once (the single-device smoother, element
  transfer and V-cycle over the sharded hierarchy) against lpfem's
  ``ShardedPMG.vcycle`` under ``shard_map`` with lpfem's lambda_max, on
  the window-via and compact-rebuild hierarchies: 1e-11 of max|z|.
- ``ShardedLevel.apply_c`` / ``apply_own`` through both exchanges against
  lpfem's ``ShardedLevel`` under ``shard_map``, float64, 1e-12 of max|y|:
  B1's shard mode (window), B2's (the leaning tank's windows) and the
  element path (compact). The exchange's compiled routes (one gather, one
  indexed add) give the values of the collectives they were compiled
  from: the gather bit for bit, the assembly within 1e-15; the window
  primitives (``window`` bit for bit, ``unwindow`` within 1e-15).
- ``ShardedProblem`` trajectories against lpfem's, from lpfem's stacked
  state after one step (``convert.sharded_state_from_lpfem``), with lpfem's
  smoother lambda_max injected: the z-slab p-multigrid case of
  ``tests/test_shard.py:132-147`` (5 steps) and the relaxation tank (5
  steps): y and phi within 1e-10 relative, the running maximum of the CG
  iterations equal after every step. The mixed-precision case with
  h-levels (3 shards, the compact rebuild): y and phi within 1e-8
  relative, each step's maximum within one inner iteration per outer pass
  (``ir_max_outer``): the float32 inner solves sum in another order than
  XLA's, as in ``tests/test_torch_problem.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from lpfem.configs import preset as lp_preset
from lpfem.problem import Problem as LProblem
from lpfem.shard import Partition as LPartition
from lpfem.shard import ShardedLevel as LShardedLevel
from lpfem.shard import ShardedPMG as LShardedPMG
from lpfem.shard import ShardedProblem as LShardedProblem
from lpfem.shard import make_device_mesh
from lpfem.space import H1Space as LH1Space
from lpfem.space import SurfaceSpace as LSurfaceSpace

import lpfem_torch
from lpfem_torch import convert
from lpfem_torch.experiments.leaning_tank import leaning_tank
from lpfem_torch.operators import laplace_operator
from lpfem_torch.shard import (Partition, ShardComm, ShardedExchange,
                               ShardedLevel, ShardedPMG, ShardedProblem)
from lpfem_torch.space import CurvedLatticeSpace

from test_torch_meshspace import TANK, to_lpfem

PT_TABLES = ("part", "owner", "loc_of_dof", "N_max", "NS", "H_max", "E_max",
             "local_elem_dofs", "halo_pos", "own_if_pos", "own_if_loc")
NBR = ("gslf", "gslw", "hr", "hsf", "hsw")

TANKS = {
    "window periodic": ("scaling_base", dict(nx=4, ny=2, nz=8, order=2)),
    "window finite": ("scaling_base", dict(nx=4, ny=2, nz=8, order=3,
                                           mesh_kind="finite_tank")),
    "compact periodic": ("pf_linear_periodic", dict(nx=8, nz=2, order=3)),
    "compact flagship": ("pf_linear_par_partial", dict(order=2)),
}


def _problems(name, **extra):
    preset_name, kw = TANKS[name]
    kw = dict(kw, **extra)
    return (LProblem(lp_preset(preset_name, **kw)),
            lpfem_torch.Problem(lpfem_torch.preset(preset_name, **kw),
                                device="cpu", build_precond=False))


def _assert_partition_equal(a, b):
    for k in PT_TABLES:
        np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                      np.asarray(getattr(b, k)), k)
    assert (a.win is None) == (b.win is None)
    if a.win is not None:
        assert a.win.keys() == b.win.keys()
        for k in a.win:
            np.testing.assert_array_equal(np.asarray(a.win[k]),
                                          np.asarray(b.win[k]), k)


def _assert_exchange_equal(lex, tex):
    assert lex.exchange == tex.exchange
    if lex.exchange == "ppermute":
        for k in NBR:
            np.testing.assert_array_equal(np.asarray(lex.tables[k]),
                                          tex.nbr[k], k)


@pytest.mark.parametrize("ndev", [3, 4])
@pytest.mark.parametrize("name", list(TANKS))
def test_partition_tables_match_lpfem(name, ndev):
    lp, tp = _problems(name)
    a, b = LPartition(lp.space, ndev), Partition(tp.space, ndev)
    _assert_partition_equal(a, b)
    assert (b.win is not None) == name.startswith("window")
    # the exchange lpfem picks, with its tables
    from lpfem.shard import ShardedExchange as LShardedExchange
    _assert_exchange_equal(LShardedExchange(a),
                           ShardedExchange(b, ShardComm(ndev), "cpu"))
    v = np.random.default_rng(ndev).standard_normal(tp.space.n_dofs)
    np.testing.assert_array_equal(b.unstack_dof(b.stack_dof(v)), v)
    np.testing.assert_array_equal(b.stack_dof(v), a.stack_dof(v))


def _pmg_pair(case):
    """(lpfem's sharded p-multigrid, the port's with lpfem's lambda_max,
    lpfem's partition, lpfem's problem), with h-levels."""
    if case == "compact x-slabs":
        name, kw, ndev = "pf_linear_periodic", dict(nx=12, ny=2, nz=2,
                                                   order=2), 4
    else:
        name, kw = "scaling_base", dict(nx=8, ny=2, nz=8, order=4)
        ndev = 4 if case == "window vias" else 3
    kw.update(precond="pmg", h_coarsen_min_dofs=0)
    lp = LProblem(lp_preset(name, **kw), build_precond=False)
    tp = lpfem_torch.Problem(lpfem_torch.preset(name, **kw), device="cpu",
                             build_precond=False)
    lpt, tpt = LPartition(lp.space, ndev), Partition(tp.space, ndev)
    lpmg = LShardedPMG(lp, lpt, ndev, h_coarsen_min_dofs=0)
    tpmg = ShardedPMG(tp, tpt, ShardComm(ndev), "cpu",
                      h_coarsen_min_dofs=0, lmax=lpmg.lmax)
    return lpmg, tpmg, lpt, lp


@pytest.mark.parametrize("case", ["window vias", "compact rebuild",
                                  "compact x-slabs"])
def test_pmg_partitions_match_lpfem(case):
    """Every level's partition, the exchange it picks, and every h-transfer
    'via' partition of the sharded p-multigrid."""
    lpmg, tpmg, _, _ = _pmg_pair(case)
    n_p = tpmg.orders.index(1) + 1                 # the p-levels
    assert tpmg.orders == lpmg.orders and len(tpmg.orders) > n_p
    for ll, tl in zip(lpmg.levels, tpmg.levels):
        _assert_partition_equal(ll.pt, tl.pt)
        _assert_exchange_equal(ll, tl)
    vias = [(lt.via, tt.via) for lt, tt in zip(lpmg.transfers,
                                               tpmg.transfers)
            if lt.via is not None]
    assert len(vias) == len(tpmg.levels) - n_p
    for lv_, tv in vias:
        _assert_partition_equal(lv_.pt, tv.pt)
        _assert_exchange_equal(lv_, tv)
    layouts = ["window" if lv.pt.win else "compact" for lv in tpmg.levels]
    if case == "window vias":
        assert all(lay == "window" for lay in layouts[:4])
    elif case == "compact rebuild":
        assert layouts[:2] == ["window", "window"] and layouts[2] == "compact"
    else:
        assert all(lay == "compact" for lay in layouts)


@pytest.mark.parametrize("case", ["window vias", "compact rebuild"])
def test_sharded_vcycle_matches_lpfem(case):
    """One application of the port's sharded p-multigrid (the single-device
    smoother, element transfer and V-cycle over the sharded hierarchy) to a
    seeded residual against lpfem's ``ShardedPMG.vcycle`` under
    ``shard_map``, with lpfem's lambda_max, float64, 1e-11 of max|z|."""
    lpmg, tpmg, lpt, lp = _pmg_pair(case)
    assert len(tpmg.levels) == len(lpmg.levels) > 3
    assert tpmg.coarse_solve is tpmg.smoothers[-1]
    assert tpmg.coarse_solve.degree == 16
    ess = np.asarray(lp.surf.surf_to_vol)
    r = np.random.default_rng(3).standard_normal(lp.space.n_dofs)
    r[ess] = 0.0
    r_st = lpt.stack_dof(r)

    def dev_fn(r_st, tbs):
        tbs = jax.tree.map(lambda a: a[0], tbs)
        return lpmg.vcycle(tbs, r_st[0])[None]

    ndev = lpt.ndev
    fn = jax.jit(jax.shard_map(dev_fn, mesh=make_device_mesh(ndev),
                               in_specs=(P("shard"), P("shard")),
                               out_specs=P("shard"), check_vma=False))
    z_l = lpt.unstack_dof(np.asarray(fn(jnp.asarray(r_st),
                                        lpmg.all_tables())))
    z_t = lpt.unstack_dof(tpmg(torch.tensor(r_st)).numpy())
    assert np.max(np.abs(z_t - z_l)) < 1e-11 * np.max(np.abs(z_l))


def _level_pair(name, ndev, exchange):
    """(lpfem level, port level, x, lpfem partition) in float64."""
    if name == "leaning":
        mesh = leaning_tank(4, 2, 8, **TANK, lean="z")
        sl = LH1Space(to_lpfem(mesh), 3)
        from lpfem.operators import LaplacePA
        lop = LaplacePA(sl, dtype=jnp.float64, mode="fused")
        ess = np.asarray(LSurfaceSpace(sl, attr=2).surf_to_vol)
        st = CurvedLatticeSpace(mesh, 3)
        top = laplace_operator(st, torch.float64, "cpu")
        lspace, tspace = sl, st
    else:
        lp, tp = _problems(name)
        lop, top, ess = lp.op, tp.op, np.asarray(lp.surf.surf_to_vol)
        lspace, tspace = lp.space, tp.space
    lpt, tpt = LPartition(lspace, ndev), Partition(tspace, ndev)
    llv = LShardedLevel(lop, lpt, ess, exchange=exchange)
    tlv = ShardedLevel(top, tpt, ess, ShardComm(ndev), "cpu", exchange)
    x = np.random.default_rng(ndev).standard_normal(tspace.n_dofs)
    return llv, tlv, x, lpt


@pytest.mark.parametrize("exchange", ["ppermute", "psum"])
@pytest.mark.parametrize("name,ndev,mode", [
    ("window periodic", 3, "sep"), ("window finite", 4, "sep"),
    ("leaning", 3, "affine"), ("compact periodic", 4, "element"),
    ("compact flagship", 3, "element")])
def test_level_applies_match_lpfem(name, ndev, mode, exchange):
    llv, tlv, x, lpt = _level_pair(name, ndev, exchange)
    assert tlv.mode == mode and tlv.exchange == llv.exchange == exchange
    x_st = lpt.stack_dof(x)

    def dev_fn(x_st, tb):
        tb = jax.tree.map(lambda a: a[0], tb)
        return llv.apply_c(tb, x_st[0])[None], llv.apply_own(tb, x_st[0])[None]

    fn = jax.jit(jax.shard_map(dev_fn, mesh=make_device_mesh(ndev),
                               in_specs=(P("shard"), P("shard")),
                               out_specs=(P("shard"), P("shard")),
                               check_vma=False))
    yc_l, yo_l = (np.asarray(a) for a in fn(jnp.asarray(x_st), llv.tables))
    xt = torch.tensor(x_st)
    yc_t, yo_t = tlv.apply_c(xt).numpy(), tlv.apply_own(xt).numpy()
    for yt, yl in ((yc_t, yc_l), (yo_t, yo_l)):
        assert np.max(np.abs(yt - yl)) < 1e-12 * np.max(np.abs(yl))
        assert not np.any(yt[:, tlv.N_max])
    # the compiled routes give the collectives' values
    torch.testing.assert_close(tlv.gather_halo(xt),
                               tlv._gather_halo_collective(xt), rtol=0,
                               atol=0)
    yh = torch.tensor(np.random.default_rng(1).standard_normal(
        (ndev, tlv.H_max)))
    torch.testing.assert_close(tlv.assemble_halo(xt.clone(), yh),
                               tlv._assemble_collective(xt, yh), rtol=1e-15,
                               atol=0)


@pytest.mark.parametrize("exchange", ["ppermute", "psum"])
@pytest.mark.parametrize("name,ndev", [("window periodic", 3),
                                       ("window finite", 4)])
def test_window_primitives_match_lpfem(name, ndev, exchange):
    """``window`` / ``unwindow`` (the halo plane into plane 0, plane 0's
    contributions back to the lower neighbour) against lpfem's."""
    llv, tlv, x, lpt = _level_pair(name, ndev, exchange)
    y3 = np.random.default_rng(5).standard_normal(
        (ndev, tlv.win["Dz_win"], tlv.win["Dy"], tlv.win["Dx"]))

    def dev_fn(x_st, y3, tb):
        tb = jax.tree.map(lambda a: a[0], tb)
        return llv.window(tb, x_st[0])[None], llv.unwindow(tb, y3[0])[None]

    fn = jax.jit(jax.shard_map(dev_fn, mesh=make_device_mesh(ndev),
                               in_specs=(P("shard"),) * 3,
                               out_specs=(P("shard"), P("shard")),
                               check_vma=False))
    w_l, u_l = (np.asarray(a) for a in fn(jnp.asarray(lpt.stack_dof(x)),
                                          jnp.asarray(y3), llv.tables))
    xt = torch.tensor(lpt.stack_dof(x))
    np.testing.assert_array_equal(tlv.window(xt).numpy(), w_l)
    u_t = tlv.unwindow(torch.tensor(y3)).numpy()
    assert np.max(np.abs(u_t - u_l)) <= 1e-15 * np.max(np.abs(u_l))


def _trajectory(name, kw, ndev, n_steps, zero_state=False):
    lp = LProblem(lp_preset(name, **kw))
    sl = LShardedProblem(lp, mesh=make_device_mesh(ndev))
    y0, phi0 = lp.zero_state() if zero_state else lp.initial_state()
    t1, y1, ph1 = sl.run(n_steps=1, state=(y0, phi0))
    (t_l, y_l, ph_l), its_l = sl.run(
        n_steps=n_steps, t0=float(t1), state=(y1, ph1),
        record=lambda t, y, aux: aux[1].max_iters)
    tp = lpfem_torch.Problem(lpfem_torch.preset(name, **kw), device="cpu",
                             build_precond=False)
    lmax = convert.smoother_lmax(sl.pmg) if sl.pmg is not None else None
    st = ShardedProblem(tp, ndev, lmax=lmax)
    s2v = np.asarray(lp.surf.surf_to_vol)
    y_c, ph_c = convert.sharded_state_from_lpfem(
        np.asarray(y1), np.asarray(ph1), s2v, tp.space.dof_dims)
    its_t = []
    t_t, y_t, ph_t = st.run(
        n_steps=n_steps, t0=float(t1), state=(y_c, ph_c),
        record=lambda t, y, aux: its_t.append(aux.stats.max_iters))
    st.check_state(y_t, ph_t)
    assert abs(t_t - float(t_l)) < 1e-14
    y_lc, _ = convert.state_from_lpfem(np.asarray(y_l), np.zeros(0), s2v,
                                       tp.space.dof_dims)
    return dict(st=st, y=(y_t.numpy(), y_lc), phi=(ph_t.numpy(),
                                                   np.asarray(ph_l)),
                iters=(np.array(its_t), np.asarray(its_l)))


@pytest.mark.parametrize("case", ["zslab pmg", "relaxation tank"])
def test_trajectory_matches_lpfem(case):
    if case == "zslab pmg":
        r = _trajectory("scaling_base", dict(
            nx=4, ny=2, nz=8, order=2, precond="pmg", cg_rtol_sq=1e-24,
            cg_max_iter=400), 4, 5)
        assert r["st"].pt.win is not None and r["st"].pmg is not None
    else:
        r = _trajectory("pf_linear_par_partial", dict(
            nsteps=5, t_final_periods=5 * 5 / 180, order=2,
            cg_max_iter=600), 4, 5, zero_state=True)
        assert r["st"].relax is not None and r["st"].pt.win is None
    for k in ("y", "phi"):
        t, lref = r[k]
        assert np.max(np.abs(t - lref)) < 1e-10 * np.max(np.abs(lref)), k
    np.testing.assert_array_equal(*r["iters"])


def test_mixed_h_coarsened_trajectory_matches_lpfem():
    kw = dict(nx=8, ny=2, nz=8, order=4, precond="pmg", cg_rtol_sq=1e-24,
              cg_max_iter=400, h_coarsen_min_dofs=0, dtype="mixed")
    r = _trajectory("scaling_base", kw, 3, 1)
    st = r["st"]
    assert st.fine_hi is not None and len(st.pmg.levels) > 3
    assert [lv.pt.win is not None for lv in st.pmg.levels][:3] == \
        [True, True, False]                        # the compact rebuild
    for k in ("y", "phi"):
        t, lref = r[k]
        assert np.max(np.abs(t - lref)) < 1e-8 * np.max(np.abs(lref)), k
    its_t, its_l = r["iters"]
    assert np.all(np.abs(its_t - its_l) <= st.prob.cfg.ir_max_outer)
