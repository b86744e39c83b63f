"""lpfem_torch.io and lpfem_torch.profiling against lpfem's on the CPU.

- ``DataFile``: the same rows give the same bytes as ``lpfem.io.DataFile``.
- VTU / PVD: the ASCII text of the volume and surface writers equals
  lpfem's NumPy writer (``binary=False``) byte for byte on a 2x1x1 finite
  tank at p = 1, 2, 3, on the port's ``H1Space`` and on its
  ``LatticeSpace`` of the same tank (whose element tables equal lpfem's).
- Checkpoints: a round trip is exact, a double-single potential included
  (recombined to float64 on save, split again on resume), and each package
  reads the other's file.
- the record's spans (the phase timer), ``check_finite``, ``trace``.
"""

import numpy as np
import pytest
import torch

from lpfem import io as lio
from lpfem.mesh import make_wave_tank as lp_tank
from lpfem.mesh import make_wave_tank_finite as lp_tank_finite
from lpfem.space import H1Space as LH1Space
from lpfem.space import SurfaceSpace as LSurfaceSpace

from lpfem_torch import io as pio
from lpfem_torch.ds import DS, ds_from_f64, ds_to_f64
from lpfem_torch.mesh import make_wave_tank_finite
from lpfem_torch.profiling import check_finite, reset, span, trace
from lpfem_torch.space import H1Space, LatticeSpace, SurfaceSpace, grid_lines

ROWS = [(1, 282880, "mixed", 1e-16, 0.2875, 39355347.2, 8, 0.9291),
        (np.int64(2), np.float32(0.1), np.float64(1.0 / 3.0), 7, -0.0,
         1e300, "f32", True)]


def test_datafile_text_matches_lpfem(tmp_path):
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    hdr = "refs dofs dtype rtol_sq wall_s dof_solves_per_s cg_iters apply_ms"
    la, pb = lio.DataFile(str(a), hdr), pio.DataFile(str(b), hdr)
    for row in ROWS:
        la.append(*row)
        pb.append(*row)
    assert a.read_bytes() == b.read_bytes()
    # the header is written once: a second writer on the file appends
    pio.DataFile(str(b), hdr).append(*ROWS[0])
    lio.DataFile(str(a), hdr).append(*ROWS[0])
    assert a.read_bytes() == b.read_bytes()


def _fields(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_vtu_text_matches_lpfem(tmp_path, p):
    ls = LH1Space(lp_tank_finite(2, 1, 1), p)
    ps = H1Space(make_wave_tank_finite(2, 1, 1), p)
    lat = LatticeSpace((grid_lines(2, 12.0), grid_lines(1, 1.0),
                        grid_lines(1, 1.0 / (2 * np.pi))), p)
    np.testing.assert_array_equal(lat.elem_dofs, ls.elem_dofs)
    np.testing.assert_array_equal(lat.elem_node_coords, ls.elem_node_coords)
    f = _fields(ls.n_dofs, p)
    lio.write_vtu(str(tmp_path / "l.vtu"), ls, {"phi": f}, binary=False)
    ref = (tmp_path / "l.vtu").read_bytes()
    for name, sp, v in (("h1", ps, f), ("lat", lat, torch.tensor(f))):
        pio.write_vtu(str(tmp_path / f"{name}.vtu"), sp, {"phi": v},
                      binary=False)
        assert (tmp_path / f"{name}.vtu").read_bytes() == ref, name

    lsu, psu = LSurfaceSpace(ls, attr=2), SurfaceSpace(ps, attr=2)
    g = _fields(lsu.n_dofs, 10 + p)
    lio.write_vtu_surface(str(tmp_path / "ls.vtu"), lsu,
                          {"eta": g, "phi_fs": 2 * g}, binary=False)
    pio.write_vtu_surface(str(tmp_path / "ps.vtu"), psu,
                          {"eta": g, "phi_fs": 2 * torch.tensor(g)},
                          binary=False)
    assert (tmp_path / "ls.vtu").read_bytes() == \
        (tmp_path / "ps.vtu").read_bytes()


def test_periodic_lattice_vtu_matches_lpfem(tmp_path):
    """The seam element of an x-periodic tank ends at x = Lx in both."""
    ls = LH1Space(lp_tank(3, 1, 1), 2)
    lat = LatticeSpace((grid_lines(3, 1.0), grid_lines(1, 0.1),
                        grid_lines(1, 1.0 / (2 * np.pi))), 2,
                       (True, False, False))
    np.testing.assert_array_equal(lat.elem_dofs, ls.elem_dofs)
    f = _fields(ls.n_dofs, 3)
    lio.write_vtu(str(tmp_path / "l.vtu"), ls, {"phi": f}, binary=False)
    pio.write_vtu(str(tmp_path / "p.vtu"), lat, {"phi": f}, binary=False)
    assert (tmp_path / "l.vtu").read_bytes() == \
        (tmp_path / "p.vtu").read_bytes()


def test_paraview_collection_matches_lpfem(tmp_path):
    ps = H1Space(make_wave_tank_finite(2, 1, 1), 1)
    ls = LH1Space(lp_tank_finite(2, 1, 1), 1)
    f = _fields(ps.n_dofs, 0)
    lc = lio.ParaViewCollection(str(tmp_path / "l"), "run_vol")
    pc = pio.ParaViewCollection(str(tmp_path / "p"), "run_vol")
    for cycle, t in ((10, 0.125), (20, 0.25)):
        assert lc.save(cycle, t, lio.write_vtu, ls, {"phi": f},
                       binary=False) == pc.save(cycle, t, pio.write_vtu, ps,
                                                {"phi": f}, binary=False)
    for name in ("run_vol.pvd", "run_vol_000010.vtu", "run_vol_000020.vtu"):
        assert (tmp_path / "l" / "run_vol" / name).read_bytes() == \
            (tmp_path / "p" / "run_vol" / name).read_bytes()


def test_checkpoint_round_trip_is_exact(tmp_path):
    rng = np.random.default_rng(5)
    y = torch.tensor(rng.standard_normal(40))
    phi = torch.tensor(rng.standard_normal(300))
    path = str(tmp_path / "ck.npz")
    pio.save_checkpoint(path, step=7, t=0.1 + 0.2, y=y, phi=phi,
                        config="pf_linear_periodic")
    step, t, y2, phi2, meta = pio.load_checkpoint(path)
    assert (step, t) == (7, 0.1 + 0.2)
    np.testing.assert_array_equal(y2, y.numpy())
    np.testing.assert_array_equal(phi2, phi.numpy())
    assert str(meta["config"]) == "pf_linear_periodic"
    # lpfem reads the port's file, and the port lpfem's
    lstep, lt, ly, lphi, _ = lio.load_checkpoint(path)
    assert (lstep, lt) == (7, 0.1 + 0.2)
    np.testing.assert_array_equal(lphi, phi.numpy())
    lio.save_checkpoint(str(tmp_path / "l.npz"), step=3, t=0.5,
                        y=y.numpy(), phi=phi.numpy())
    step, t, y3, _, _ = pio.load_checkpoint(str(tmp_path / "l.npz"))
    assert (step, t) == (3, 0.5)
    np.testing.assert_array_equal(y3, y.numpy())

    # a double-single potential: saved as its float64 value, split again
    # on resume into the same pair
    x = ds_from_f64(torch.tensor(rng.standard_normal(300) * 1e3))
    pio.save_checkpoint(path, step=1, t=0.0, y=y, phi=x)
    _, _, _, phi_ds, _ = pio.load_checkpoint(path)
    np.testing.assert_array_equal(phi_ds, ds_to_f64(x).numpy())
    back = ds_from_f64(torch.as_tensor(phi_ds))
    assert isinstance(back, DS)
    assert torch.equal(back.hi, x.hi) and torch.equal(back.lo, x.lo)


def test_phase_timer_and_check_finite(tmp_path):
    # the phase timer is the program's record: spans (phases) record while
    # a profiler does, with calls and host and stream seconds
    rec = reset()
    for _ in range(3):
        with span("apply"):
            pass
    assert rec.table() == {}
    with trace(str(tmp_path / "tr0")):
        for _ in range(3):
            with span("apply"):
                pass
        with span("sum"):
            out = torch.sum(torch.arange(10.0))
    assert float(out) == 45.0
    assert {k: t.calls for k, t in rec.table().items()} == {"apply": 3,
                                                            "sum": 1}
    rep = rec.report().splitlines()
    assert rep[0].split() == ["span", "calls", "host[s]", "self[s]",
                              "stream[s]", "self[s]"]
    assert {r.split()[0] for r in rep[1:3]} == {"apply", "sum"}
    reset()

    check_finite("ok", np.ones(4), torch.zeros(3))
    with pytest.raises(FloatingPointError, match="bad: array 1 has 2/4"):
        check_finite("bad", np.ones(2),
                     torch.tensor([1.0, float("nan"), float("inf"), 2.0]))

    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(8) @ torch.ones(8)
    assert prof is not None
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
