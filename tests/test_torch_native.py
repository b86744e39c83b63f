"""The port's native host library (``lpfem_torch/native.py`` over its copy
of ``lpfem/native``'s sources) against lpfem's on the CPU.

- ``build_hex_dofs`` integer-equal to ``lpfem.native.build_hex_dofs`` on a
  mesh below and one above the 2,000,000-entry threshold; ``H1Space``'s ids
  equal lpfem's on both sides of it (NumPy below, native above), the
  column renumbering of a z-extruded mesh above it included.
- The binary-appended VTU of a volume and a surface field, byte for byte
  lpfem's ``write_vtu(..., binary=True)``.
- The library raises instead of switching to NumPy: without g++, and on a
  file it cannot parse.
"""

import numpy as np
import pytest
import torch

from lpfem import io as lio
from lpfem import native as lnative
from lpfem.mesh import make_wave_tank_finite as lp_finite
from lpfem.space import H1Space as LH1Space
from lpfem.space import SurfaceSpace as LSurfaceSpace

from lpfem_torch import io as pio
from lpfem_torch import native
from lpfem_torch.experiments.leaning_tank import leaning_tank
from lpfem_torch.kernels import _build
from lpfem_torch.mesh import Mesh, make_wave_tank_finite
from lpfem_torch.space import NATIVE_MIN_ENTRIES, H1Space, SurfaceSpace

from test_torch_meshspace import TANK, to_lpfem

# (nx, ny, nz, p): 48 x 125 entries (NumPy in the space) and 2,048 x 1,000
# = 2,048,000 (> 2,000,000: native in the space)
MESHES = {"below": (4, 3, 4, 4), "above": (16, 8, 16, 9)}


@pytest.mark.parametrize("side", ["below", "above"])
def test_build_hex_dofs_matches_lpfem_native(side):
    nx, ny, nz, p = MESHES[side]
    m = make_wave_tank_finite(nx, ny, nz)
    assert (m.n_elems * (p + 1) ** 3 > NATIVE_MIN_ENTRIES) == (side == "above")
    ed, n = native.build_hex_dofs(m.elems, m.n_verts, p)
    ed_l, n_l = lnative.build_hex_dofs(m.elems, m.n_verts, p)
    assert n == n_l
    np.testing.assert_array_equal(ed, ed_l)


@pytest.mark.parametrize("side", ["below", "above"])
def test_space_ids_match_lpfem(side):
    """The topological numbering (detections off, as on an unstructured
    import) equals lpfem's on either side of the threshold."""
    nx, ny, nz, p = MESHES[side]
    sp = H1Space(make_wave_tank_finite(nx, ny, nz), p, structured=False)
    sl = LH1Space(lp_finite(nx, ny, nz), p, structured=False)
    assert sp.n_dofs == sl.n_dofs
    np.testing.assert_array_equal(sp.elem_dofs, sl.elem_dofs)


def test_extruded_ids_match_lpfem_above_the_threshold():
    """A z-extruded mesh without a lattice (a tank leaning along y, 4,096
    hexes at p = 7: 2,097,152 entries) numbered natively, then on its
    columns: lpfem's ids."""
    m = leaning_tank(16, 8, 32, **TANK, lean="y")
    m = Mesh(m.verts, m.elems, m.corner_coords, m.bdr_quads, m.bdr_attrs,
             m.periodic, periodic_axes=m.periodic_axes)
    assert m.n_elems * 8 ** 3 > NATIVE_MIN_ENTRIES
    sp, sl = H1Space(m, 7), LH1Space(to_lpfem(m), 7)
    assert sp.extruded is not None and sl.extruded is not None
    np.testing.assert_array_equal(sp.elem_dofs, sl.elem_dofs)


@pytest.mark.parametrize("kind", ["volume", "surface"])
def test_binary_vtu_matches_lpfem(kind, tmp_path):
    ps = H1Space(make_wave_tank_finite(2, 1, 1), 3)
    ls = LH1Space(lp_finite(2, 1, 1), 3)
    rng = np.random.default_rng(3)
    if kind == "volume":
        f = rng.standard_normal(ls.n_dofs)
        lio.write_vtu(str(tmp_path / "l.vtu"), ls, {"phi": f}, binary=True)
        pio.write_vtu(str(tmp_path / "p.vtu"), ps, {"phi": torch.tensor(f)})
    else:
        lsu, psu = LSurfaceSpace(ls, attr=2), SurfaceSpace(ps, attr=2)
        g = rng.standard_normal(lsu.n_dofs)
        lio.write_vtu_surface(str(tmp_path / "l.vtu"), lsu,
                              {"eta": g, "phi_fs": 2 * g}, binary=True)
        pio.write_vtu_surface(str(tmp_path / "p.vtu"), psu,
                              {"eta": g, "phi_fs": 2 * g})
    ref = (tmp_path / "l.vtu").read_bytes()
    assert b'format="appended"' in ref
    assert (tmp_path / "p.vtu").read_bytes() == ref


def test_library_raises_without_compiler_or_input(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", "")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.load_host_library("lpfem_native_probe", ("dofs.cpp",))
    with pytest.raises(OSError, match="cannot parse"):
        native.parse_gmsh(str(tmp_path / "missing.msh"))
    with pytest.raises(ValueError, match="expected \\[ne, 8\\]"):
        native.build_hex_dofs(np.zeros((2, 4), dtype=np.int64), 4, 2)
