"""lpfem_torch on a CUDA GPU: the hand-written kernels against their plain
PyTorch versions, and the time loops (the ss.cpp tank, the diffraction tank,
the leaning tanks of the general-mesh path) on the GPU against the same loops
on the CPU (where every apply takes the plain version).

Every test here needs a GPU and skips without one. This file imports neither
``jax`` nor ``lpfem``, so it runs on a machine without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: kernel vs plain relative to max|y| — float64 1e-13, float32
1e-5 (the float tolerance of ``tests/test_lattice_kernel.py:62``); the
kernel sums in the plain version's order but with fused multiply-adds.
The double-single kernel (B4) uses no contracted operation: bit for bit
against its plain version, 1e-13 (2-norm) against the float64 kernel.
GPU vs CPU trajectory: 1e-12 absolute (values are O(1e-3)), the bound the
port holds against the JAX reference; the float32 inner solves may sum dots
in another order, which moves their exits by at most one iteration per
inner pass. The shard modes of B1 and B2 (``-k shard``): against their
plain versions over 3 and 4 stacked windows at the tolerances above, twice
for the same bits; one sharded RK4 step against the single-device step on
the GPU, 1e-8 absolute (lpfem's dryrun bound). The element kernels at
p = 8..10 (``-k wide``), as at the lower orders. Two gloo ranks on the
GPU (``-k gloo``) against the stacked run, 1e-10 of max|y|. The spans'
stream markers (``-k spans``): CUDA events on the card's stream, under a
host and a device-only profile, with the answers bit for bit as untraced;
the details' markers only when asked for; a sharded problem built on the
host marks the card's stream. The fused Chebyshev coarse solve (``-k
coarse``) on the study's p = 1 level (8,730 dofs) against the eager chain
and its plain mirror on the card, 1e-12 of max|z| in float64 (1e-5 in
float32), alone and in a V-cycle of the p = 4 hierarchy; one launch a
coarse solve and no B3b launch at p = 1; a level past one cluster's shared
memory takes the eager route. B1 at p = 8 on the benchmark's order-8 tank
(``-k order8``, 1024 x 65 x 257): 1e-13 of max|y| in float64, 1e-6 in
float32, the same bits twice. B1's tensor-core route (``-k tensor_cores``,
p = 8 in float64 on DMMA) on edge lattices, the stationary tank and in
shard mode: 1e-13 of max|y|, the same bits twice, its launches counted.
The smoother's fused steps (``-k cheb``, ``kernels.cheb_step``): bit for
bit (``torch.equal``) the eager expressions on the card, on every smoothed
level of the refs-2 tank hierarchy and of the study's p = 4 and p = 2
levels, in float32 and float64, from zero and from a start vector; on
vectors of 1, 7, 5,440 and 38,017 values in each mode, also as views one
element in (all operands alike, and one alone); a stacked sharded V-cycle
against the same V-cycle with the eager smoother, 1e-12 of max|z| in
float64 and 1e-5 with the float32 inner hierarchy (the exchange's
scatter-adds sum in no fixed order); profiled, ``degree`` launches a
smoother call and no PyTorch elementwise kernel.
"""

import functools

import numpy as np
import pytest
import torch

import lpfem_torch
from lpfem_torch.cylmesh import make_half_cylinder_tank
from lpfem_torch.ds import DS, SeparableDS, ds_from_f64, ds_to_f64
from lpfem_torch.experiments.diffraction import build_problem
from lpfem_torch.experiments.leaning_tank import leaning_tank
from lpfem_torch.kernels import cheb_step as kcs
from lpfem_torch.kernels import coarse_cheb as kcc
from lpfem_torch.kernels import lattice_apply as klat
from lpfem_torch.kernels import pa_apply as kpa
from lpfem_torch.kernels import sep_apply as ksep
from lpfem_torch.kernels import sep_apply_ds as kds
from lpfem_torch.mesh import save_mfem
from lpfem_torch.multigrid import ChebyshevSmoother, PMultigrid
from lpfem_torch.operators import (AffineLatticeLaplace, ElementLaplace,
                                   SeparableLattice)
from lpfem_torch.space import CurvedLatticeSpace, LatticeSpace, grid_lines


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _space(periodic, p, nx=6):
    return LatticeSpace((grid_lines(nx, 1.0 if periodic else 12.0),
                         grid_lines(2, 0.1), grid_lines(3, 1 / (2 * np.pi))),
                        p, (periodic, False, False))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("periodic", [True, False])
def test_kernel_matches_plain_version(cuda, periodic, p, dtype, tol):
    """B1 at the orders compiled fixed (p = 1, 2, 4) and through the
    general instantiation (p = 3, 6), bitwise equal on a second call."""
    op = SeparableLattice(_space(periodic, p, nx=5), dtype, cuda)
    gen = torch.Generator(device=cuda).manual_seed(p)
    x = torch.randn(op.dof_dims[::-1], generator=gen, device=cuda,
                    dtype=dtype)
    for ess in (False, True):
        before = ksep.LAUNCHES
        y = ksep.sep_apply(x, op.bands, op.periodic, ess)
        assert ksep.LAUNCHES == before + 1
        assert torch.equal(y, ksep.sep_apply(x, op.bands, op.periodic, ess))
        y_ref = ksep.sep_apply_reference(x, op.bands, op.periodic, ess)
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max() / y_ref.abs().max())
        assert err < tol, (ess, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("dims,periodic", [("2p+1", True),
                                           ((267, 41, 19), True),
                                           ((267, 41, 19), False)])
def test_kernel_matches_plain_version_on_edge_lattices(cuda, dims, periodic,
                                                       p, dtype, tol):
    """B1 with random bands on Dx = 2p+1 (periodic: the tile's x halo wraps
    more than once) and on an odd Dx whose y and z extents are no
    multiples of the tiles (y split into two tiles)."""
    dims = (2 * p + 1, 3, 4) if dims == "2p+1" else dims
    gen = torch.Generator(device=cuda).manual_seed(10 + p)
    bands = tuple(torch.randn(2 * p + 1, D, generator=gen, device=cuda,
                              dtype=dtype)
                  for D in (dims[0], dims[0], dims[1], dims[1], dims[2],
                            dims[2]))
    x = torch.randn(dims[::-1], generator=gen, device=cuda, dtype=dtype)
    per = (periodic, False, False)
    for ess in (False, True):
        y = ksep.sep_apply(x, bands, per, ess)
        assert torch.equal(y, ksep.sep_apply(x, bands, per, ess))
        y_ref = ksep.sep_apply_reference(x, bands, per, ess)
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max() / y_ref.abs().max())
        assert err < tol, (ess, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_kernel_takes_a_view_that_is_not_16_byte_aligned(cuda, p, dtype, tol):
    """A contiguous view one element into its storage: the interior tiles'
    16-byte copies (p = 4; p = 2 in double) would be misaligned, so the
    kernel copies by element, to the same bits as on an aligned copy."""
    dims = (64, 9, 6)
    n = dims[0] * dims[1] * dims[2]
    gen = torch.Generator(device=cuda).manual_seed(20 + p)
    bands = tuple(torch.randn(2 * p + 1, D, generator=gen, device=cuda,
                              dtype=dtype)
                  for D in (dims[0], dims[0], dims[1], dims[1], dims[2],
                            dims[2]))
    x = torch.randn(n + 1, generator=gen, device=cuda,
                    dtype=dtype)[1:].view(dims[::-1])
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    for per in (True, False):
        y = ksep.sep_apply(x, bands, (per, False, False))
        y_ref = ksep.sep_apply_reference(x, bands, (per, False, False))
        y_aligned = ksep.sep_apply(x.clone(), bands, (per, False, False))
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max() / y_ref.abs().max())
        assert err < tol, (per, err)
        assert torch.equal(y, y_aligned)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", range(1, ksep.MAX_P + 1))
def test_entry_takes_the_wrappers_tiles_and_shared_memory(cuda, p, dtype):
    """Every order the wrapper accepts launches with the tiles and shared
    memory bytes that the Python side computes, and the C entry refuses
    bytes other than its own layout's."""
    dims = (2 * p + 3, 5, 4)
    gen = torch.Generator(device=cuda).manual_seed(30 + p)
    bands = tuple(torch.randn(2 * p + 1, D, generator=gen, device=cuda,
                              dtype=dtype)
                  for D in (dims[0], dims[0], dims[1], dims[1], dims[2],
                            dims[2]))
    x = torch.randn(dims[::-1], generator=gen, device=cuda, dtype=dtype)
    per = (True, False, False)
    y = ksep.sep_apply(x, bands, per)
    y_ref = ksep.sep_apply_reference(x, bands, per)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-13
    assert float((y - y_ref).abs().max() / y_ref.abs().max()) < tol
    itemsize = x.element_size()
    tiles = ksep.choose_tiles(dims, p, itemsize)
    smem = ksep.tile_smem_bytes(p, tiles, itemsize)
    for wrong in (smem - itemsize, smem + 4):
        rc = ksep._entry(dtype)(x.data_ptr(), y.data_ptr(),
                                *(c.data_ptr() for c in bands), *dims, p, 1,
                                0, *tiles, wrong,
                                torch.cuda.current_stream().cuda_stream)
        assert rc != 0, wrong


def _conv_tank(p):
    """The stationary study's tank (``experiments.laplace_conv``:
    ``make_wave_tank(8, 1, 2)``) at order p: 8p x (p+1) x (2p+1) dofs, x
    periodic."""
    return LatticeSpace((grid_lines(8, 1.0), grid_lines(1, 0.1),
                         grid_lines(2, 1 / (2 * np.pi))), p,
                        (True, False, False))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("p", [5, 7, 8, 9, 10])
@pytest.mark.parametrize("tank", ["laplace_conv", "periodic"])
def test_kernel_matches_plain_version_at_the_general_orders(cuda, tank, p,
                                                            dtype, tol):
    """B1 at the orders above 4 (the general instantiation, and p = 8's
    fixed one; the stationary p-sweep reaches them), on the study's tank
    and a periodic tank, bitwise equal on a second call."""
    sp = _conv_tank(p) if tank == "laplace_conv" else _space(True, p, nx=5)
    op = SeparableLattice(sp, dtype, cuda)
    gen = torch.Generator(device=cuda).manual_seed(100 + p)
    x = torch.randn(op.dof_dims[::-1], generator=gen, device=cuda,
                    dtype=dtype)
    for ess in (False, True):
        before = ksep.LAUNCHES_BY_P.get(p, 0)
        y = ksep.sep_apply(x, op.bands, op.periodic, ess)
        assert ksep.LAUNCHES_BY_P[p] == before + 1
        assert torch.equal(y, ksep.sep_apply(x, op.bands, op.periodic, ess))
        y_ref = ksep.sep_apply_reference(x, op.bands, op.periodic, ess)
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max() / y_ref.abs().max())
        assert err < tol, (ess, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-13)])
def test_kernel_at_p8_on_the_order8_tank(cuda, dtype, tol):
    """B1 at p = 8 on the top lattice of the benchmark's order-8 tank
    (1024 x 65 x 257, x periodic, ``ess_top``): against the plain version
    and bitwise equal on a second call, one launch counted at p = 8 (on
    the tensor-core route in float64 only)."""
    sp = LatticeSpace.from_config(lpfem_torch.preset(
        "scaling_base", order=8, ref_levels=2))
    assert sp.dof_dims == (1024, 65, 257)
    op = SeparableLattice(sp, dtype, cuda)
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(op.dof_dims[::-1], generator=gen, device=cuda,
                    dtype=torch.float64).to(dtype)
    before = ksep.LAUNCHES_BY_P.get(8, 0)
    tc = ksep.LAUNCHES_TC_BY_P.get(8, 0)
    y = ksep.sep_apply(x, op.bands, op.periodic, True)
    assert ksep.LAUNCHES_BY_P[8] == before + 1
    assert ksep.LAUNCHES_TC_BY_P.get(8, 0) == tc + (dtype == torch.float64)
    assert torch.equal(y, ksep.sep_apply(x, op.bands, op.periodic, True))
    y_ref = ksep.sep_apply_reference(x, op.bands, op.periodic, True)
    torch.cuda.synchronize()
    err = float((y - y_ref).abs().max() / y_ref.abs().max())
    assert err < tol, err


# B1's tensor-core route (p = 8 in float64): lattices whose y axis the
# route's 8-row tiles split, x periodic (Dx = 18: the tile's halo wraps)
# and finite (Dx = 13: past the ends, within one 16-column tile), each with
# and without ess_top; the stationary p = 8 tank (Dy = 9 < 16); the shard
# mode over 3 windows (a padded top slab) with each kind of scal row
TC_CASES = ([("lattice", dims, per, ess)
             for dims, per in (((18, 41, 5), True), ((13, 45, 4), False))
             for ess in (False, True)]
            + [("stationary", (64, 9, 17), True, ess) for ess in (False, True)]
            + [("shard", None, True, kind)
               for kind in ("constrained", "unconstrained", "own0 flipped")])


@pytest.mark.cuda
@pytest.mark.parametrize("case,dims,periodic,arg", TC_CASES)
def test_kernel_at_p8_on_the_tensor_cores(cuda, case, dims, periodic, arg):
    """``sep_tile_kernel<double, 8>`` (DMMA) against the plain version
    within 1e-13 of max|y|, the same bits on a second call, and each call
    one launch counted in ``LAUNCHES_TC_BY_P[8]``."""
    tc = ksep.LAUNCHES_TC_BY_P.get(8, 0)
    if case == "shard":
        lv, lv_cpu = _shard_level("sep", 3, 8, torch.float64, cuda)
        rng = np.random.default_rng(83)
        x = torch.tensor(rng.standard_normal((3, lv.N_max + 1)))
        x[:, lv.N_max] = 0.0
        p0 = torch.tensor(rng.standard_normal((3, lv.pt.win["plane"])))
        scal = lv.scal_o if arg == "unconstrained" else lv.scal_c.clone()
        if arg == "own0 flipped":
            scal[:, 1] = 1 - scal[:, 1]

        def run(l, s, xx, pp):
            return ksep.sep_apply_shard(xx, l.bands_xy, l.zbands, True, s,
                                        pp, l.dims)
        y, yh = run(lv, scal, x.to(cuda), p0.to(cuda))
        y2, yh2 = run(lv, scal, x.to(cuda), p0.to(cuda))
        assert torch.equal(y, y2) and torch.equal(yh, yh2)
        y_r, yh_r = run(lv_cpu, scal.cpu(), x, p0)
        scale = float(y_r.abs().max())
        assert float((y.cpu() - y_r).abs().max()) <= 1e-13 * scale
        assert float((yh.cpu() - yh_r).abs().max()) <= 1e-13 * scale
        assert not torch.any(y[:, lv.N_max])
    else:
        gen = torch.Generator(device=cuda).manual_seed(dims[1])
        if case == "stationary":
            op = SeparableLattice(_conv_tank(8), torch.float64, cuda)
            assert op.dof_dims == dims
            bands, per = op.bands, op.periodic
        else:
            bands = tuple(torch.randn(17, D, generator=gen, device=cuda,
                                      dtype=torch.float64)
                          for D in (dims[0], dims[0], dims[1], dims[1],
                                    dims[2], dims[2]))
            per = (periodic, False, False)
        x = torch.randn(dims[::-1], generator=gen, device=cuda,
                        dtype=torch.float64)
        y = ksep.sep_apply(x, bands, per, arg)
        assert torch.equal(y, ksep.sep_apply(x, bands, per, arg))
        y_ref = ksep.sep_apply_reference(x, bands, per, arg)
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max() / y_ref.abs().max())
        assert err < 1e-13, err
    assert ksep.LAUNCHES_TC_BY_P[8] == tc + 2


@pytest.mark.cuda
@pytest.mark.parametrize("p", [5, 10])
def test_laplace_conv_case_on_gpu_matches_cpu(cuda, p, monkeypatch):
    """One float64 case of the stationary p-sweep on the GPU (B1 at p and
    at the p-multigrid's lower orders) against the CPU (plain versions):
    the same dofs, iterations within one, and the solution vectors within
    1e-12 of max|x|. The error norms are compared (within 1e-6 relative)
    only at p <= 8: at p = 10 they sit at the float64 round-off floor
    (~2e-15), where they say nothing about agreement."""
    from lpfem_torch import solvers
    from lpfem_torch.analytic import AiryWave
    from lpfem_torch.experiments.laplace_conv import run_case
    from lpfem_torch.mesh import make_wave_tank
    pcg, xs = solvers.pcg, []

    def keep_x(*a, **k):
        res = pcg(*a, **k)
        xs.append(res.x.detach().cpu())
        return res

    monkeypatch.setattr(solvers, "pcg", keep_x)
    mesh = make_wave_tank(8, 1, 2)
    bb0, bb1 = mesh.bounding_box()
    wave = AiryWave.from_modes(H=0.005, m=2.0, Lx=1.0, h=bb1[2] - bb0[2],
                               z_top=bb1[2])
    before = ksep.LAUNCHES_BY_P.get(p, 0)
    g = run_case(mesh, p, wave, 1e-24, 2000, device=cuda)
    assert ksep.LAUNCHES_BY_P[p] > before
    c = run_case(mesh, p, wave, 1e-24, 2000, device="cpu")
    assert g["dofs"] == c["dofs"] and abs(g["iters"] - c["iters"]) <= 1
    xg, xc = xs
    assert xg.dtype == xc.dtype == torch.float64 and xg.shape == xc.shape
    scale = float(xc.abs().max())
    assert scale > 0
    diff = float((xg - xc).abs().max())
    assert diff <= 1e-12 * scale, (diff, scale)
    if p <= 8:
        for k in ("err_inf", "err_l2"):
            assert abs(g[k] - c[k]) <= 1e-6 * c[k], (k, g[k], c[k])


@pytest.mark.cuda
def test_kernel_wrappers_refuse_lattices_past_int32(cuda):
    """B1 and B4 index with 32-bit ints: a lattice of 2^31 dofs or more
    raises before any launch (2048 x 1025 x 1025 = 2,151,680,000)."""
    dims = (2048, 1025, 1025)
    x = torch.empty(dims[::-1], device=cuda, dtype=torch.float32)
    bands = tuple(torch.zeros(3, D, device=cuda, dtype=torch.float32)
                  for D in (dims[0], dims[0], dims[1], dims[1], dims[2],
                            dims[2]))
    before = ksep.LAUNCHES
    with pytest.raises(ValueError, match="int sizes"):
        ksep.sep_apply(x, bands, (True, False, False))
    assert ksep.LAUNCHES == before
    xl = torch.empty_like(x)
    ds_bands = tuple(DS(b, b) for b in bands)
    before = kds.LAUNCHES
    with pytest.raises(ValueError, match="int sizes"):
        kds.sep_apply_ds(x, xl, ds_bands, (True, False, False))
    assert kds.LAUNCHES == before
    del x, xl
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_kernel_wrapper_raises_instead_of_falling_back(cuda):
    op = SeparableLattice(_space(True, 2), torch.float32, cuda)
    x = torch.zeros(op.dof_dims[::-1], device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype and device"):
        ksep.sep_apply(x, op.bands, op.periodic)
    with pytest.raises(ValueError, match="dtype and device"):
        ksep.sep_apply(x.float(), tuple(b.cpu() for b in op.bands),
                       op.periodic)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "mixed"])
def test_gpu_run_matches_cpu_run(cuda, dtype):
    cfg = lpfem_torch.preset("scaling_base", nx=4, ny=2, nz=8, order=4,
                             precond="pmg", cg_rtol_sq=1e-20, dtype=dtype)
    cpu = lpfem_torch.Problem(cfg, device="cpu")
    gpu = lpfem_torch.Problem(cfg, device=cuda, lmax=cpu.precond.lmax)
    before = ksep.LAUNCHES
    _, y_g, phi_g = gpu.run(n_steps=3)
    assert ksep.LAUNCHES > before
    _, y_c, phi_c = cpu.run(n_steps=3)
    gpu.check_state(y_g, phi_g)
    assert float((y_g.cpu() - y_c).abs().max()) < 1e-12
    assert float((phi_g.cpu() - phi_c).abs().max()) < 1e-12
    sg, sc = gpu.last_solver_stats, cpu.last_solver_stats
    assert not sg.unconverged and sg.n_solves == sc.n_solves == 12
    if dtype == "float64":
        assert sg.total_iters == sc.total_iters


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("p,dq", [(1, 1), (2, 1), (3, 1), (4, 1), (2, 2),
                                  (5, 1)])
def test_element_kernel_matches_plain_version(cuda, p, dq, dtype, tol):
    """B3b on the small cylinder tank's real metric, and on random metric
    with an element count (37) that is no multiple of any block size, at
    q = p + dq: the orders compiled fixed (p = 1..4, q = p+1) and the
    general instantiation (q = p+2; p+1 = 6, an element over two warps)."""
    mesh = make_half_cylinder_tank(n_theta=12, n_r=6, nz=1, geom_order=p)
    op = ElementLaplace(CurvedLatticeSpace(mesh, p), dtype, cuda, q=p + dq)
    gen = torch.Generator(device=cuda).manual_seed(p)
    L, Q6 = (p + 1) ** 3, op.G6q.shape[1]
    cases = [(torch.randn(op.G6q.shape[0], L, generator=gen, device=cuda,
                          dtype=dtype), op.G6q),
             (torch.randn(37, L, generator=gen, device=cuda, dtype=dtype),
              torch.rand(37, Q6, generator=gen, device=cuda, dtype=dtype))]
    for u, G6q in cases:
        before = kpa.LAUNCHES
        ye = kpa.pa_apply_element(u, G6q, op.B, op.D)
        assert kpa.LAUNCHES == before + 1
        ye_ref = kpa.pa_apply_element_reference(u, G6q, op.B, op.D)
        torch.cuda.synchronize()
        err = float((ye - ye_ref).abs().max() / ye_ref.abs().max())
        assert err < tol, err


@pytest.mark.cuda
def test_element_kernel_wrapper_raises_instead_of_falling_back(cuda):
    mesh = make_half_cylinder_tank(n_theta=12, n_r=6, nz=1, geom_order=2)
    op = ElementLaplace(CurvedLatticeSpace(mesh, 2), torch.float32, cuda)
    u = torch.zeros(op.G6q.shape[0], 27, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype and device"):
        kpa.pa_apply_element(u, op.G6q, op.B, op.D)
    with pytest.raises(ValueError, match="do not fit"):
        kpa.pa_apply_element(u[:, :8].float().contiguous(), op.G6q, op.B,
                             op.D)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "mixed"])
def test_gpu_diffraction_step_matches_cpu(cuda, dtype):
    """One RK4 step of the study (three relaxation zones) on the small
    cylinder tank: GPU (B3b) against CPU (plain version), 1e-12. Both
    solve to r.z <= rz0 * 1e-24: at the mixed study's 1e-10 two runs whose
    float32 inner solves exit one iteration apart differ by ~1e-8, which
    says nothing of the kernel; the outer float64 refinement to 1e-24 takes
    both to the same solution."""
    kw = dict(order=2, n_theta=12, n_r=6, dr_max=0.0, nz=1, dtype=dtype,
              rtol_sq=1e-24)
    cpu = build_problem("cpu", **kw)
    gpu = build_problem(cuda, **kw, lmax=cpu.precond.lmax)
    before = kpa.LAUNCHES
    _, y_g, phi_g = gpu.run(n_steps=1)
    assert kpa.LAUNCHES > before
    _, y_c, phi_c = cpu.run(n_steps=1)
    gpu.check_state(y_g, phi_g)
    assert float((y_g.cpu() - y_c).abs().max()) < 1e-12
    assert float((phi_g.cpu() - phi_c).abs().max()) < 1e-12
    assert not gpu.last_solver_stats.unconverged
    assert gpu.last_solver_stats.n_solves == 4


TANK = dict(Lx=1.0, Ly=0.1, Lz=1 / (2 * np.pi))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("p,dq", [(1, 1), (2, 1), (3, 1), (4, 1), (2, 2),
                                  (5, 1)])
@pytest.mark.parametrize("nx", [6, 5])
def test_affine_kernels_match_plain_versions(cuda, nx, p, dq, dtype, tol):
    """B2 and B3a on a leaning periodic tank (nx = 5: an odd element count
    across the seam) at q = p + dq: the orders compiled fixed (p = 1..4,
    q = p+1) and the general instantiation (q = p+2; p+1 = 6, an element
    over two warps). Against their plain versions, B2 bitwise repeatable,
    and each call counted as a launch — a CUDA tensor never reaches the
    plain version."""
    space = CurvedLatticeSpace(leaning_tank(nx, 3, 3, **TANK), p)
    op = AffineLatticeLaplace(space, dtype, cuda, q=p + dq)
    gen = torch.Generator(device=cuda).manual_seed(p)
    x = torch.randn(op.n_dofs, generator=gen, device=cuda, dtype=dtype)
    args = (op.C6, op.w3, op.B, op.D, space.elem_dims, space.periodic)
    for ess in (False, True):
        before = klat.LAUNCHES
        y = klat.lattice_affine_apply(x, *args, ess)
        assert klat.LAUNCHES == before + 1
        assert torch.equal(y, klat.lattice_affine_apply(x, *args, ess))
        y_ref = klat.lattice_affine_apply_reference(x, *args, ess)
        torch.cuda.synchronize()
        assert float((y - y_ref).abs().max() / y_ref.abs().max()) < tol
    u = op.gather(x)
    before = kpa.LAUNCHES_AFFINE
    ye = kpa.pa_apply_affine(u, op.C6, op.w3, op.B, op.D)
    assert kpa.LAUNCHES_AFFINE == before + 1
    ye_ref = kpa.pa_apply_affine_reference(u, op.C6, op.w3, op.B, op.D)
    torch.cuda.synchronize()
    assert float((ye - ye_ref).abs().max() / ye_ref.abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 4])
def test_lattice_apply_is_two_kernels_and_no_memset_or_copy(cuda, p):
    """B2 calls, profiled: at most two kernels per call on the device and
    no memset or memcpy (ten calls after a spin kernel: the profiler can
    lose a window's first events)."""
    from torch.profiler import ProfilerActivity, profile
    space = CurvedLatticeSpace(leaning_tank(6, 3, 3, **TANK), p)
    op = AffineLatticeLaplace(space, torch.float32, cuda)
    x = torch.randn(op.n_dofs, device=cuda)
    op.constrained_apply_top(x)                      # build and load first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(2_000_000)      # the window's first events can drop
        for _ in range(10):
            op.constrained_apply_top(x)
        torch.cuda.synchronize()
    device = {e.key: e.count for e in prof.key_averages()
              if e.device_time_total > 0 and "spin_kernel" not in e.key}
    moves = [k for k in device if "memset" in k.lower() or "memcpy" in k.lower()]
    assert not moves, device
    assert 1 <= len(device) <= 2, device
    assert 1 <= sum(device.values()) <= 20, device
    assert all("lattice_affine" in k for k in device), device


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 4])
def test_sep_apply_is_one_kernel_and_no_memset_or_copy(cuda, p):
    """B1 calls, profiled: one kernel per call on the device and no memset
    or memcpy (ten calls after a spin kernel, as for B2)."""
    from torch.profiler import ProfilerActivity, profile
    op = SeparableLattice(_space(True, p, nx=8), torch.float32, cuda)
    x = torch.randn(op.space.n_dofs, device=cuda)
    op.constrained_apply_top(x)                      # build and load first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(2_000_000)      # the window's first events can drop
        for _ in range(10):
            op.constrained_apply_top(x)
        torch.cuda.synchronize()
    device = {e.key: e.count for e in prof.key_averages()
              if e.device_time_total > 0 and "spin_kernel" not in e.key}
    moves = [k for k in device if "memset" in k.lower() or "memcpy" in k.lower()]
    assert not moves, device
    assert len(device) == 1, device
    assert 1 <= sum(device.values()) <= 10, device
    assert all("sep_tile_kernel" in k for k in device), device


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("p,dq", [(8, 1), (9, 1), (10, 1), (7, 2), (10, 0)])
def test_element_kernels_at_the_wide_orders(cuda, p, dq, dtype, tol):
    """B3b on the small cylinder tank, B2 and B3a on a leaning tank, at
    p = 8..10 (the column body's second general instantiation, up to
    p+1 = q = 11, an element over four warps and, in double, more than
    48 KB of shared memory per block), against their plain versions, each
    call a launch, B2 bitwise repeatable."""
    mesh = make_half_cylinder_tank(n_theta=8, n_r=3, nz=1, geom_order=p)
    op = ElementLaplace(CurvedLatticeSpace(mesh, p), dtype, cuda, q=p + dq)
    gen = torch.Generator(device=cuda).manual_seed(p)
    u = torch.randn(op.G6q.shape[0], (p + 1) ** 3, generator=gen,
                    device=cuda, dtype=dtype)
    before = kpa.LAUNCHES_BY_P.get(p, 0)
    ye = kpa.pa_apply_element(u, op.G6q, op.B, op.D)
    assert kpa.LAUNCHES_BY_P[p] == before + 1
    ye_ref = kpa.pa_apply_element_reference(u, op.G6q, op.B, op.D)
    torch.cuda.synchronize()
    assert float((ye - ye_ref).abs().max() / ye_ref.abs().max()) < tol

    space = CurvedLatticeSpace(leaning_tank(3, 2, 2, **TANK), p)
    aop = AffineLatticeLaplace(space, dtype, cuda, q=p + dq)
    x = torch.randn(aop.n_dofs, generator=gen, device=cuda, dtype=dtype)
    args = (aop.C6, aop.w3, aop.B, aop.D, space.elem_dims, space.periodic)
    for ess in (False, True):
        y = klat.lattice_affine_apply(x, *args, ess)
        assert torch.equal(y, klat.lattice_affine_apply(x, *args, ess))
        y_ref = klat.lattice_affine_apply_reference(x, *args, ess)
        torch.cuda.synchronize()
        assert float((y - y_ref).abs().max() / y_ref.abs().max()) < tol
    ua = aop.gather(x)
    before = kpa.LAUNCHES_AFFINE_BY_P.get(p, 0)
    ye = kpa.pa_apply_affine(ua, aop.C6, aop.w3, aop.B, aop.D)
    assert kpa.LAUNCHES_AFFINE_BY_P[p] == before + 1
    ye_ref = kpa.pa_apply_affine_reference(ua, aop.C6, aop.w3, aop.B, aop.D)
    torch.cuda.synchronize()
    assert float((ye - ye_ref).abs().max() / ye_ref.abs().max()) < tol


@pytest.mark.cuda
def test_element_kernels_refuse_p11(cuda):
    B = torch.zeros(12, 12, device=cuda)
    u = torch.zeros(2, 12 ** 3, device=cuda)
    with pytest.raises(ValueError, match="<= 11"):
        kpa.pa_apply_element(u, torch.zeros(2, 6 * 12 ** 3, device=cuda),
                             B, B)


@pytest.mark.cuda
def test_affine_wrappers_raise_instead_of_falling_back(cuda):
    space = CurvedLatticeSpace(leaning_tank(6, 2, 2, **TANK), 2)
    op = AffineLatticeLaplace(space, torch.float32, cuda)
    x = torch.zeros(op.n_dofs, device=cuda, dtype=torch.float64)
    args = (op.w3, op.B, op.D, space.elem_dims, space.periodic)
    with pytest.raises(ValueError, match="dtype and device"):
        klat.lattice_affine_apply(x, op.C6, *args)
    with pytest.raises(ValueError, match="dtype and device"):
        klat.lattice_affine_apply(x.float(), op.C6.cpu(), *args)
    with pytest.raises(ValueError, match="dofs, expected"):
        klat.lattice_affine_apply(x.float()[:-1].contiguous(), op.C6, *args)
    u = torch.zeros(op.C6.shape[0], 27, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype and device"):
        kpa.pa_apply_affine(u, op.C6, op.w3, op.B, op.D)
    with pytest.raises(ValueError, match="C6 of shape"):
        kpa.pa_apply_affine(u.float(), op.C6[:-1].contiguous(), op.w3, op.B,
                            op.D)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "mixed"])
@pytest.mark.parametrize("path", ["A", "B"])
def test_gpu_general_mesh_run_matches_cpu_run(cuda, path, dtype, tmp_path):
    """Three RK4 steps of path A (leaning along z, lattice declared: B2) and
    of path B (leaning along y, through a mesh file: B3a) on the GPU against
    the CPU, 1e-12 (both solve to r.z <= rz0 * 1e-20, the float64 outer
    loop's reach in mixed precision)."""
    kw = dict(order=4, dtype=dtype, precond="pmg", cheb_degree=4,
              cg_rtol_sq=1e-20, cg_max_iter=300, nsteps=40,
              wave_by="wavelength", wave_lambda=0.5)
    if path == "A":
        mesh = leaning_tank(6, 2, 2, **TANK, lean="z")
        cfg = lpfem_torch.preset("scaling_base", **kw)
        counter = lambda: klat.LAUNCHES                       # noqa: E731
    else:
        mesh = None
        save_mfem(leaning_tank(6, 2, 2, **TANK, lean="y", declare=False),
                  str(tmp_path / "y.mesh"))
        cfg = lpfem_torch.preset("scaling_base", **kw, mesh_kind="mfem",
                                 mesh_file=str(tmp_path / "y.mesh"),
                                 ref_levels=1)
        counter = lambda: kpa.LAUNCHES_AFFINE                 # noqa: E731
    cpu = lpfem_torch.Problem(cfg, device="cpu", mesh=mesh)
    gpu = lpfem_torch.Problem(cfg, device=cuda, mesh=mesh,
                              lmax=cpu.precond.lmax)
    before = counter()
    _, y_g, phi_g = gpu.run(n_steps=3)
    assert counter() > before
    _, y_c, phi_c = cpu.run(n_steps=3)
    gpu.check_state(y_g, phi_g)
    assert float((y_g.cpu() - y_c).abs().max()) < 1e-12
    assert float((phi_g.cpu() - phi_c).abs().max()) < 1e-12
    assert not gpu.last_solver_stats.unconverged
    assert gpu.last_solver_stats.n_solves == 12


@pytest.mark.cuda
@pytest.mark.parametrize("p,periodic", [(1, True), (2, True), (3, False),
                                        (4, False), (6, True)])
def test_ds_kernel_matches_plain_version_and_float64(cuda, p, periodic):
    op = SeparableLattice(_space(periodic, p, nx=5), torch.float64, cuda)
    dsop = SeparableDS(op)
    gen = torch.Generator(device=cuda).manual_seed(p)
    x = ds_from_f64(torch.randn(op.dof_dims[::-1], generator=gen,
                                device=cuda, dtype=torch.float64))
    for ess in (False, True):
        before = kds.LAUNCHES
        y = kds.sep_apply_ds(x.hi, x.lo, dsop.bands, op.periodic, ess)
        assert kds.LAUNCHES == before + 1
        y_ref = kds.sep_apply_ds_reference(x.hi, x.lo, dsop.bands,
                                           op.periodic, ess)
        torch.cuda.synchronize()
        assert torch.equal(y.hi, y_ref.hi) and torch.equal(y.lo, y_ref.lo)
        y64 = ksep.sep_apply(ds_to_f64(x), op.bands, op.periodic, ess)
        rel = float(torch.linalg.norm(ds_to_f64(y) - y64)
                    / torch.linalg.norm(y64))
        assert rel < 1e-13, (ess, rel)


def _ds_bands(dims, p, gen, device):
    """Random float64 bands for the lattice ``dims`` and their DS pairs."""
    b64 = tuple(torch.randn(2 * p + 1, D, generator=gen, device=device,
                            dtype=torch.float64)
                for D in (dims[0], dims[0], dims[1], dims[1], dims[2],
                          dims[2]))
    return tuple(ds_from_f64(b) for b in b64), b64


def _same(a, b):
    return torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("dims,periodic", [("2p+1", True),
                                           ((267, 41, 19), True),
                                           ((267, 41, 19), False)])
def test_ds_kernel_matches_plain_version_on_edge_lattices(cuda, dims,
                                                          periodic, p):
    """B4 with random bands on Dx = 2p+1 (periodic, narrower than a tile
    below p = 4) and on an odd Dx whose y and z extents are no multiples of
    the tiles (y split into two tiles): bit for bit with the plain version,
    the same bits on a second call, 1e-13 (2-norm) of float64 B1."""
    dims = (2 * p + 1, 3, 4) if dims == "2p+1" else dims
    gen = torch.Generator(device=cuda).manual_seed(40 + p)
    dsb, b64 = _ds_bands(dims, p, gen, cuda)
    x = ds_from_f64(torch.randn(dims[::-1], generator=gen, device=cuda,
                                dtype=torch.float64))
    per = (periodic, False, False)
    for ess in (False, True):
        y = kds.sep_apply_ds(x.hi, x.lo, dsb, per, ess)
        assert _same(y, kds.sep_apply_ds(x.hi, x.lo, dsb, per, ess))
        assert _same(y, kds.sep_apply_ds_reference(x.hi, x.lo, dsb, per,
                                                   ess))
        y64 = ksep.sep_apply(ds_to_f64(x), b64, per, ess)
        rel = float(torch.linalg.norm(ds_to_f64(y) - y64)
                    / torch.linalg.norm(y64))
        assert rel < 1e-13, (ess, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 2, 4])
def test_ds_kernel_takes_views_that_are_not_16_byte_aligned(cuda, p):
    """Contiguous views one element into their storage, of one stream or
    both: the interior tiles' 16-byte copies (p = 2, 4) would be
    misaligned, so the kernel copies by value, to the bits of the plain
    version and of an aligned copy."""
    dims = (64, 9, 6)
    n = dims[0] * dims[1] * dims[2]
    gen = torch.Generator(device=cuda).manual_seed(50 + p)
    dsb, _ = _ds_bands(dims, p, gen, cuda)
    buf = ds_from_f64(torch.randn(n + 1, generator=gen, device=cuda,
                                  dtype=torch.float64))
    sh = dims[::-1]
    off = DS(buf.hi[1:].view(sh), buf.lo[1:].view(sh))
    on = DS(buf.hi[:-1].view(sh), buf.lo[:-1].view(sh))
    assert off.hi.data_ptr() % 16 and off.lo.data_ptr() % 16
    for xh, xl in ((off.hi, on.lo), (on.hi, off.lo), (off.hi, off.lo)):
        for per in ((True, False, False), (False, False, False)):
            y = kds.sep_apply_ds(xh, xl, dsb, per)
            assert _same(y, kds.sep_apply_ds_reference(xh, xl, dsb, per))
            assert _same(y, kds.sep_apply_ds(xh.clone(), xl.clone(), dsb,
                                             per))


@pytest.mark.cuda
@pytest.mark.parametrize("p", range(1, kds.MAX_P + 1))
def test_ds_entry_takes_the_wrappers_tiles_and_shared_memory(cuda, p):
    """Every order the wrapper accepts launches with the tiles and shared
    memory bytes that the Python side computes (bit for bit with the plain
    version), and the C entry refuses other bytes and other tile widths."""
    dims = (2 * p + 3, 5, 4)
    gen = torch.Generator(device=cuda).manual_seed(60 + p)
    dsb, _ = _ds_bands(dims, p, gen, cuda)
    x = ds_from_f64(torch.randn(dims[::-1], generator=gen, device=cuda,
                                dtype=torch.float64))
    per = (True, False, False)
    y = kds.sep_apply_ds(x.hi, x.lo, dsb, per, True)
    assert _same(y, kds.sep_apply_ds_reference(x.hi, x.lo, dsb, per, True))
    tiles = kds.choose_ds_tiles(dims, p)
    smem = kds.ds_tile_smem_bytes(p, tiles)
    ptrs = [c.data_ptr() for band in dsb for c in band]
    stream = torch.cuda.current_stream().cuda_stream
    for t, bytes_ in ((tiles, smem - 4), (tiles, smem + 16),
                      ((4, *tiles[1:]), smem)):
        rc = kds._entry()(x.hi.data_ptr(), x.lo.data_ptr(), y.hi.data_ptr(),
                          y.lo.data_ptr(), *ptrs, *dims, p, 1, 1, *t,
                          bytes_, stream)
        assert rc != 0, (t, bytes_)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 4])
def test_ds_apply_is_one_kernel_and_no_memset_or_copy(cuda, p):
    """B4 calls through ``SeparableDS``, profiled: one kernel per call on
    the device and no memset or memcpy (ten calls after a spin kernel, as
    for B1)."""
    from torch.profiler import ProfilerActivity, profile
    dsop = SeparableDS(SeparableLattice(_space(True, p, nx=8), torch.float64,
                                        cuda))
    gen = torch.Generator(device=cuda).manual_seed(p)
    x = ds_from_f64(torch.randn(int(np.prod(dsop.dof_dims)), generator=gen,
                                device=cuda, dtype=torch.float64))
    dsop.constrained_apply_top(x)                    # build and load first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(2_000_000)      # the window's first events can drop
        for _ in range(10):
            dsop.constrained_apply_top(x)
        torch.cuda.synchronize()
    device = {e.key: e.count for e in prof.key_averages()
              if e.device_time_total > 0 and "spin_kernel" not in e.key}
    moves = [k for k in device if "memset" in k.lower() or "memcpy" in k.lower()]
    assert not moves, device
    assert len(device) == 1, device
    assert 1 <= sum(device.values()) <= 10, device
    assert all("ds_tile_kernel" in k for k in device), device


@pytest.mark.cuda
def test_ds_kernel_wrapper_raises_instead_of_falling_back(cuda):
    dsop = SeparableDS(SeparableLattice(_space(True, 2), torch.float64,
                                        cuda))
    x = torch.zeros(dsop.dof_dims[::-1], device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        kds.sep_apply_ds(x, x, dsop.bands, dsop.periodic)
    cpu_bands = tuple(DS(b.hi.cpu(), b.lo.cpu()) for b in dsop.bands)
    with pytest.raises(ValueError, match="device"):
        kds.sep_apply_ds(x.float(), x.float(), cpu_bands, dsop.periodic)


@pytest.mark.cuda
def test_gpu_ds_run_matches_cpu_run(cuda):
    """Three RK4 steps with the double-single outer loop on the GPU (B4)
    against the CPU (its plain version), 1e-12, both solved to
    r.z <= rz0 * 1e-20."""
    cfg = lpfem_torch.preset("scaling_base", nx=4, ny=2, nz=8, order=4,
                             precond="pmg", cg_rtol_sq=1e-20, dtype="mixed",
                             hi_apply="ds")
    cpu = lpfem_torch.Problem(cfg, device="cpu")
    gpu = lpfem_torch.Problem(cfg, device=cuda, lmax=cpu.precond.lmax)
    before = kds.LAUNCHES
    _, y_g, phi_g = gpu.run(n_steps=3)
    assert kds.LAUNCHES > before
    _, y_c, phi_c = cpu.run(n_steps=3)
    gpu.check_state(y_g, phi_g)
    assert isinstance(phi_g, DS)
    assert float((y_g.cpu() - y_c).abs().max()) < 1e-12
    assert float((ds_to_f64(phi_g).cpu() - ds_to_f64(phi_c)).abs().max()) \
        < 1e-12
    assert not gpu.last_solver_stats.unconverged
    assert gpu.last_solver_stats.n_solves == 12


# ---------------------------------------------------------- the shard modes
def _shard_level(kind, ndev, p, dtype, device):
    """A sharded level (B1's or B2's shard mode) of a small tank on
    ``device`` and its CPU twin."""
    from lpfem_torch.shard import Partition, ShardComm, ShardedLevel
    if kind == "sep":
        sp = LatticeSpace((grid_lines(4, 1.0), grid_lines(2, 0.1),
                           grid_lines(8, 1 / (2 * np.pi))), p,
                          (True, False, False))
        make = lambda dev: SeparableLattice(sp, dtype, dev)  # noqa: E731
    else:
        sp = CurvedLatticeSpace(leaning_tank(4, 2, 8, 1.0, 0.1,
                                             1 / (2 * np.pi), lean="z"), p)
        make = lambda dev: AffineLatticeLaplace(sp, dtype, dev)  # noqa: E731
    pt = Partition(sp, ndev)
    ess = sp.top_plane_dofs()
    return [ShardedLevel(make(dev), pt, ess, ShardComm(ndev), dev)
            for dev in (device, "cpu")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("ndev", [3, 4])
@pytest.mark.parametrize("kind", ["sep", "affine"])
def test_shard_kernels_match_plain_versions(cuda, kind, ndev, p, dtype, tol):
    """B1's and B2's shard modes on stacked windows (3 shards: a padded
    top slab) against their plain versions, for the constrained and the
    unconstrained rows and with own0 flipped; twice on one input for the
    same bits."""
    if kind == "affine" and p == 4:
        p = 3
    lv, lv_cpu = _shard_level(kind, ndev, p, dtype, cuda)
    assert lv.mode == kind
    rng = np.random.default_rng(10 * p + ndev)
    x = torch.tensor(rng.standard_normal((ndev, lv.N_max + 1))).to(dtype)
    x[:, lv.N_max] = 0.0
    p0 = torch.tensor(rng.standard_normal((ndev, lv.pt.win["plane"]))).to(
        dtype)
    w = lv.pt.win
    flip = lv.scal_c.clone()
    flip[:, 1] = 1 - flip[:, 1]
    for scal in (lv.scal_c, lv.scal_o, flip):
        if kind == "sep":
            def run(l, s, xx, pp):
                return ksep.sep_apply_shard(xx, l.bands_xy, l.zbands,
                                            w["periodic"][0], s, pp, l.dims)
        else:
            def run(l, s, xx, pp):
                return klat.lattice_affine_apply_shard(
                    xx, l.C6, l.w3, l.B, l.D, w["dims"],
                    (w["periodic"][0], False, False), s, pp)
        y, yh = run(lv, scal, x.to(cuda), p0.to(cuda))
        y2, yh2 = run(lv, scal, x.to(cuda), p0.to(cuda))
        assert torch.equal(y, y2) and torch.equal(yh, yh2)
        y_r, yh_r = run(lv_cpu, scal.cpu(), x, p0)
        scale = float(y_r.abs().max())
        assert float((y.cpu() - y_r).abs().max()) <= tol * scale
        assert float((yh.cpu() - yh_r).abs().max()) <= tol * scale
        assert not torch.any(y[:, lv.N_max])


@pytest.mark.cuda
@pytest.mark.parametrize("ndev", [3, 4])
def test_sharded_step_on_gpu_matches_single_device(cuda, ndev):
    """One sharded RK4 step (window layout, p-multigrid with h-levels,
    mixed) on the GPU against the single-device step on the GPU, 1e-8 on
    max|y| (the bound of lpfem's dryrun); B1's shard mode launched."""
    from lpfem_torch.shard import ShardedProblem
    cfg = lpfem_torch.preset("scaling_base", nx=8, ny=2, nz=8, order=4,
                             nsteps=4, cg_rtol_sq=1e-24, cg_max_iter=400,
                             precond="pmg", h_coarsen_min_dofs=0,
                             dtype="mixed")
    prob = lpfem_torch.Problem(cfg, cuda)
    sp = ShardedProblem(prob, ndev)
    n0 = ksep.LAUNCHES_SHARD
    _, y, phi = sp.run(n_steps=1)
    sp.check_state(y, phi)
    assert ksep.LAUNCHES_SHARD > n0
    _, y1, _ = prob.run(n_steps=1)
    assert float((y - y1).abs().max()) < 1e-8


@pytest.mark.cuda
def test_gloo_ranks_on_gpu_match_stacked(cuda, tmp_path):
    """Two gloo ranks on the one GPU (``lpfem_torch.dist``: one process per
    shard, the exchange staged through the host) against the stacked
    two-shard run on the GPU from the same state and bounds, two float64
    steps: y and phi within 1e-10 of max|y| / max|phi|, the running maximum
    of the CG iterations equal after every step, B1's shard mode launched
    on every rank, and no child process left."""
    from lpfem_torch import dist
    from lpfem_torch.shard import ShardedProblem
    kw = dict(nx=8, ny=2, nz=8, order=4, cg_rtol_sq=1e-24, cg_max_iter=400,
              precond="pmg", h_coarsen_min_dofs=0)
    st = ShardedProblem.from_config(lpfem_torch.preset("scaling_base", **kw),
                                    2, device=cuda)
    its = []
    _, y, phi = st.run(n_steps=2, record=lambda t, y, aux: its.append(
        aux.stats.max_iters))
    res = dist.run_spec({"preset": "scaling_base", "config": kw, "steps": 2,
                         "device": "cuda", "lmax": st.pmg.lmax}, 2, tmp_path,
                        timeout=600)
    y, phi = y.cpu().numpy(), st.phi_global(phi)
    assert np.abs(res["y"] - y).max() <= 1e-10 * np.abs(y).max()
    assert np.abs(res["phi"] - phi).max() <= 1e-10 * np.abs(phi).max()
    for r in res["ranks"]:
        assert r["max_iters_per_step"] == its
        assert r["launches"]["sep_apply_shard"] > 0
    assert dist.live_descendants() == []


@pytest.mark.cuda
def test_spans_mark_the_stream(cuda):
    from torch.profiler import ProfilerActivity, profile

    from lpfem_torch import profiling
    cfg = lpfem_torch.preset("scaling_base", nx=8, nz=2, ref_levels=0,
                             order=4, dtype="mixed", precond="pmg",
                             cg_rtol_sq=1e-16, cheb_degree=4)
    prob = lpfem_torch.Problem(cfg, device=cuda)
    y0, phi0 = prob.initial_state()
    _, y_off, phi_off = prob.run(n_steps=2, state=(y0.clone(), phi0.clone()))
    rec = profiling.record()
    assert rec.table() == {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _, y_on, phi_on = prob.run(n_steps=2,
                                   state=(y0.clone(), phi0.clone()))
    assert torch.equal(y_on, y_off) and torch.equal(phi_on, phi_off)
    assert rec.device.type == "cuda"
    tab = rec.table()
    assert rec.steps == 2 and not rec._pending
    step = tab["timestep.step"]
    # every span's stream time inside the steps', the self times summing
    # to the steps' (one stream, nested markers); the details unmarked
    assert step.stream > 0.0
    assert abs(sum(t.stream_self for t in tab.values()) - step.stream) \
        <= 1e-6 * step.stream
    for name in ("surface.solve", "solvers.cg_iteration",
                 "multigrid.vcycle", "solvers.apply", "multigrid.coarse"):
        assert 0.0 < tab[name].stream < step.stream
    assert all(t.stream_self > -1e-5 for t in tab.values())
    assert tab["solvers.exit_test"].stream == 0.0
    assert tab["multigrid.L0.presmooth"].calls > 0
    assert tab["multigrid.L0.presmooth"].stream == 0.0
    # a device-only profile turns the spans on as well
    with profile(activities=[ProfilerActivity.CUDA]):
        prob.run(n_steps=1, state=(y0.clone(), phi0.clone()))
    assert rec.steps == 3 and rec.totals("timestep.step").stream > \
        step.stream
    assert rec.first(2).totals("timestep.step") == step
    # the details marked on request
    profiling.mark_details(True)
    try:
        rec = profiling.reset()
        with profile(activities=[ProfilerActivity.CUDA]):
            prob.run(n_steps=1, state=(y0.clone(), phi0.clone()))
    finally:
        profiling.mark_details(False)
    tab = rec.table()
    assert 0.0 < tab["multigrid.L0.presmooth"].stream < \
        tab["multigrid.vcycle"].stream
    assert abs(sum(t.stream_self for t in tab.values())
               - tab["timestep.step"].stream) <= \
        1e-6 * tab["timestep.step"].stream


@pytest.mark.cuda
def test_spans_of_a_sharded_problem_mark_the_card(cuda):
    """``ShardedProblem.from_config`` builds its ``Problem`` on the host; the
    steps it runs on the card put the record's markers there."""
    from torch.profiler import ProfilerActivity, profile

    from lpfem_torch import profiling
    from lpfem_torch.shard import ShardedProblem
    cfg = lpfem_torch.preset("scaling_base", nx=8, ny=2, nz=4, order=2,
                             precond="pmg", h_coarsen_min_dofs=0)
    sp = ShardedProblem.from_config(cfg, 2, device=cuda)
    with profile(activities=[ProfilerActivity.CUDA]):
        sp.run(n_steps=1)
    rec = profiling.record()
    assert rec.device.type == "cuda" and rec.steps == 1
    tab = rec.table()
    assert 0.0 < tab["solvers.cg_iteration"].stream < \
        tab["timestep.step"].stream


@functools.lru_cache(maxsize=None)
def _study_mesh():
    from lpfem_torch.experiments.diffraction import study_mesh
    return study_mesh()


def _study_pmg(p, dtype, **kw):
    """PMultigrid on the study tank at order ``p`` on the card."""
    op = ElementLaplace(CurvedLatticeSpace(_study_mesh(), p), dtype, "cuda")
    return PMultigrid(op, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_coarse_cheb_matches_eager_chain(cuda, dtype, tol):
    """The study's p = 1 level (8,730 dofs) alone: the fused route, one
    launch, against the eager Chebyshev-16 it was built from."""
    pm = _study_pmg(1, dtype)
    assert pm.coarse_route == "fused" and pm.levels[-1].op.n_dofs == 8730
    cc = pm.coarse_solve
    assert isinstance(cc, kcc.CoarseChebyshev) and cc.degree == 16
    lv = pm.levels[-1]
    gen = torch.Generator(device="cpu").manual_seed(3)
    r = torch.randn(lv.op.n_dofs, generator=gen, dtype=torch.float64)
    r = r.to(device=cuda, dtype=dtype) * lv.free
    z = cc(r)
    for z_ref in (cc.chebyshev(r), kcc.coarse_cheb_mirror(r, cc)):
        rel = float((z - z_ref).abs().max() / z_ref.abs().max())
        assert rel < tol, rel
    assert torch.equal(cc(r), z)                  # no atomics: the same bits


@pytest.mark.cuda
def test_fused_coarse_vcycle_matches_eager_route_and_counts_one_launch(cuda):
    """One V-cycle of the study's p = 4 hierarchy in float64 with the fused
    coarse solve against the same hierarchy with the eager one, 1e-12; the
    fused V-cycle makes one coarse launch and no B3b launch at p = 1."""
    pm = _study_pmg(4, torch.float64)
    assert pm.orders == [4, 2, 1] and pm.coarse_route == "fused"
    n = pm.levels[0].op.n_dofs
    gen = torch.Generator(device="cpu").manual_seed(4)
    r = torch.randn(n, generator=gen, dtype=torch.float64).to(cuda) \
        * pm.levels[0].free
    before, by_p = dict(kcc.LAUNCHES), dict(kpa.LAUNCHES_BY_P)
    z = pm(r)
    torch.cuda.synchronize()
    assert kcc.LAUNCHES["float64"] == before.get("float64", 0) + 1
    grew = {p: c - by_p.get(p, 0) for p, c in kpa.LAUNCHES_BY_P.items()}
    assert grew.get(1, 0) == 0 and grew[4] > 0 and grew[2] > 0
    pm.coarse_solve = pm.coarse_solve.chebyshev
    z_ref = pm(r)
    assert kpa.LAUNCHES_BY_P[1] > by_p.get(1, 0)  # the eager chain: B3b p=1
    rel = float((z - z_ref).abs().max() / z_ref.abs().max())
    assert rel < 1e-12, rel


@pytest.mark.cuda
def test_coarse_route_falls_back_past_the_budget(cuda):
    """A p = 1 curved level past one cluster's shared memory (35,328
    elements, 45,355 dofs) keeps the eager Chebyshev-16."""
    from lpfem_torch.experiments.diffraction import study_mesh
    op = ElementLaplace(CurvedLatticeSpace(study_mesh(n_theta=192, nz=4), 1),
                        torch.float64, cuda)
    assert (op.space.elem_dofs.shape[0], op.n_dofs) == (35328, 45355)
    pm = PMultigrid(op, h_coarsen_min_dofs=10 ** 9)
    assert pm.coarse_route == "chebyshev"
    assert not kcc.fits(35328, 45355, 1, 2, torch.float64, op.fold.shape[1])


def _eager_chebyshev(sm, r, z0=None):
    """The smoother's eager expressions as they were before each step
    became one launch (frozen; ``tests/test_torch_multigrid.py`` holds the
    same copy)."""
    A, invD = sm.apply_fn, sm.inv_diag
    theta, delta = sm.theta, sm.delta
    if z0 is None:
        res = r
        z = torch.zeros_like(r)
    else:
        z = z0
        res = r - A(z)
    sigma = theta / delta
    rho = 1.0 / sigma
    d = invD * res / theta
    z = z + d
    for _ in range(sm.degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * (invD * (r - A(z)))
        z = z + d
        rho = rho_new
    return z


@functools.lru_cache(maxsize=None)
def _tank_refs2_pmg(dtype):
    """The refs-2 tank's p-multigrid at order 4 (Chebyshev-4), as the
    benchmark's ``ss_tank_p4.refs2`` builds it."""
    sp = LatticeSpace.from_config(lpfem_torch.preset(
        "scaling_base", order=4, ref_levels=2))
    return PMultigrid(SeparableLattice(sp, dtype, "cuda"), smooth_degree=4)


def _rand(n, seed, dtype, device):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(n, generator=gen, dtype=torch.float64).to(
        device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["zero", "z0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("hierarchy", ["tank_refs2", "study"])
def test_cheb_fused_smoother_equals_eager_chain(cuda, hierarchy, dtype,
                                                start):
    """Every smoothed level: the tank's 2,179,584 / 282,880 / 38,016 dofs
    (B1 at p = 4, 2, 1), the study's p = 4 and p = 2 (B3b)."""
    if hierarchy == "tank_refs2":
        pm = _tank_refs2_pmg(dtype)
        assert [lv.op.n_dofs for lv in pm.levels[:-1]] == [2179584, 282880,
                                                           38016]
    else:
        pm = _study_pmg(4, dtype)
        assert pm.orders == [4, 2, 1]
    for i, (lv, sm) in enumerate(zip(pm.levels[:-1], pm.smoothers)):
        r = _rand(lv.op.n_dofs, i, dtype, cuda) * lv.free
        z0 = (None if start == "zero"
              else _rand(lv.op.n_dofs, 10 + i, dtype, cuda) * lv.free)
        r_in = r.clone()
        before = kcs.LAUNCHES_BY_DTYPE.get(str(dtype)[6:], 0)
        z = sm(r, z0=z0)
        assert kcs.LAUNCHES_BY_DTYPE[str(dtype)[6:]] == before + sm.degree
        z_ref = _eager_chebyshev(sm, r, z0)
        assert torch.equal(z, z_ref), (i, float((z - z_ref).abs().max()))
        assert torch.equal(r, r_in)


def _step_operands(n, dtype, device, offset):
    """The operands of a step on ``n`` values, each a view ``offset[k]``
    elements into its own buffer."""
    names = ["r", "Az", "inv_diag", "d", "z", "z0"]
    ops = {}
    for k, name in enumerate(names):
        buf = _rand(n + 1, 20 + k, dtype, device)
        if name == "inv_diag":
            buf = buf.abs() + 0.5
        ops[name] = buf[offset[k]:offset[k] + n]
    return ops


@pytest.mark.cuda
@pytest.mark.parametrize("views", ["aligned", "all one in", "r one in"])
@pytest.mark.parametrize("n", [1, 7, 5440, 38017])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cheb_step_kernel_equals_eager_expressions(cuda, dtype, n, views):
    """Each mode on its own, against the eager expressions; the vector
    form with a scalar head and tail, and the scalar form where one operand
    is off by another amount."""
    offset = {"aligned": [0] * 6, "all one in": [1] * 6,
              "r one in": [1, 0, 0, 0, 0, 0]}[views]
    # a theta whose float32 reciprocal differs as rounded from double and
    # as taken in float: the eager division takes the first
    theta = 1.5121337882677715
    c1, c2 = kcc.chebyshev_coefficients(theta, 1.2, 4)[1]
    for mode in ("zero", "z0", "step"):
        o = _step_operands(n, dtype, cuda, offset)
        r, Az, invD, z0 = o["r"], o["Az"], o["inv_diag"], o["z0"]
        d, z = o["d"], o["z"]
        before = kcs.LAUNCHES
        if mode == "zero":
            d_ref = invD * r / theta
            z_ref = torch.zeros_like(r) + d_ref
            kcs.cheb_first(r, invD, theta, d, z)
        elif mode == "z0":
            d_ref = invD * (r - Az) / theta
            z_ref = z0 + d_ref
            kcs.cheb_first(r, invD, theta, d, z, z0=z0, Az0=Az)
        else:
            d_ref = c1 * d + c2 * (invD * (r - Az))
            z_ref = z + d_ref
            kcs.cheb_step(r, Az, invD, d, z, c1, c2)
        assert kcs.LAUNCHES == before + 1
        assert torch.equal(d, d_ref), (mode, float((d - d_ref).abs().max()))
        assert torch.equal(z, z_ref), (mode, float((z - z_ref).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("mixed", 1e-5)])
def test_cheb_sharded_vcycle_matches_eager_smoother(cuda, dtype, tol,
                                                    monkeypatch):
    """One V-cycle of the sharded p-multigrid over 4 stacked windows (its
    h-levels and Chebyshev-16 coarse solve included) with the fused
    smoother steps against the same V-cycle with the eager ones."""
    from lpfem_torch.shard import ShardedProblem
    cfg = lpfem_torch.preset("scaling_base", nx=8, ny=2, nz=8, order=4,
                             precond="pmg", h_coarsen_min_dofs=0,
                             dtype=dtype)
    sp = ShardedProblem(lpfem_torch.Problem(cfg, cuda), 4)
    pm = sp.pmg
    assert len(pm.levels) > 3 and pm.coarse_solve.degree == 16
    lv = pm.levels[0]
    r = sp.stack_state(_rand(sp.prob.op.n_dofs, 5, torch.float64, "cpu")
                       .numpy()).to(lv.invd.dtype) * lv.free
    before = kcs.LAUNCHES
    z = pm(r)
    launched = kcs.LAUNCHES - before
    assert launched == (2 * sum(s.degree for s in pm.smoothers[:-1])
                        + pm.coarse_solve.degree)
    monkeypatch.setattr(ChebyshevSmoother, "__call__", _eager_chebyshev)
    z_ref = pm(r)
    assert kcs.LAUNCHES == before + launched
    rel = float((z - z_ref).abs().max() / z_ref.abs().max())
    assert rel < tol, rel


# Profiles one case in a fresh process: within a process that has already
# profiled, torch.profiler delivers device records left from before the
# window and loses some of the window's own (seen on the H100 after this
# file's earlier profiles)
_CHEB_PROFILE = r"""
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
import lpfem_torch
from lpfem_torch.kernels import cheb_step as kcs
from lpfem_torch.multigrid import PMultigrid
from lpfem_torch.operators import SeparableLattice
from lpfem_torch.space import LatticeSpace

what, calls = sys.argv[1], 5
sp = LatticeSpace.from_config(lpfem_torch.preset(
    "scaling_base", order=4, ref_levels=2))
pm = PMultigrid(SeparableLattice(sp, torch.float64, "cuda"), smooth_degree=4)
gen = torch.Generator().manual_seed(6)
lv, sm = pm.levels[1], pm.smoothers[1]
r = torch.randn(lv.op.n_dofs, generator=gen, dtype=torch.float64).cuda() \
    * lv.free
r0 = torch.randn(pm.levels[0].op.n_dofs, generator=gen,
                 dtype=torch.float64).cuda() * pm.levels[0].free
sm(r, z0=sm(r))
pm(r0)                                              # build and load first
torch.cuda.synchronize()
before = kcs.LAUNCHES
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    torch.cuda._sleep(2_000_000)    # the window's first events can drop
    for _ in range(calls):
        if what == "smoother":
            sm(r, z0=sm(r))
        else:
            pm(r0)
    torch.cuda.synchronize()
print(json.dumps(dict(
    device={e.key: e.count for e in prof.key_averages()
            if e.device_time_total > 0 and "spin_kernel" not in e.key},
    launched=kcs.LAUNCHES - before, calls=calls, degree=sm.degree,
    smoothed=len(pm.levels) - 1)))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["smoother", "vcycle"])
def test_cheb_smoother_is_degree_launches_and_no_elementwise(cuda, what):
    """Profiled in a fresh process: a smoother call on a B1 level (the
    refs-2 tank's p = 2) is ``degree`` launches of the step kernel beside
    its applies, with no PyTorch elementwise kernel, memset or copy; a
    V-cycle of the refs-2 tank makes ``degree`` step launches for each
    smoothed level and smoother call. The counter and the profiler
    agree."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    out = subprocess.run([sys.executable, "-c", _CHEB_PROFILE, what],
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    device, calls, degree = res["device"], res["calls"], res["degree"]
    steps = sum(c for k, c in device.items() if "cheb_step_kernel" in k)
    assert res["launched"] == steps, device
    if what == "smoother":
        assert steps == calls * 2 * degree, device
        assert all("cheb_step_kernel" in k or "sep_tile_kernel" in k
                   for k in device), device
        applies = sum(c for k, c in device.items() if "sep_tile_kernel" in k)
        assert applies == calls * (2 * degree - 1), device
    else:
        assert steps == calls * res["smoothed"] * 2 * degree, device
