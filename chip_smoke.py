"""Drive the PyTorch port's paths once on one NVIDIA GPU and check them.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Device and build: require CUDA, print the card's name and power limit
   (nvidia-smi), build the CUDA kernels from ``lpfem_torch/csrc`` (one nvcc
   per source, all started together: B1 and its shard mode, B2 and its
   shard mode, B3a / B3b, B4) and the native host library (g++), and print
   the build time and ptxas's report (registers, spills) per kernel.
2. Kernels vs plain versions on the card, relative to max|y|: double
   <= 1e-13, float <= 1e-5.
   - ``sep_apply`` (B1, one fused launch per apply; float and double) against
     ``sep_apply_reference``, and twice on one input for bitwise equality:
     p = 1, 2, 4, 8 (compiled fixed) and 3, 5..7, 9, 10 (the general
     instantiation) on periodic and non-periodic tanks, and on the
     stationary study's tank (8p x (p+1) x (2p+1), the lattices phase 8
     runs) at every p = 1..10
     with its device time, plain time and bound per order; p = 1, 2, 3, 4,
     6 on edge lattices with random bands
     (Dx = 2p+1 periodic; an odd Dx with Dy and Dz no multiples of the
     tiles), ess_top on and off; the four p-multigrid lattices of the
     ss.cpp path and the four of path C. At the ss.cpp lattices: device time
     per apply from torch.profiler, each kernel's mean per recorded launch,
     the activities per call (one kernel, no memset or copy), per call the
     median of 5 chains of 30 applies timed with CUDA events, the bound per
     order, and the cuSPARSE SpMV of the assembled matrix at p = 4
     (assembled on the card from the element matrices of the same tank),
     p = 2 and p = 1 with B1's ratio to it. At p = 8 on the order-8
     tank's top lattice (1024 x 65 x 257, the benchmark cell
     ``tank_p8.f64_refs2``), float64 and float32: checked, device time,
     time per call, plain time, and the bound of ``benchmark.costs``; the
     launches of the tensor-core route (DMMA, ``LAUNCHES_TC_BY_P[8]``:
     every float64 launch, no float32 one) and ptxas's registers and
     spills of ``sep_tile_kernel<double, 8>``.
   - ``pa_apply_element`` (B3b, on the column body; float and double) on
     the small cylinder tank at p = 1..4 with q = p+1 (compiled fixed) and
     (p, q) = (2, 4), (5, 6) (the general instantiation), real and random
     symmetric positive definite metric, and the three p-multigrid levels
     of the diffraction tank with both metrics, against
     ``pa_apply_element_reference``; per level the time of the kernel alone
     (device time from torch.profiler, the activities per call, and per
     call from CUDA events, inputs rotated over more than the 50 MB L2), of
     the full apply (gather + kernel + scatter), of the plain version, and
     of the cuSPARSE SpMV of the assembled operator.
   - ``pa_apply_affine`` (B3a) and ``lattice_affine_apply`` (B2) on sheared
     tanks (float and double; p = 1, 2, 3, 4 with q = p+1, the orders the
     kernels compile fixed, and q = p+2 and p+1 = 6, the general
     instantiation; periodic x with an even and an odd element count and
     non-periodic x; odd ney, nez; ess_top on and off; random symmetric
     positive definite ``C6`` and the real one) against their plain
     versions; B2 also against ``ElementLaplace`` with the full metric on
     the same mesh, and twice on one input for bitwise equality. Then the
     three p-multigrid lattices of path A (32,768 leaning hexes): times as
     for B3b, the device activities per call (torch.profiler over the
     timed calls: B2 at most two kernels, B3a one, neither a memset or
     copy; and each kernel's mean time per launch), B2 beside the
     three-step route it fuses (gather + B3a + fold) and beside B1 on the
     unsheared lattice of the same size, and the cuSPARSE SpMV of the
     assembled operator at every level, with B2's ratio to it.
   - ``sep_apply_ds`` (B4, one fused launch per apply) on double-single
     pairs of random float64 values (normal, and with magnitudes spread
     over 1e-8..1e8) against ``sep_apply_ds_reference``, bit for bit (and
     <= 1e-14 of max|y|), twice on one input for the same bits, and against
     float64 B1 on the pair's value, <= 1e-13 relative in the 2-norm
     (float32 B1's error printed beside it): p = 1, 2, 4 (compiled fixed)
     and 3, 6 (the general instantiation) on periodic and finite x, an odd
     Dx, edge lattices with random bands (Dx = 2p+1 periodic, narrower than
     a tile below p = 4; an odd Dx with Dy and Dz no multiples of the
     tiles), a view of both streams 4 bytes into their storage (the same
     bits as an aligned copy), ess_top on and off, and the ss.cpp fine
     lattice, the only level the DS outer loop runs at. There: device and
     per-call time, the activities per call (one kernel, no memset or
     copy), the plain version's time, the bound (bytes, and the float32
     instructions counted from the kernel at the card's issue rate), and
     float64 B1 and its cuSPARSE SpMV as the comparators (no PyTorch call
     computes a double-single apply).
3. The ss.cpp path: ``Problem(cfg, device="cuda")`` on the reference's
   strong-scaling protocol (``scaling_base``, 2 refinements, order 4, mixed
   precision, r.z <= rz0*1e-16, maxit 300, p-multigrid, Chebyshev degree 4;
   512 x 33 x 129 = 2,179,584 dofs), one warm-up step, then 10 RK4 steps =
   40 Laplace solves with the launch counts set to 0 just before and read
   just after (B1 calls per RK4 step by order p printed). Requires a finite
   state, every solve converged and sep_apply launches in the run. Then the accuracy check on the same configuration:
   one wave period in 40 RK4 steps must end with the nodal eta error
   (``eta_error_inf(quad=False)``) below 0.1 H. (The protocol's dt = T/10 is
   beyond RK4's stability limit for the fastest discrete free-surface modes
   at this resolution, in the JAX reference as here; its error is printed
   only.)
4. The wave-cylinder diffraction path at full width: the study's
   ``Problem`` (``lpfem_torch.experiments.diffraction.build_problem``: the
   polar half-cylinder tank, 4,224 curved hexes, 340,725 dofs at order 4,
   three relaxation zones), 10 RK4 steps = 40 Laplace solves at the study's
   dt = T/35 in float64, then the same 10 steps in mixed precision (depth
   cut from one period, 35 steps, to make room for phase 5; the width is the
   study's), each with the launch counts set to 0 just before and read
   just after (B3b calls per RK4 step by order p printed). Requires every
   solve converged, a finite state, B3b launches in both runs, 0 < max|eta|
   < H, and the mixed run's final eta within 1e-2 max|eta| of the float64
   run's; the p-multigrid's coarse route ``"fused"`` in both runs and
   ``coarse_cheb`` launches, by dtype, equal to the run's V-cycles (calls
   of ``PMultigrid``; float32 in the mixed run), which in the float64 run
   are its CG iterations plus its solves.
5. The general-mesh path, launch counts set to 0 just before each run and
   read just after; every solve must converge and the state stay finite:
   - A: the ss.cpp tank meshed with leaning elements (``x += a z``, element
     lattice declared; 32,768 hexes, 2,179,584 dofs, settings of phase 3,
     the wave given by its wavelength): ``Problem(cfg, "cuda", mesh=...)``
     must pick the fused affine lattice operator (B2) on every level; one
     period in 40 RK4 steps; requires B2 launches, nodal eta error < 0.1 H
     and within a factor 10 of phase 3's on the unsheared tank.
   - B: the tank leaning the other way (``x += a y``) written as an MFEM
     mesh file at 512 hexes and run as ``Problem(preset(...,
     mesh_kind="mfem", mesh_file=..., ref_levels=...), "cuda")``: the
     topological space finds no lattice but the z-extrusion, so the operator
     is the affine element kernel (B3a) inside gather / fold; one period in
     40 steps; requires B3a launches and nodal eta error < 0.1 H. Prints the
     host set-up seconds.
   Paths A and B print their B2 / B3a calls per RK4 step by element order
   p (the wrappers' ``LAUNCHES_BY_P`` / ``LAUNCHES_AFFINE_BY_P``).
   - C: the unsheared tank written and loaded the same way must come out on
     the Kronecker operator (B1) and, after 4 RK4 steps, agree with the
     generated tank's run to 1e-12 (B1 calls per RK4 step by order p
     printed).

6. The double-single outer loop: phase 3's configuration with
   ``hi_apply="ds"`` and phase 3's lmax (``fso._ds_op`` must be set): a cold
   solve that must converge; one warm-up step, then 10 RK4 steps = 40
   solves with the launch counts set to 0 just before and read just after
   (requires sep_apply_ds launches, every solve converged, a finite state;
   B4 calls per RK4 step and B4 kernels in the profiled step printed);
   the 40-step accuracy run, whose nodal eta error must stay below 0.1 H,
   within 1 % of phase 3's and whose eta within 1e-5 max|eta| of phase 3's.

7. The bench twin (``lpfem_torch.bench.bench_once``, what ``python -m
   lpfem_torch.bench`` runs) on the ss.cpp tank, launch counts set to 0
   just before each row and read just after: refs 2 with the full protocol
   (a warm-up step, then 10 RK4 steps, median of 3) and its float32 /
   rtol_sq 1e-8 secondary row, refs 1 and 3 with one repeat, refs 4
   (135,530,496 dofs) as set-up, a warm-up and one timed RK4 step. Requires
   each size's dofs, converged cold solves, 8 cold iterations at refs 2,
   B1 launches and value = dofs x 4 x steps / wall; prints each row's JSON,
   set-up seconds and peak device and host memory.
8. The drivers, each with the launch counts set to 0 just before and read
   just after: ``laplace_conv --mode p`` (p = 1..10) in float64 and mixed
   (tables in ``chiprun_out/``) must have ``data/laplace-pconv-phi.txt``'s
   dofs, err_inf within 1.5x of it at p <= 8 and at most 1e-13 at p = 9,
   10, and B1 launched at every p; ``pf_conv`` at p = 4 over 150 steps
   within 1.5x of ``data/pf-parallel-pconv-eta.txt``; ``pf_run`` of the
   flagship in 40 steps with ParaView output every 10 (20 steps over its
   5 T diverge), then resumed from the checkpoint of its step 20 to the
   same bits; ``entry()``'s step against the CPU's, 1e-10.

9. The sharded path (``lpfem_torch.shard``: shards stacked on one tensor
   axis of the card), each part with the launch counts set to 0 just
   before and read just after its run:
   - 9a: B1's shard mode (``sep_apply_shard``, one launch over every
     window) on the refs 2 z-slab windows over 4 shards ([4, 33, 33, 512]
     at p = 4) and 3 (11, 11, 10 layers: a padded top slab, [3, 45, 33,
     512]) at p = 4, 2, 1, and B2's (``lattice_affine_apply_shard``) at
     p = 4 on the leaning tank's windows, float and double, the rows
     ``(zt, own0)`` of the constrained and the unconstrained apply and with
     own0 flipped, against their plain versions (phase 2's ``TOL``) and
     twice for the same bits; the sharded apply through the exchange
     against the unsharded kernel on one global vector (``TOL``). At 4
     shards: device ms per launch, kernels per apply, the bound, the plain
     version's ms, the apply through the exchange, and at p = 4 in float
     the cuSPARSE SpMV of the windows' block-diagonal matrix (assembled on
     the card from element matrices).
   - 9b: one RK4 step at refs 2, order 4, mixed, p-multigrid with an
     h-level, r.z <= rz0*1e-24, over 4 and over 3 shards against the
     single-device step: max|y| difference <= 1e-8 of max|y|. Then the
     ss.cpp protocol over 4 shards with ``CFG`` from
     ``ShardedProblem.from_config`` (set-up on the host): a cold solve (its
     iterations beside the single-device 8), a warm-up step, 10 steps
     timed 3 times (median; every stage converged; B1-shard launches by
     order; peak device memory) and one profiled step.
   - 9c: phase 5A's leaning tank over 4 shards, one step against the
     single-device step (1e-8 of max|y|); B2's shard mode must launch.
   - 9d: ``dryrun_multichip(4)``; ``python -m
     lpfem_torch.experiments.scaling --mode strong --shards 1 2 4 --orders
     4 --par-ref 2 --precond pmg --repeats 1`` (table in ``chiprun_out/``;
     the cold iterations must be the same at every shard count); the
     diffraction study with ``--shard 4`` for 2 steps against the same
     run unsharded (rim envelope within 1e-8), B3b launched.

10. The modules of slice 10, each part with the launch counts set to 0
    just before and read just after its run:
   - 10a: the element kernels at p = 8, 9, 10 (the column body's second
     general instantiation): B3b on the diffraction tank's 4,224 curved
     hexes, B3a and B2 (ess_top) on phase 5A's leaning tank cut to one
     refinement (4,096 hexes, 4.2M dofs at p = 10; phase 5A runs 32,768),
     float and double, against their plain versions (``TOL``) and twice for
     the same bits, with the device ms per launch, the bound and the plain
     version's ms; then one float64 RK4 step at each order on each: B3b on
     the small cylinder tank, B2 on a 6 x 2 x 2 leaning tank with its
     lattice, B3a on the same tank without it (each kernel launched at p).
   - 10b: the study tank's linear corners as a Gmsh v2.2 file (4,224 hexes,
     attributes 1, 2, 3) in ``chiprun_out/``, the native and the Python
     parsers integer-equal, ``set_curvature(4)`` with the rim snapped
     (within 1e-12 of the circle), and ``diffraction --gmsh`` for 2 steps
     at 340,725 dofs in float64 (B3b by order, set-up, wall per step,
     0 < max|eta| < H, the envelope VTU written in the binary format).
   - 10c: ``pf_linear_par`` (36 x 1 x 1, order 4, 180 steps over 5 T,
     float64) with ``apply_mode="assembled"`` against ``"pallas"``: final
     eta within 1e-9 of max|eta|; the ss.cpp tank at refs 2 in float64:
     the assembly (nonzeros, seconds, peak and held device memory), the
     SpMV's ms beside B1's float64 (phase 2), and 2 RK4 steps assembled
     against the PA run (state within 1e-9 of max|y|, the same CG
     iterations).
   - 10d: ``pf_linear_par`` assembled over 4 shards: the ELL level's apply
     within 1e-12 relative of the assembled operator's, one step within
     1e-10 of max|y| of one card's.
   - 10e: path B's set-up seconds (phase 5B, native numbering), the binary
     VTU of the refs 2 and refs 1 volume and the ASCII one of refs 1 (bytes
     and seconds; ASCII at refs 2, ~8x refs 1's, is left out for time).
   - 10f: ``pf_run --glvis-every`` to a listener thread on localhost: the
     bytes received equal ``glvis.solution_text`` of the final state.
   - 10g: ``apply_bench --cylinder`` (three numberings, B3b launched) and
     ``diffraction --apply-mode sumfact --quick`` at its dt for 12 of its 60
     steps (no B3b launch) against the same run in the default mode (rim
     envelope within 1e-8).

11. Shards as processes (``lpfem_torch.dist``: one gloo rank per shard on
    the one card, launched, timed out, killed and reaped by
    ``run_ranks``; each rank builds ``ShardedProblem.from_config`` with
    a ``shard.GroupComm`` and keeps its row; the exchange staged through
    the host), each rank's launch counts set to 0 just before its run and
    read just after:
   - 11a: 9b's tank (refs 2, order 4, mixed, p-multigrid, 2,179,584 dofs)
     at r.z <= rz0*1e-20 and dt = T/40 (phase 3's accuracy run: the
     protocol's T/10 grows the state, so valid runs drift apart) over 4
     ranks for 2 steps against the stacked 4-shard run from the same state
     with the same smoother bounds: y and the global potential within
     1e-10 of max|y| / max|phi|, the per-step maximum iterations within one
     per outer pass, B1-shard launched (summed over the ranks); prints the
     set-up seconds per rank, the wall per step beside the stacked run's
     and the host-staged exchange's share of it (CUDA events from each
     collective's copy to the host to its copy back) and one shift alone
     (host clock, device synchronised), beside its two copies alone and
     gloo alone on host tensors.
   - 11b: 9c's leaning tank over 3 ranks for 1 step, the same check,
     B2-shard launched.
   After 11a, after phase 11 and just before the kernels line the script
   lists its live descendants (``/proc/<pid>/task/*/children``,
   recursively) and fails if there is one; a failed rank fails the run
   after its siblings are reaped.

12. The fused Chebyshev coarse solve (``kernels.coarse_cheb``, one
    thread-block cluster a solve) on the diffraction study, as phase 4
    builds it in mixed precision (the float32 preconditioner) and in
    float64: the p-multigrid must take the ``"fused"`` route; on its p = 1
    level (8,730 dofs) the kernel within 1e-5 (float32) / 1e-12 (float64)
    of max|z| of the eager Chebyshev-16 and of its plain mirror
    (``coarse_cheb_mirror``) on the card, and the same bits twice. Then in
    float64: device ms per coarse solve (median of 5 chains of
    30 solves, CUDA events; and torch.profiler's device time with the
    activities per solve) beside the eager chain's; the device activities
    per V-cycle with the fused and with the eager coarse solve; ptxas's
    registers and spills (phase 1) and the shared-memory bytes of the
    layout; the kernel's launches equal to the V-cycles over 3 RK4 steps;
    the untraced step wall with the fused and the eager coarse solve
    (fused, eager, eager, fused; the same iterations) and the coarse's
    share of the eager step it gives; and no launch in phase 3's tank
    (dense coarse route).

13. The smoother's steps in one launch each (``kernels.cheb_step``) on
    vectors of 17,105,920 and 2,179,584 values (the top levels of
    ``tank_p8.f64_refs2`` / refs 3 and of refs 2), float32 and float64:
    each mode (the first step from zero and from a start vector, the
    recurrence step) bit for bit the eager expressions
    (``cheb_first_reference``, ``cheb_step_reference``) on the card; per
    mode the kernel's device ms (torch.profiler, the activities per call)
    and its ms per call from CUDA events (5 chains of 30), the eager
    chain's device ms and kernels, the byte bound (each operand read once,
    ``d`` and ``z`` written once, at 3.35 TB/s) and the kernel's achieved
    bytes per second. Then a whole Chebyshev-4 smoother call on the
    order-8 tank's top level (B1 at p = 8, float64), from zero and from a
    start vector, fused against the eager chain: the same bits, device ms
    and kernels a call.

Phases 3, 4 (float64), 5A, 5B, 6 and 9b each profile one more RK4 step with
torch.profiler, outside the timed window: device kernel time by category and
the device's busy share. Each phase's own time is printed.

Prints one JSON line describing the kernels (B1's ``orders_on_path``: the
orders phases 7-8 launched it at; B2's, B3a's and B3b's: the orders phases
4, 5, 10a and 10b launched them at, with their p = 8..10 rows under
``wide_orders``; the shard modes' ``launches`` from 9b's and 9c's runs,
and ``launches_under_ranks`` from 11a's and 11b's; ``coarse_cheb``'s
``launches`` and ``launches_by_dtype`` from phase 4's two runs, beside
their V-cycles),
then as the last line
``{"ok": true, "device": {...}}``. Details also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

CFG = dict(ref_levels=2, order=4, dtype="mixed", cg_rtol_sq=1e-16,
           cg_max_iter=300, precond="pmg", cheb_degree=4)
N_STEPS = 10
ACCURACY_STEPS = 40            # dt = T/40: inside RK4's stability limit
EXPECTED_COLD_ITERS = 8        # data/bench-scales.txt (the JAX reference)
CYL_STEPS = 10                 # of the 35 per period at the study's dt = T/35
CYL_DOFS = 340_725
LEAN = dict(wave_by="wavelength", wave_lambda=0.5)   # Lx / wave_m
PATH_B_REF_LEVELS = 2          # 512 -> 32,768 hexes, 2,179,584 dofs
PATH_C_STEPS = 4
KERNEL_SOURCES = ("sep_apply", "pa_apply", "lattice_apply", "sep_apply_ds",
                  "coarse_cheb", "cheb_step")
CHAIN = 30
TOL = {"float32": 1e-5, "float64": 1e-13}
# The float64 cuSPARSE yardstick at p=4 multiplies a matrix assembled from
# element matrices, which sums in another order than B1's Kronecker bands.
# Its gap to B1 read 1.0e-13 to 1.3e-13 of max|y| over nine inputs, and
# 3.3e-8 with the matrix's values rounded to float32 (_element_csr_readings
# prints both on every run; NVIDIA H100, PERF.md section 7)
ELEMENT_CSR_TOL_F64 = 1e-12
SMALL_ORDERS = ((1, 2), (2, 3), (3, 4), (4, 5), (2, 4), (5, 6))   # (p, q)
DS_TOL_PLAIN = 1e-14           # B4 vs its plain version, of max|y|
DS_TOL_F64 = 1e-13             # B4 vs float64 B1, relative 2-norm

# Peak rates of one H100 SXM (NVIDIA data sheet) at the 700 W power limit:
# HBM3 bandwidth, and the card's highest rate for each dtype (float32 on the
# CUDA cores; float64 on the tensor cores, twice the CUDA cores' 34e12: the
# element contractions are small matrix products).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
# Float32 instructions per second: 128 per SM per clock. An FADD or FMUL
# takes the issue slot of an FFMA, which PEAK_FLOPS counts as two flops, so
# a kernel of adds and multiplies (B4's error-free transforms) is bound by
# its instructions at half the flop rate.
FP32_ISSUE_PER_S = PEAK_FLOPS["float32"] / 2


def _bound(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take for
    ``nbytes`` of memory traffic and ``ops`` operations at ``rate`` per
    second (``PEAK_FLOPS[dtype]`` for flops)."""
    tb = nbytes / HBM_BYTES_PER_S
    tf = ops / rate
    return 1e3 * max(tb, tf), "bytes" if tb >= tf else "operations"


def _time_chain(fn, args_list, reps=5) -> float:
    """Median ms per call over ``reps`` chains of CHAIN calls (CUDA events);
    call i takes ``args_list[i % len(args_list)]``."""
    import torch
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(CHAIN):
            fn(*args_list[i % len(args_list)])
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / CHAIN)
    return statistics.median(per)


def _profile_calls(fn, args_list) -> list[tuple[str, int, float]]:
    """(name, count, device us) of every device activity (kernels, memsets,
    copies) over CHAIN calls, call i taking ``args_list[i % len]``: from
    torch.profiler's ``key_averages``, after a warm-up call. The window
    opens with a ~1 ms spin kernel (left out of the result): without it a
    window of 30 short calls once recorded no event at all; with it the
    profiler still loses ~3 launches a window (see :func:`_per_call`), and
    now and then a whole window: one that recorded no device activity is
    taken again, up to three windows."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(*args_list[0])
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(2_000_000)
            for i in range(CHAIN):
                fn(*args_list[i % len(args_list)])
            torch.cuda.synchronize()
        acts = [(e.key, e.count, e.device_time_total)
                for e in prof.key_averages()
                if getattr(e, "device_time_total", 0.0) > 0
                and "spin_kernel" not in e.key]
        if acts:
            break
        print("[2] the profiler recorded no device activity in a window of "
              f"{CHAIN} calls; taking it again")
    return acts


def _device_ms(fn, args_list, kernel_names,
               acts: list | None = None) -> float | None:
    """Device time per call (ms) of the CUDA kernels whose names contain one
    of ``kernel_names`` (None: of every device activity, memsets and copies
    included), from :func:`_profile_calls` (or its result ``acts``); None
    when the profiler records no device time."""
    if acts is None:
        acts = _profile_calls(fn, args_list)
    us = sum(t for k, _, t in acts
             if kernel_names is None or any(n in k for n in kernel_names))
    return us / 1e3 / CHAIN if us > 0 else None


def _short(kernel: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    import re
    m = re.search(r"(\w+<[^()]*>|\w+)\(", kernel)
    return m.group(1) if m else kernel


def _per_call(acts) -> dict:
    """Kernels, memsets and copies per call in :func:`_profile_calls`'s
    result, device ms per call of each kernel, and ``launch_ms``: the sum
    over the kernels of each one's mean device ms per recorded launch (each
    runs once per call), which the events the profiler loses do not bias
    (it records 27-29 of 30 launches of a short kernel)."""
    def moves(k):
        return "memset" in k.lower() or "memcpy" in k.lower()
    kernels = {k: t / 1e3 / CHAIN for k, _, t in acts if not moves(k)}
    return dict(kernels=kernels,
                launch_ms=sum(t / 1e3 / c for k, c, t in acts
                              if not moves(k) and c),
                kernels_per_call=sum(c for k, c, _ in acts if not moves(k))
                / CHAIN,
                memsets=sum(c for k, c, _ in acts if "memset" in k.lower()),
                copies=sum(c for k, c, _ in acts if "memcpy" in k.lower()))


def _rel_err(y, y_ref) -> tuple[float, float]:
    import torch
    torch.cuda.synchronize()
    abs_err = float((y - y_ref).abs().max())
    return abs_err, abs_err / float(y_ref.abs().max())


def _csr_cuda(A, dtype):
    """A scipy CSR matrix as a torch sparse CSR tensor on the card, with
    32-bit indices (cuSPARSE's SpMV is faster with them than with torch's
    default 64-bit ones)."""
    import numpy as np
    import torch
    if A.nnz >= 2 ** 31:
        raise ValueError(f"{A.nnz} nonzeros do not fit 32-bit indices")
    return torch.sparse_csr_tensor(
        torch.tensor(A.indptr.astype(np.int32)),
        torch.tensor(A.indices.astype(np.int32)),
        torch.tensor(A.data), size=A.shape).to(device="cuda", dtype=dtype)


def phase_device_and_build(report: dict) -> None:
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    report["nvidia_smi"] = smi
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    from lpfem_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_libraries(KERNEL_SOURCES)
    for name in KERNEL_SOURCES:
        _build.load_library(name)
    from lpfem_torch import native
    native._lib()                           # the host library, with g++
    secs = time.perf_counter() - t0
    report["build_s"] = secs
    print(f"[1] built and loaded {', '.join(KERNEL_SOURCES)} and the native "
          f"host library in {secs:.2f} s ({_build.BUILD_DIR})")
    report["ptxas"] = {}
    for name, text in logs.items():
        for kernel, regs, spills in _ptxas_kernels(text):
            print(f"[1] ptxas {name}: {kernel}: {regs}; {spills}")
            report["ptxas"][kernel] = f"{regs}; {spills}"


def _ptxas_kernels(text: str) -> list[tuple[str, str, str]]:
    """(kernel, registers, spills) per entry function of nvcc's ``-Xptxas
    -v`` report, the names demangled by c++filt where the machine has it."""
    import re
    import shutil
    rows, name, spills = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), ""
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line and name is not None:
            regs = line.split(":", 1)[-1].strip()
            rows.append([name, regs, spills])
            name = None
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(rows):
            for r, n in zip(rows, names):
                r[0] = n.replace("(anonymous namespace)::", "").split("(")[0]
    return [tuple(r) for r in rows]


def _main_lattices(ref_levels: int = CFG["ref_levels"]):
    """The p-multigrid lattices of the ss.cpp tank refined ``ref_levels``
    times (fine to coarse): 2 is the ss.cpp path, 1 is path C."""
    import lpfem_torch
    from lpfem_torch.space import LatticeSpace
    fine = LatticeSpace.from_config(lpfem_torch.preset(
        "scaling_base", **{**CFG, "ref_levels": ref_levels}))
    spaces = [fine, fine.with_order(2), fine.with_order(1)]
    spaces.append(spaces[-1].coarsen())
    return spaces


def _random_bands(dims, p: int, gen, dtype):
    """Six random band tables ``[2p+1, D]`` for the lattice ``dims``."""
    import torch
    Dx, Dy, Dz = dims
    return tuple(torch.randn(2 * p + 1, D, generator=gen, device="cuda",
                             dtype=torch.float64).to(dtype).contiguous()
                 for D in (Dx, Dx, Dy, Dy, Dz, Dz))


def _element_csr_readings(A, op, gap: float) -> dict:
    """What the limit of the float64 yardstick assembled from element
    matrices rests on: its gap to B1 (of max|y|) on the check's input and
    the largest on eight other inputs, and the gap with the same matrix's
    values rounded to float32, an assembly wrong at float32's precision,
    which the limit must stay far below."""
    import torch
    from lpfem_torch.kernels.sep_apply import sep_apply
    g = torch.Generator(device="cuda").manual_seed(100)
    gaps = []
    for _ in range(8):
        x = torch.randn(op.dof_dims[::-1], generator=g, device="cuda",
                        dtype=torch.float64)
        y = sep_apply(x, op.bands, op.periodic).reshape(-1)
        gaps.append(_rel_err(A @ x.reshape(-1), y)[1])
    A32 = torch.sparse_csr_tensor(A.crow_indices(), A.col_indices(),
                                  A.values().float().double(), size=A.shape)
    rounded = _rel_err(A32 @ x.reshape(-1), y)[1]
    del A32
    torch.cuda.empty_cache()
    out = dict(check_input=gap, other_inputs_max=max(gaps),
               other_inputs=gaps, float32_values=rounded)
    print(f"[2] float64 element-assembled SpMV vs B1, of max|y|: "
          f"{gap:.3e} on the check's input, at most {max(gaps):.3e} on "
          f"8 others; values rounded to float32: {rounded:.3e}; limit "
          f"{ELEMENT_CSR_TOL_F64:.0e}")
    return out


def _conv_tank(p: int):
    """The stationary study's tank (``lpfem_torch.experiments.laplace_conv``
    on ``make_wave_tank(8, 1, 2)``) as a lattice at order p: 8p x (p+1) x
    (2p+1) dofs, x periodic."""
    from lpfem_torch.space import LatticeSpace, grid_lines
    return LatticeSpace((grid_lines(8, 1.0), grid_lines(1, 0.1),
                         grid_lines(2, 1.0 / (2 * 3.141592653589793))), p,
                        (True, False, False))


def _b1_bound(sp, itemsize: int, dtype: str) -> tuple[float, str]:
    """B1's bound on the lattice of ``sp``: input read once, output written
    once, the six bands; 7(2p+1) multiply-adds per dof."""
    n, p = sp.n_dofs, sp.p
    nbytes = itemsize * (2 * n + 2 * (2 * p + 1) * sum(sp.dof_dims))
    return _bound(nbytes, 2 * 7 * (2 * p + 1) * n, PEAK_FLOPS[dtype])


def phase_sep_apply(report: dict) -> dict:
    import torch
    from lpfem_torch.kernels import sep_apply as ksep
    from lpfem_torch.kernels.sep_apply import (choose_tiles, sep_apply,
                                               sep_apply_reference)
    from lpfem_torch.operators import (AffineLatticeLaplace, SeparableLattice,
                                       assemble_csr)
    from lpfem_torch.space import CurvedLatticeSpace, LatticeSpace, grid_lines

    gen = torch.Generator(device="cuda").manual_seed(0)

    def check_bands(x, bands, periodic, ess, label):
        """B1 against its plain version, and bitwise on a second call."""
        dt = str(x.dtype)[6:]
        y = sep_apply(x, bands, periodic, ess)
        same = torch.equal(y, sep_apply(x, bands, periodic, ess))
        abs_err, rel = _rel_err(y, sep_apply_reference(x, bands, periodic,
                                                       ess))
        print(f"[2] sep_apply {label:52s} {dt:8s} ess_top={int(ess)} "
              f"rel_err={rel:.2e} repeat bitwise {same}")
        if not (rel <= TOL[dt] and same):
            raise AssertionError(f"kernel disagrees with plain version or "
                                 f"itself: {label} {dt} ess_top={ess}: "
                                 f"{rel:.3e}, bitwise {same}")
        return abs_err

    def check(space, dtype, ess, label):
        op = SeparableLattice(space, dtype, "cuda")
        x = torch.randn(space.dof_dims[::-1], generator=gen, device="cuda",
                        dtype=torch.float64).to(dtype)
        return op, x, check_bands(x, op.bands, op.periodic, ess, label)

    lz = 1.0 / (2 * 3.141592653589793)
    small = []
    # p = 1, 2, 4, 8 compiled fixed; the rest to MAX_P the general
    # instantiation
    for per, nx, lx in ((True, 6, 1.0), (False, 5, 12.0)):
        for p in range(1, ksep.MAX_P + 1):
            small.append(LatticeSpace((grid_lines(nx, lx), grid_lines(2, 0.1),
                                       grid_lines(3, lz)), p,
                                      (per, False, False)))
    small.append(LatticeSpace((grid_lines(5, 1.0), grid_lines(2, 0.1),
                               grid_lines(2, lz)), 1, (True, False, False)))
    for sp in small:
        for dtype in (torch.float32, torch.float64):
            for ess in (False, True):
                check(sp, dtype, ess, f"Dx={sp.dof_dims[0]} Dy="
                      f"{sp.dof_dims[1]} Dz={sp.dof_dims[2]} p={sp.p} "
                      f"{'periodic' if sp.periodic[0] else 'finite'}")
    # edge lattices, random bands: Dx = 2p+1 periodic; an odd Dx whose y and
    # z extents are no multiples of the tiles (y split in two tiles)
    for p in (1, 2, 3, 4, 6):
        for dims, per in (((2 * p + 1, 3, 4), True), ((267, 41, 19), True),
                          ((267, 41, 19), False)):
            for dtype in (torch.float32, torch.float64):
                tiles = choose_tiles(dims, p, 4 if dtype == torch.float32
                                     else 8)
                bands = _random_bands(dims, p, gen, dtype)
                x = torch.randn(dims[::-1], generator=gen, device="cuda",
                                dtype=torch.float64).to(dtype)
                for ess in (False, True):
                    check_bands(x, bands, (per, False, False), ess,
                                f"{'x'.join(map(str, dims))} p={p} "
                                f"{'periodic' if per else 'finite'} tiles "
                                f"{tiles[:3]}")

    # the stationary p-sweep's tank at every order (phase 8 runs it there):
    # checked, and timed in float64 (its float64 sweep) and float32 (the
    # mixed sweep's inner solve)
    conv = []
    for p in range(1, ksep.MAX_P + 1):
        sp = _conv_tank(p)
        dims = "x".join(str(d) for d in sp.dof_dims[::-1])
        for dtype in (torch.float32, torch.float64):
            op, x, abs_err = check(sp, dtype, True,
                                   f"stationary tank p={p} {dims}")
            check(sp, dtype, False, f"stationary tank p={p} {dims}")
            b1 = lambda v: sep_apply(v, op.bands, op.periodic, True)
            dev = _device_ms(b1, [(x,)], B1_KERNEL)
            ms = _time_chain(b1, [(x,)])
            plain = _time_chain(lambda v: sep_apply_reference(
                v, op.bands, op.periodic, True), [(x,)])
            dt = str(dtype)[6:]
            bound, by = _b1_bound(sp, x.element_size(), dt)
            conv.append(dict(p=p, dims=dims, dtype=dt, ms=dev if dev
                             is not None else ms, device_ms=dev, call_ms=ms,
                             plain_ms=plain, bound_ms=bound, bound_by=by,
                             max_abs_err=abs_err,
                             tiles=choose_tiles(sp.dof_dims, p,
                                                x.element_size())))
            print(f"[2] time sep_apply stationary tank p={p} {dims} {dt} "
                  f"ess_top=1: kernel {conv[-1]['ms']:.4f} ms on the device "
                  f"({ms:.4f} ms per call), plain {plain:.4f} ms, bound "
                  f"{bound:.5f} ms ({by})")
    report["sep_apply_conv_times"] = conv

    def cases(li):
        """Every level's float32 inner solve; on the fine level also the
        float64 outer residual and the right-hand side lift."""
        fine = [(torch.float32, False), (torch.float64, True),
                (torch.float64, False)] if li == 0 else []
        return [(torch.float32, True)] + fine

    for li, sp in enumerate(_main_lattices(ref_levels=1)):
        dims = "x".join(str(d) for d in sp.dof_dims[::-1])
        for dtype, ess in cases(li):
            check(sp, dtype, ess, f"path C level {li}: p={sp.p} {dims}")

    times = []
    fine_f32 = None
    for li, sp in enumerate(_main_lattices()):
        dims = "x".join(str(d) for d in sp.dof_dims[::-1])
        # float64 at p = 2 and 1 too (timed for the table of orders; no
        # path runs it)
        extra = [(torch.float64, True)] if li in (1, 2) else []
        for dtype, ess in cases(li) + extra:
            op, x, abs_err = check(sp, dtype, ess,
                                   f"ss.cpp level {li}: p={sp.p} {dims}")
            b1 = lambda v: sep_apply(v, op.bands, op.periodic, ess)
            ms = _time_chain(b1, [(x,)])
            acts = _profile_calls(b1, [(x,)])
            dev = _device_ms(b1, [(x,)], B1_KERNEL, acts)
            act = _per_call(acts)
            dt = str(dtype)[6:]
            print(f"[2] sep_apply level {li} {dt} ess_top={int(ess)} on the "
                  f"device: {act['kernels_per_call']:.2f} kernels per call "
                  f"recorded ({act['launch_ms']:.4f} ms per launch), "
                  f"{act['memsets']} memsets, {act['copies']} copies")
            if (len(act["kernels"]) != 1 or act["kernels_per_call"] > 1
                    or act["memsets"] or act["copies"]):
                raise AssertionError(f"B1 calls ran {act} (one kernel, no "
                                     "memset or copy)")
            plain = _time_chain(lambda v: sep_apply_reference(
                v, op.bands, op.periodic, ess), [(x,)])
            p = sp.p
            bound, by = _b1_bound(sp, x.element_size(), dt)
            row = dict(level=li, p=p, dims=dims, dtype=dt, ess_top=ess,
                       ms=dev if dev is not None else ms, call_ms=ms,
                       device_ms=dev, plain_ms=plain, max_abs_err=abs_err,
                       bound_ms=bound, bound_by=by, library_ms=None,
                       launch_ms=act["launch_ms"],
                       kernels_per_call_recorded=act["kernels_per_call"],
                       tiles=choose_tiles(sp.dof_dims, p, x.element_size()))
            if (li in (1, 2) and (dtype, ess) not in extra) or (li == 0
                                                                and ess):
                # cuSPARSE yardstick: SpMV of the assembled matrix at this
                # lattice (the operator without the top-plane identity);
                # at p=4 assembled on the card from the element form of the
                # same tank, which has the lattice's numbering
                if li == 0:
                    A = assemble_csr(AffineLatticeLaplace(
                        CurvedLatticeSpace(_plain_mesh(), sp.p), dtype,
                        "cuda"), dtype)
                else:
                    A = _csr_cuda(op.assemble_scipy(), dtype)
                xf = x.reshape(-1)
                _, rel = _rel_err(A @ xf, sep_apply(
                    x, op.bands, op.periodic).reshape(-1))
                limit = TOL[dt]
                if li == 0 and dtype == torch.float64:
                    limit = ELEMENT_CSR_TOL_F64
                    row["spmv_gap_readings"] = _element_csr_readings(A, op,
                                                                     rel)
                if not rel <= limit:
                    raise AssertionError(f"CSR SpMV disagrees: {rel:.3e} "
                                         f"(limit {limit:.0e})")
                row["library_ms"] = _time_chain(lambda v: A @ v, [(xf,)])
                row["library_device_ms"] = _device_ms(lambda v: A @ v,
                                                      [(xf,)], None)
                row["library_nnz"] = int(A.values().numel())
                lib_dev = row["library_device_ms"] or row["library_ms"]
                row["ratio_to_spmv"] = row["ms"] / lib_dev
                del A
                torch.cuda.empty_cache()
            times.append(row)
            lib = (f", cuSPARSE SpMV {row['library_ms']:.4f} ms per call "
                   f"({row['library_nnz']} nonzeros; B1 / SpMV on the "
                   f"device {row['ratio_to_spmv']:.3f})"
                   if row["library_ms"] is not None else "")
            print(f"[2] time sep_apply level {li} p={p} {dims} {dt} "
                  f"ess_top={int(ess)} tiles {row['tiles'][:3]}: kernel "
                  f"{row['ms']:.4f} ms on the device ({ms:.4f} ms per "
                  f"call, host included), plain {plain:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}){lib}")
            if li == 0 and dtype == torch.float32 and ess:
                fine_f32 = row
    report["sep_apply_times"] = times
    report["sep_apply_p8_times"] = _sep_apply_p8_rows(check, report)
    return fine_f32


def _sep_apply_p8_rows(check, report) -> list:
    """B1 at p = 8 on the order-8 tank's top lattice (1024 x 65 x 257,
    x periodic, the benchmark cell ``tank_p8.f64_refs2``), float64 (the
    cell's) and float32: against the plain version and twice for the same
    bits (``check``), device time, time per call, plain time, and the
    bound from the benchmark's own cost functions
    (``benchmark.costs.roofline``: float64 flops at 34e12/s); the launches
    of the tensor-core route among the row's launches (all of them in
    float64, none in float32) and phase 1's ptxas line of the route."""
    import torch

    import lpfem_torch
    from benchmark.costs import roofline
    from lpfem_torch.kernels import sep_apply as ksep
    from lpfem_torch.kernels.sep_apply import (choose_tiles, sep_apply,
                                               sep_apply_reference)
    from lpfem_torch.space import LatticeSpace

    ptxas = [f"{k}: {v}" for k, v in report.get("ptxas", {}).items()
             if "sep_tile_kernel<double, 8>" in k
             or "sep_tile_kernelIdLi8E" in k]
    print(f"[2] ptxas of the tensor-core route: {ptxas}")

    sp = LatticeSpace.from_config(lpfem_torch.preset(
        "scaling_base", order=8, ref_levels=2))
    dims = "x".join(str(d) for d in sp.dof_dims[::-1])
    rows = []
    for dtype in (torch.float64, torch.float32):
        n0 = ksep.LAUNCHES_BY_P.get(8, 0)
        tc0 = ksep.LAUNCHES_TC_BY_P.get(8, 0)
        op, x, abs_err = check(sp, dtype, True, f"order-8 tank p=8 {dims}")
        b1 = lambda v: sep_apply(v, op.bands, op.periodic, True)
        ms = _time_chain(b1, [(x,)])
        acts = _profile_calls(b1, [(x,)])
        dev = _device_ms(b1, [(x,)], B1_KERNEL, acts)
        plain = _time_chain(lambda v: sep_apply_reference(
            v, op.bands, op.periodic, True), [(x,)])
        dt = str(dtype)[6:]
        nbytes, flops = roofline.b1_cost(sp.dof_dims, 8, x.element_size())
        bound = 1e3 * roofline.least_seconds(nbytes, flops, dt)
        by = ("bytes" if nbytes / roofline.HBM_BYTES_PER_S
              >= flops / roofline.PEAK_FLOPS[dt] else "operations")
        kernel = sorted({_short(k) for k, _, _ in acts
                         if any(n in k for n in B1_KERNEL)})
        row = dict(p=8, dims=dims, dtype=dt, ess_top=True,
                   ms=dev if dev is not None else ms, device_ms=dev,
                   call_ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                   max_abs_err=abs_err, kernel=kernel,
                   tiles=choose_tiles(sp.dof_dims, 8, x.element_size()))
        launched = ksep.LAUNCHES_BY_P.get(8, 0) - n0
        row["tc_launches"] = ksep.LAUNCHES_TC_BY_P.get(8, 0) - tc0
        row["launches"] = launched
        row["ptxas"] = ptxas if dtype == torch.float64 else None
        assert row["tc_launches"] == (launched if dtype == torch.float64
                                      else 0), (row["tc_launches"], launched)
        rows.append(row)
        print(f"[2] time sep_apply order-8 tank p=8 {dims} {dt} ess_top=1 "
              f"{kernel} tiles {row['tiles'][:3]}: kernel {row['ms']:.4f} ms "
              f"on the device ({ms:.4f} ms per call), plain {plain:.4f} ms, "
              f"bound {bound:.4f} ms ({by}), "
              f"{100 * bound / row['ms']:.1f} % of it; tensor-core launches "
              f"{row['tc_launches']} of {launched}")
        del op, x
        torch.cuda.empty_cache()
    return rows


@functools.lru_cache(maxsize=None)
def _study_mesh():
    """The diffraction study's default tank (built once: ~6 s of host)."""
    from lpfem_torch.experiments.diffraction import study_mesh
    return study_mesh()


def _element_flops(ne: int, p1: int, q: int, affine: bool = False) -> int:
    """Flops of the sum-factorised element apply (csrc/affine_body.cuh):
    the six contractions, and per Gauss point the symmetric 3x3 product
    (15) and, with the affine metric, the three weight products."""
    macs = 4 * p1 ** 3 * q + 6 * p1 ** 2 * q ** 2 + 6 * p1 * q ** 3
    return ne * (2 * macs + (18 if affine else 15) * q ** 3)


def phase_pa_apply(report: dict) -> dict:
    import torch
    from lpfem_torch.cylmesh import make_half_cylinder_tank
    from lpfem_torch.kernels.pa_apply import (pa_apply_element,
                                              pa_apply_element_reference)
    from lpfem_torch.operators import ElementLaplace, assemble_csr
    from lpfem_torch.space import CurvedLatticeSpace

    gen = torch.Generator(device="cuda").manual_seed(1)

    def check(u, G6q, B, D, label):
        dt = str(u.dtype)[6:]
        ye = pa_apply_element(u, G6q, B, D)
        abs_err, rel = _rel_err(ye, pa_apply_element_reference(u, G6q, B, D))
        print(f"[2] pa_apply_element {label:44s} {dt:8s} rel_err={rel:.2e}")
        if not rel <= TOL[dt]:
            raise AssertionError(f"kernel disagrees with plain version: "
                                 f"{label} {dt}: {rel:.3e}")
        return abs_err

    # the orders compiled fixed (q = p+1), and the general instantiation
    # (q = p+2; p+1 = 6: an element over two warps)
    for p, q in SMALL_ORDERS:
        mesh = make_half_cylinder_tank(n_theta=12, n_r=6, nz=1, geom_order=p)
        for dtype in (torch.float32, torch.float64):
            op = ElementLaplace(CurvedLatticeSpace(mesh, p), dtype, "cuda",
                                q=q)
            ne, L = op.G6q.shape[0], (p + 1) ** 3
            u = torch.randn(37, L, generator=gen, device="cuda", dtype=dtype)
            check(u, torch.rand(37, 6 * q ** 3, generator=gen, device="cuda",
                                dtype=dtype), op.B, op.D,
                  f"p={p} q={q} ne=37 random metric")
            u = torch.randn(ne, L, generator=gen, device="cuda", dtype=dtype)
            check(u, op.G6q, op.B, op.D, f"p={p} q={q} ne={ne} small tank")
            check(u, _random_spd_metric(ne, q, gen, dtype), op.B, op.D,
                  f"p={p} q={q} ne={ne} random SPD metric")

    fine = CurvedLatticeSpace(_study_mesh(), 4)
    if fine.n_dofs != CYL_DOFS:
        raise AssertionError(f"expected {CYL_DOFS} dofs, got {fine.n_dofs}")
    times = []
    head = None
    for p in (4, 2, 1):
        space = fine.with_order(p)
        # float64 is every level of the default study, float32 every level
        # of the mixed run's inner solves
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype)[6:]
            op = ElementLaplace(space, dtype, "cuda")
            ne, Q6 = op.G6q.shape
            L = (p + 1) ** 3
            label = f"diffraction level p={p} ne={ne}"
            u = torch.randn(ne, L, generator=gen, device="cuda", dtype=dtype)
            check(u, torch.rand(ne, Q6, generator=gen, device="cuda",
                                dtype=dtype), op.B, op.D,
                  label + " random metric")
            check(u, _random_spd_metric(ne, p + 1, gen, dtype), op.B,
                  op.D, label + " random SPD metric")
            abs_err = check(u, op.G6q, op.B, op.D, label + " real metric")
            # kernel alone: inputs rotated over > 50 MB so L2 stays cold
            nbytes_set = (2 * u.numel() + op.G6q.numel()) * u.element_size()
            n_sets = max(1, -(-60_000_000 // nbytes_set))
            sets = [(u.clone(), op.G6q.clone()) for _ in range(n_sets)]
            b3b = lambda a, g: pa_apply_element(a, g, op.B, op.D)
            ms = _time_chain(b3b, sets)
            acts = _profile_calls(b3b, sets)
            dev = _device_ms(b3b, sets, ("pa_element_kernel",), acts)
            act = _per_call(acts)
            print(f"[2] pa_apply_element p={p} {dt} on the device: "
                  f"{act['kernels_per_call']:.2f} kernels per call recorded "
                  f"({act['launch_ms']:.4f} ms per launch), "
                  f"{act['memsets']} memsets, {act['copies']} copies")
            if (len(act["kernels"]) != 1 or act["kernels_per_call"] > 1
                    or act["memsets"] or act["copies"]):
                raise AssertionError(f"B3b calls ran {act}")
            plain = _time_chain(lambda a, g: pa_apply_element_reference(
                a, g, op.B, op.D), sets[:1])
            x = torch.randn(space.n_dofs, generator=gen, device="cuda",
                            dtype=dtype)
            full = _time_chain(op.apply, [(x,)])
            A = assemble_csr(op, dtype)
            _, rel = _rel_err(A @ x, op.apply(x))
            if not rel <= TOL[dt]:
                raise AssertionError(f"CSR SpMV disagrees with the element "
                                     f"apply: {rel:.3e}")
            csr = _time_chain(lambda v: A @ v, [(x,)])
            nnz = int(A.values().numel())
            del A, sets
            q = p + 1
            bound, by = _bound(
                u.element_size() * (2 * ne * L + ne * Q6 + 2 * q * (p + 1)),
                _element_flops(ne, p + 1, q), PEAK_FLOPS[dt])
            row = dict(p=p, ne=ne, dtype=dt,
                       ms=dev if dev is not None else ms, call_ms=ms,
                       device_ms=dev, launch_ms=act["launch_ms"],
                       plain_ms=plain, full_apply_ms=full,
                       library_full_apply_ms=csr, library_nnz=nnz,
                       max_abs_err=abs_err, bound_ms=bound, bound_by=by,
                       flops=_element_flops(ne, p + 1, q))
            times.append(row)
            print(f"[2] time pa_apply_element p={p} ne={ne} {dt}: kernel "
                  f"{row['ms']:.4f} ms on the device ({ms:.4f} ms per call, "
                  f"host included), plain {plain:.4f} "
                  f"ms, bound {bound:.4f} ms ({by}); full apply {full:.4f} "
                  f"ms vs cuSPARSE SpMV {csr:.4f} ms ({nnz} nonzeros)")
            if p == 4 and dtype == torch.float32:
                head = row
            torch.cuda.empty_cache()
    report["pa_apply_times"] = times
    return head


def _tank_dims():
    """(dims, sizes) of the ss.cpp tank's coarse mesh (``scaling_base``)."""
    import lpfem_torch
    cfg = lpfem_torch.preset("scaling_base")
    return (cfg.nx, cfg.ny, cfg.nz), (cfg.Lx, cfg.Ly, cfg.Lz)


@functools.lru_cache(maxsize=None)
def _plain_mesh():
    """The ss.cpp tank refined twice as a mesh with its element lattice
    declared (32,768 boxes; built once): the element form of the operator
    that the Kronecker kernel applies, for the assembled yardstick."""
    from lpfem_torch.experiments.leaning_tank import declare_lattice
    from lpfem_torch.mesh import make_wave_tank
    dims, sizes = _tank_dims()
    mesh = make_wave_tank(*dims, *sizes)
    for _ in range(CFG["ref_levels"]):
        mesh = mesh.uniform_refine()
    return declare_lattice(mesh)


@functools.lru_cache(maxsize=None)
def _leaning_mesh():
    """Path A's mesh: the ss.cpp tank refined twice, leaning along z, the
    element lattice declared (32,768 hexes; built once)."""
    from lpfem_torch.experiments.leaning_tank import leaning_tank
    dims, sizes = _tank_dims()
    return leaning_tank(*dims, *sizes, ref_levels=CFG["ref_levels"], lean="z")


def _random_spd_metric(ne: int, q: int, gen, dtype):
    """[ne, 6 q^3]: a random symmetric positive definite metric at every
    Gauss point, component-major as ``G6q``."""
    Q = q ** 3
    return (_random_spd6(ne * Q, gen, dtype).reshape(ne, Q, 6)
            .permute(0, 2, 1).reshape(ne, 6 * Q).contiguous())


def _random_spd6(ne: int, gen, dtype):
    """[ne, 6]: the six components of random symmetric positive definite
    3x3 matrices (A A^T + I)."""
    import torch
    A = torch.randn(ne, 3, 3, generator=gen, device="cuda",
                    dtype=torch.float64)
    M = A @ A.transpose(1, 2) + torch.eye(3, device="cuda",
                                          dtype=torch.float64)
    return torch.stack([M[:, 0, 0], M[:, 0, 1], M[:, 0, 2], M[:, 1, 1],
                        M[:, 1, 2], M[:, 2, 2]], dim=1).to(dtype).contiguous()


def phase_affine(report: dict) -> tuple[dict, dict]:
    import torch
    import lpfem_torch
    from lpfem_torch.experiments.leaning_tank import (declare_lattice,
                                                      leaning_tank, shear_x)
    from lpfem_torch.kernels.lattice_apply import (
        lattice_affine_apply, lattice_affine_apply_reference)
    from lpfem_torch.kernels.pa_apply import (pa_apply_affine,
                                              pa_apply_affine_reference)
    from lpfem_torch.kernels.sep_apply import sep_apply
    from lpfem_torch.mesh import make_wave_tank_finite
    from lpfem_torch.operators import (AffineLatticeLaplace, ElementLaplace,
                                       SeparableLattice, assemble_csr)
    from lpfem_torch.space import CurvedLatticeSpace, LatticeSpace

    gen = torch.Generator(device="cuda").manual_seed(2)

    def check(name, y, y_ref, label, dt):
        abs_err, rel = _rel_err(y, y_ref)
        print(f"[2] {name} {label:52s} {dt:8s} rel_err={rel:.2e}")
        if not rel <= TOL[dt]:
            raise AssertionError(f"{name} disagrees: {label} {dt}: "
                                 f"{rel:.3e}")
        return abs_err

    def check_b3a(op, C6, label):
        dt = str(op.dtype)[6:]
        u = torch.randn(C6.shape[0], (op.p + 1) ** 3, generator=gen,
                        device="cuda", dtype=op.dtype)
        return u, check("pa_apply_affine", pa_apply_affine(
            u, C6, op.w3, op.B, op.D), pa_apply_affine_reference(
                u, C6, op.w3, op.B, op.D), label, dt)

    def check_b2(op, C6, ess, label):
        dt = str(op.dtype)[6:]
        dims, per = op.space.elem_dims, op.periodic
        x = torch.randn(op.n_dofs, generator=gen, device="cuda",
                        dtype=op.dtype)
        y = lattice_affine_apply(x, C6, op.w3, op.B, op.D, dims, per, ess)
        if not torch.equal(y, lattice_affine_apply(x, C6, op.w3, op.B, op.D,
                                                   dims, per, ess)):
            raise AssertionError(f"lattice_affine_apply is not bitwise "
                                 f"repeatable: {label} {dt}")
        return x, y, check("lattice_affine_apply", y,
                           lattice_affine_apply_reference(
                               x, C6, op.w3, op.B, op.D, dims, per, ess),
                           f"{label} ess_top={int(ess)}", dt)

    lz = 1.0 / (2 * 3.141592653589793)
    finite = declare_lattice(make_wave_tank_finite(5, 3, 3, 12.0, 1.0, lz))
    small = [("periodic 6x2x3", leaning_tank(6, 2, 3, 1.0, 0.1, lz)),
             ("periodic 5x3x3 (odd nex: 12 classes)",
              leaning_tank(5, 3, 3, 1.0, 0.1, lz)),
             ("finite 5x3x3", shear_x(finite, 2, 0.5 * (12.0 / 5) / (lz / 3)))]
    for name, mesh in small:
        # the orders compiled fixed (q = p+1), and the general instantiation
        # (q = p+2; p+1 = 6: an element over two warps)
        for p, q in SMALL_ORDERS:
            space = CurvedLatticeSpace(mesh, p)
            for dtype in (torch.float32, torch.float64):
                dt = str(dtype)[6:]
                op = AffineLatticeLaplace(space, dtype, "cuda", q=q)
                full = ElementLaplace(space, dtype, "cuda", q=q)  # full metric
                ne = op.C6.shape[0]
                label = f"{name} p={p} q={q}"
                check_b3a(op, op.C6, label + " real C6")
                check_b3a(op, _random_spd6(37, gen, dtype),
                          label + " ne=37 random C6")
                for ess in (False, True):
                    check_b2(op, _random_spd6(ne, gen, dtype), ess,
                             label + " random C6")
                    x, y, _ = check_b2(op, op.C6, ess, label + " real C6")
                    y_full = (full.constrained_apply_top(x) if ess
                              else full.apply(x))
                    check("B2 vs ElementLaplace (full metric)", y, y_full,
                          f"{label} ess_top={int(ess)}", dt)

    # the p-multigrid lattices of path A
    fine = CurvedLatticeSpace(_leaning_mesh(), CFG["order"])
    plain = LatticeSpace.from_config(lpfem_torch.preset("scaling_base", **CFG))
    if fine.n_dofs != 2_179_584 or fine.dof_dims != plain.dof_dims:
        raise AssertionError(f"path A lattice {fine.dof_dims}")
    times = {"pa_apply_affine": [], "lattice_affine_apply": []}
    heads = {}
    for p in (4, 2, 1):
        space = fine.with_order(p)
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype)[6:]
            size = 4 if dtype == torch.float32 else 8
            op = AffineLatticeLaplace(space, dtype, "cuda")
            ne, n, L, q = op.C6.shape[0], op.n_dofs, (p + 1) ** 3, p + 1
            dims, per = space.elem_dims, op.periodic
            label = f"path A level p={p} ne={ne}"
            flops = _element_flops(ne, p + 1, q, affine=True)
            tables = 6 * ne + q ** 3 + 2 * q * (p + 1)

            # B3a at this level's E-vector (what the three-step route runs)
            check_b3a(op, _random_spd6(ne, gen, dtype), label + " random C6")
            u, abs_err = check_b3a(op, op.C6, label + " real C6")
            n_sets = max(1, -(-60_000_000 // (2 * u.numel() * size)))
            sets = [(u.clone(),) for _ in range(n_sets)]
            b3a = lambda a: pa_apply_affine(a, op.C6, op.w3, op.B, op.D)
            ms = _time_chain(b3a, sets)
            acts = _profile_calls(b3a, sets)
            dev = _device_ms(b3a, sets, ("pa_affine_kernel",), acts)
            act = _per_call(acts)
            print(f"[2] pa_apply_affine p={p} {dt} on the device: "
                  f"{act['kernels_per_call']:.2f} kernels per call recorded "
                  f"({act['launch_ms']:.4f} ms per launch), "
                  f"{act['memsets']} memsets, {act['copies']} copies")
            if (len(act["kernels"]) > 1 or act["kernels_per_call"] > 1
                    or act["memsets"] or act["copies"]):
                raise AssertionError(f"B3a calls ran {act}")
            plain_ms = _time_chain(lambda a: pa_apply_affine_reference(
                a, op.C6, op.w3, op.B, op.D), sets[:1])
            bound, by = _bound(size * (2 * ne * L + tables), flops,
                               PEAK_FLOPS[dt])
            row = dict(p=p, ne=ne, dtype=dt, ms=dev if dev is not None else ms,
                       call_ms=ms, device_ms=dev, plain_ms=plain_ms,
                       max_abs_err=abs_err, bound_ms=bound, bound_by=by,
                       library_ms=None, flops=flops,
                       launch_ms=act["launch_ms"],
                       kernels_per_call_recorded=act["kernels_per_call"],
                       launches_per_call=len(act["kernels"]))
            times["pa_apply_affine"].append(row)
            print(f"[2] time pa_apply_affine p={p} ne={ne} {dt}: kernel "
                  f"{row['ms']:.4f} ms on the device ({ms:.4f} ms per call, "
                  f"host included), plain {plain_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({by})")
            if p == 4 and dtype == torch.float32:
                heads["pa_apply_affine"] = row
            del sets, u

            # B2: every level runs ess_top in the inner solve; the fine
            # level also the float64 residual and the right-hand side lift
            # the three-step route B2 fuses (gather, B3a, fold), and B1 on
            # the unsheared lattice of the same size
            three = ElementLaplace(space, dtype, "cuda", C6=op.C64)
            sep = SeparableLattice(plain.with_order(p), dtype, "cuda")
            for ess in ((True, False) if p == 4 else (True,)):
                check_b2(op, _random_spd6(ne, gen, dtype), ess,
                         label + " random C6")
                x, y, abs_err = check_b2(op, op.C6, ess, label + " real C6")
                if p == 4 and ess:
                    full = ElementLaplace(space, dtype, "cuda")
                    check("B2 vs ElementLaplace (full metric)", y,
                          full.constrained_apply_top(x),
                          f"{label} ess_top=1", dt)
                    del full
                n_sets = max(1, -(-60_000_000 // (x.numel() * size)))
                sets = [(x.clone(),) for _ in range(n_sets)]
                b2 = lambda v: lattice_affine_apply(v, op.C6, op.w3, op.B,
                                                    op.D, dims, per, ess)
                ms = _time_chain(b2, sets)
                acts = _profile_calls(b2, sets)
                dev = _device_ms(b2, sets, None, acts)
                act = _per_call(acts)
                split = ", ".join(f"{_short(k)} {v:.4f} ms"
                                  for k, v in act["kernels"].items())
                print(f"[2] lattice_affine_apply p={p} {dt} "
                      f"ess_top={int(ess)} on the device: "
                      f"{act['kernels_per_call']:.2f} kernels per call "
                      f"recorded ({split}; {act['launch_ms']:.4f} ms per "
                      f"launch of each), {act['memsets']} memsets, "
                      f"{act['copies']} copies")
                if (not 1 <= len(act["kernels"]) <= 2
                        or act["kernels_per_call"] > 2
                        or act["memsets"] or act["copies"]):
                    raise AssertionError(f"B2 calls ran {act} (at most "
                                         "two kernels, no memset or copy)")
                plain_ms = _time_chain(
                    lambda v: lattice_affine_apply_reference(
                        v, op.C6, op.w3, op.B, op.D, dims, per, ess),
                    sets[:1])
                route = three.constrained_apply_top if ess else three.apply
                _, rel = _rel_err(route(x), y)
                if not rel <= TOL[dt]:
                    raise AssertionError(f"gather + B3a + fold disagrees "
                                         f"with B2: {rel:.3e}")
                three_ms = _time_chain(route, sets)
                three_dev = _device_ms(route, sets, None)
                b1 = lambda v: sep_apply(v.view(sep.dof_dims[::-1]),
                                         sep.bands, sep.periodic, ess)
                b1_ms = _time_chain(b1, sets)
                b1_dev = _device_ms(b1, sets, B1_KERNEL)
                bound, by = _bound(size * (2 * n + tables), flops,
                                   PEAK_FLOPS[dt])
                row = dict(p=p, ne=ne, dofs=n, dtype=dt, ess_top=ess,
                           ms=dev if dev is not None else ms, call_ms=ms,
                           device_ms=dev, plain_ms=plain_ms,
                           three_step_call_ms=three_ms,
                           three_step_device_ms=three_dev, b1_call_ms=b1_ms,
                           b1_device_ms=b1_dev, max_abs_err=abs_err,
                           bound_ms=bound, bound_by=by, library_ms=None,
                           flops=flops,
                           kernel_ms={_short(k): v for k, v in
                                      act["kernels"].items()},
                           launch_ms=act["launch_ms"],
                           kernels_per_call_recorded=act["kernels_per_call"],
                           launches_per_call=len(act["kernels"]))
                if ess:
                    # cuSPARSE yardstick: SpMV of the assembled operator
                    # (without the top-plane identity)
                    A = assemble_csr(three, dtype)
                    _, rel = _rel_err(A @ x, three.apply(x))
                    if not rel <= TOL[dt]:
                        raise AssertionError(f"CSR SpMV disagrees: {rel:.3e}")
                    row["library_ms"] = _time_chain(lambda v: A @ v, sets)
                    row["library_device_ms"] = _device_ms(
                        lambda v: A @ v, sets, None)
                    row["library_nnz"] = int(A.values().numel())
                    lib_dev = row["library_device_ms"] or row["library_ms"]
                    row["ratio_to_spmv"] = row["ms"] / lib_dev
                    print(f"[2] B2 / cuSPARSE SpMV at p={p} {dt}: "
                          f"{row['ms']:.4f} / {lib_dev:.4f} ms on the device "
                          f"= {row['ratio_to_spmv']:.3f}")
                    del A
                times["lattice_affine_apply"].append(row)
                lib = (f", cuSPARSE SpMV {row['library_ms']:.4f} ms "
                       f"({row['library_nnz']} nonzeros)"
                       if row["library_ms"] is not None else "")
                print(f"[2] time lattice_affine_apply p={p} {n} dofs {dt} "
                      f"ess_top={int(ess)}: {row['ms']:.4f} ms on the device "
                      f"({ms:.4f} ms per call, host included), plain "
                      f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}); "
                      f"gather + B3a + fold {three_dev or three_ms:.4f} ms on "
                      f"the device ({three_ms:.4f} per call); B1 on the "
                      f"unsheared lattice {b1_dev or b1_ms:.4f} ms "
                      f"({b1_ms:.4f} per call){lib}")
                if p == 4 and dtype == torch.float32 and ess:
                    heads["lattice_affine_apply"] = row
                del sets, x, y
                torch.cuda.empty_cache()
            del op, three, sep
            torch.cuda.empty_cache()
    report["affine_times"] = times
    return heads["pa_apply_affine"], heads["lattice_affine_apply"]


def _ds_instructions(dims, p: int, periodic_x: bool, ess_top: bool) -> int:
    """Float32 instructions of one B4 apply (``csrc/sep_apply_ds.cu``, an
    fma counted as one), for the terms this lattice has: 14 per band term,
    3 per normalisation, 11 per DS addition; x holds 2 accumulators, y 3,
    z 2; ess_top skips the top plane's terms in x and z."""
    Dx, Dy, Dz = dims

    def terms(D, per):            # valid (i, s) pairs along one line
        return D * (2 * p + 1) - (0 if per else p * (p + 1))

    plane = Dx * Dy
    n = plane * Dz
    top = plane if ess_top else 0
    x_terms = terms(Dx, periodic_x) * Dy * (Dz - (1 if ess_top else 0))
    y_terms = terms(Dy, False) * Dx * Dz
    z_terms = (terms(Dz, False) - (p + 1 if ess_top else 0)) * plane
    return (14 * (2 * x_terms + 3 * y_terms + 2 * z_terms)
            + 6 * n + (3 * 3 + 11) * n + (2 * 3 + 11) * (n - top))


def phase_sep_apply_ds(report: dict) -> dict:
    import torch
    from lpfem_torch.ds import DS, SeparableDS, ds_from_f64, ds_to_f64
    from lpfem_torch.kernels.sep_apply import sep_apply
    from lpfem_torch.kernels.sep_apply_ds import (choose_ds_tiles,
                                                  sep_apply_ds,
                                                  sep_apply_ds_reference)
    from lpfem_torch.operators import SeparableLattice
    from lpfem_torch.space import LatticeSpace, grid_lines

    gen = torch.Generator(device="cuda").manual_seed(3)

    def rel2(y, y_ref):
        return float(torch.linalg.norm(y - y_ref) / torch.linalg.norm(y_ref))

    def same(a, b):
        return bool(torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo))

    def rand_pair(shape, kind):
        """A DS pair of random float64 values: "normal", or "wide" with
        magnitudes spread over 1e-8..1e8."""
        x64 = torch.randn(shape, generator=gen, device="cuda",
                          dtype=torch.float64)
        if kind == "wide":
            x64 = x64 * 10.0 ** (16.0 * torch.rand(
                shape, generator=gen, device="cuda",
                dtype=torch.float64) - 8.0)
        return ds_from_f64(x64)

    def check(x, dsb, b64, b32, periodic, ess, kind, label):
        """B4 on the DS pair ``x`` against its plain version, bit for bit
        (and of max|y|), twice on one input for the same bits, and against
        float64 B1 with the float64 bands ``b64`` on the pair's value
        (relative 2-norm); float32 B1 beside it."""
        y = sep_apply_ds(x.hi, x.lo, dsb, periodic, ess)
        repeat = same(y, sep_apply_ds(x.hi, x.lo, dsb, periodic, ess))
        y_ref = sep_apply_ds_reference(x.hi, x.lo, dsb, periodic, ess)
        abs_err, rel = _rel_err(ds_to_f64(y), ds_to_f64(y_ref))
        bitwise = same(y, y_ref)
        y64 = sep_apply(ds_to_f64(x), b64, periodic, ess)
        rel64 = rel2(ds_to_f64(y), y64)
        rel32 = rel2(sep_apply(x.hi.contiguous(), b32, periodic,
                               ess).double(), y64)
        print(f"[2] sep_apply_ds {label:50s} {kind:6s} ess_top={int(ess)} "
              f"vs plain {rel:.2e} (bitwise {bitwise}, repeat bitwise "
              f"{repeat}), vs float64 B1 {rel64:.2e} (float32 B1 "
              f"{rel32:.2e})")
        if not (bitwise and repeat and rel <= DS_TOL_PLAIN
                and rel64 <= DS_TOL_F64):
            raise AssertionError(f"sep_apply_ds disagrees: {label} {kind} "
                                 f"ess_top={ess}: {rel:.3e} / {rel64:.3e}, "
                                 f"bitwise {bitwise}, repeat {repeat}")
        return dict(label=label, kind=kind, ess_top=ess, rel_err_plain=rel,
                    bitwise=bitwise, repeat_bitwise=repeat,
                    rel_err_f64=rel64, rel_err_f32_b1=rel32,
                    max_abs_err=abs_err), y

    def check_space(space, ess, kind, label):
        op = SeparableLattice(space, torch.float64, "cuda")
        op32 = SeparableLattice(space, torch.float32, "cuda")
        dsop = SeparableDS(op)
        x = rand_pair(space.dof_dims[::-1], kind)
        row, _ = check(x, dsop.bands, op.bands, op32.bands, op.periodic, ess,
                       kind, label)
        return row, x, dsop

    def random_bands(dims, p):
        b64 = _random_bands(dims, p, gen, torch.float64)
        return (tuple(ds_from_f64(b) for b in b64), b64,
                tuple(b.float() for b in b64))

    lz = 1.0 / (2 * 3.141592653589793)
    # p = 1, 2, 4 compiled fixed; 3 and 6 the general instantiation
    small = [LatticeSpace((grid_lines(nx, lx), grid_lines(2, 0.1),
                           grid_lines(3, lz)), p, (per, False, False))
             for per, nx, lx in ((True, 6, 1.0), (False, 5, 12.0))
             for p in (1, 2, 3, 4, 6)]
    small.append(LatticeSpace((grid_lines(5, 1.0), grid_lines(2, 0.1),
                               grid_lines(2, lz)), 1, (True, False, False)))
    rows = []
    for sp in small:
        for ess in (False, True):
            for kind in ("normal", "wide"):
                rows.append(check_space(sp, ess, kind, (
                    f"Dx={sp.dof_dims[0]} Dy={sp.dof_dims[1]} Dz="
                    f"{sp.dof_dims[2]} p={sp.p} "
                    f"{'periodic' if sp.periodic[0] else 'finite'}"))[0])
    # edge lattices, random bands: Dx = 2p+1 periodic (narrower than a
    # tile below p = 4); an odd Dx whose y and z extents are no multiples of
    # the tiles (y split in two tiles)
    for p in (1, 2, 3, 4, 6):
        for dims, per in (((2 * p + 1, 3, 4), True), ((267, 41, 19), True),
                          ((267, 41, 19), False)):
            dsb, b64, b32 = random_bands(dims, p)
            x = rand_pair(dims[::-1], "normal")
            for ess in (False, True):
                rows.append(check(
                    x, dsb, b64, b32, (per, False, False), ess, "normal",
                    f"{'x'.join(map(str, dims))} p={p} "
                    f"{'periodic' if per else 'finite'} tiles "
                    f"{choose_ds_tiles(dims, p)[:3]}")[0])
    # a contiguous view one element into its storage (both streams): the
    # interior tiles' 16-byte copies would be misaligned, so the kernel
    # copies by value, to the bits of an aligned copy
    dims = (64, 9, 6)
    n = dims[0] * dims[1] * dims[2]
    for p in (1, 2, 4):
        dsb, b64, b32 = random_bands(dims, p)
        buf = rand_pair((n + 1,), "normal")
        x = DS(buf.hi[1:].view(dims[::-1]), buf.lo[1:].view(dims[::-1]))
        assert x.hi.data_ptr() % 16 and x.lo.data_ptr() % 16
        for per in (True, False):
            row, y = check(x, dsb, b64, b32, (per, False, False), False,
                           "normal", f"64x9x6 p={p} view 4 bytes in")
            aligned = sep_apply_ds(x.hi.clone(), x.lo.clone(), dsb,
                                   (per, False, False))
            row["aligned_bitwise"] = same(y, aligned)
            if not row["aligned_bitwise"]:
                raise AssertionError(f"sep_apply_ds on a misaligned view "
                                     f"differs from an aligned copy: p={p}")
            rows.append(row)

    # the ss.cpp fine lattice, the only level the DS outer runs at
    fine = _main_lattices()[0]
    dims = "x".join(str(d) for d in fine.dof_dims[::-1])
    b1 = {(r["dtype"], r["ess_top"]): r for r in report["sep_apply_times"]
          if r["level"] == 0}
    times = []
    head = None
    for ess in (True, False):
        for kind in ("normal", "wide"):
            row, x, dsop = check_space(fine, ess, kind,
                                       f"ss.cpp fine p=4 {dims}")
            rows.append(row)
        fn = lambda h, lo: sep_apply_ds(h, lo, dsop.bands, dsop.periodic,
                                        ess)
        ms = _time_chain(fn, [(x.hi, x.lo)])
        acts = _profile_calls(fn, [(x.hi, x.lo)])
        dev = _device_ms(fn, [(x.hi, x.lo)], B4_KERNEL, acts)
        act = _per_call(acts)
        print(f"[2] sep_apply_ds ess_top={int(ess)} on the device: "
              f"{act['kernels_per_call']:.2f} kernels per call recorded "
              f"({act['launch_ms']:.4f} ms per launch), {act['memsets']} "
              f"memsets, {act['copies']} copies")
        if (len(act["kernels"]) != 1 or act["kernels_per_call"] > 1
                or act["memsets"] or act["copies"]):
            raise AssertionError(f"B4 calls ran {act} (one kernel, no "
                                 "memset or copy)")
        plain = (_time_chain(lambda h, lo: sep_apply_ds_reference(
            h, lo, dsop.bands, dsop.periodic, ess), [(x.hi, x.lo)])
            if ess else None)
        n, p = fine.n_dofs, fine.p
        # xh, xl read once, yh, yl written once, the twelve band tables
        nbytes = 4 * (4 * n + 4 * (2 * p + 1) * sum(fine.dof_dims))
        ins = _ds_instructions(fine.dof_dims, p, fine.periodic[0], ess)
        bound, by = _bound(nbytes, ins, FP32_ISSUE_PER_S)
        ref = b1[("float64", True)]
        row = dict(p=p, dims=dims, ess_top=ess, ms=dev if dev is not None
                   else ms, call_ms=ms, device_ms=dev, plain_ms=plain,
                   max_abs_err=max(r["max_abs_err"] for r in rows),
                   bound_ms=bound, bound_by=by,
                   bound_counts="float32 instructions (an fma as one) at "
                   f"{FP32_ISSUE_PER_S:.3g}/s",
                   instructions=ins, bytes=nbytes, library_ms=None,
                   b1_f64_ms=ref["ms"], spmv_f64_ms=ref["library_ms"],
                   launch_ms=act["launch_ms"],
                   kernels_per_call_recorded=act["kernels_per_call"],
                   launches_per_call=len(act["kernels"]),
                   tiles=choose_ds_tiles(fine.dof_dims, p))
        times.append(row)
        print(f"[2] time sep_apply_ds p={p} {dims} ess_top={int(ess)} tiles "
              f"{row['tiles'][:3]}: kernel {row['ms']:.4f} ms on the device "
              f"({ms:.4f} ms per call, host included), plain "
              f"{'%.4f ms' % plain if plain else 'not timed'}, bound "
              f"{bound:.4f} ms ({by}: {ins} float32 instructions at "
              f"{FP32_ISSUE_PER_S:.3g}/s, {nbytes} bytes); no PyTorch call "
              f"computes a DS apply: float64 B1 {ref['ms']:.4f} ms, float64 "
              f"cuSPARSE SpMV {ref['library_ms']:.4f} ms")
        if ess:
            head = row
    report["sep_apply_ds_checks"] = rows
    report["sep_apply_ds_times"] = times
    return head


B1_KERNEL = ("sep_tile_kernel",)
B4_KERNEL = ("ds_tile_kernel",)

_CATEGORIES = (("B4 sep_apply_ds", B4_KERNEL),
               ("B3b pa_apply_element", ("pa_element_kernel",)),
               ("B3a pa_apply_affine", ("pa_affine_kernel",)),
               ("B2 lattice_affine_apply", ("lattice_affine_kernel",
                                            "lattice_affine_fold")),
               ("B1 sep_apply", B1_KERNEL),
               ("matmul", ("gemm", "gemv", "Gemm", "Gemv", "cutlass",
                           "dot_kernel", "splitKreduce")),
               ("reductions", ("reduce", "Reduce")),
               ("elementwise", ("elementwise", "Elementwise", "vectorized")))


def _profile_step(prob, state, t0: float) -> dict:
    """One RK4 step under torch.profiler (outside every timed window):
    device kernel time by category, kernel count, and the device busy share
    (union of kernel intervals over the step's wall)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # device activity only: host-op events would multiply the ~10^5 events
    # of a diffraction step that the profiler processes on the host
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_wall = time.perf_counter()
        prob.run(n_steps=1, t0=t0, state=state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_wall
    spans = []
    cats = {name: [0.0, 0] for name, _ in _CATEGORIES}
    cats["copies, cat, index, fill"] = [0.0, 0]
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        name = next((c for c, keys in _CATEGORIES
                     if any(k in e.name for k in keys)),
                    "copies, cat, index, fill")
        cats[name][0] += (b - a) / 1e3
        cats[name][1] += 1
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    total = sum(v[0] for v in cats.values())
    return dict(wall_ms=1e3 * wall, device_ms=total,
                busy_share=busy / 1e3 / (1e3 * wall), kernels=len(spans),
                by_category={k: dict(ms=v[0], share=v[0] / total if total
                                     else 0.0, kernels=v[1])
                             for k, v in cats.items()})


def _print_profile(tag: str, prof: dict) -> None:
    print(f"{tag} profiled RK4 step: wall {prof['wall_ms']:.1f} ms "
          f"(profiler on), device kernel time {prof['device_ms']:.2f} ms, "
          f"busy share {prof['busy_share']:.3f}, {prof['kernels']} kernels")
    for k, v in sorted(prof["by_category"].items(),
                       key=lambda kv: -kv[1]["ms"]):
        print(f"{tag}   {k:26s} {v['ms']:9.3f} ms  {v['share']:.3f}  "
              f"{v['kernels']} kernels")


def _sync_round_trip_us(reps: int = 200) -> float:
    import torch
    flag = torch.ones((), device="cuda") > 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        bool(flag)
    return (time.perf_counter() - t0) / reps * 1e6


def _zero_counts():
    from lpfem_torch.kernels import (cheb_step, coarse_cheb, lattice_apply,
                                     pa_apply, sep_apply, sep_apply_ds)
    coarse_cheb.LAUNCHES.clear()
    cheb_step.LAUNCHES = 0
    cheb_step.LAUNCHES_BY_DTYPE.clear()
    sep_apply.LAUNCHES = 0
    sep_apply.LAUNCHES_BY_P.clear()
    pa_apply.LAUNCHES = 0
    pa_apply.LAUNCHES_BY_P.clear()
    pa_apply.LAUNCHES_AFFINE = 0
    pa_apply.LAUNCHES_AFFINE_BY_P.clear()
    lattice_apply.LAUNCHES = 0
    lattice_apply.LAUNCHES_BY_P.clear()
    sep_apply_ds.LAUNCHES = 0


@contextlib.contextmanager
def _count_vcycles():
    """Count the calls of ``PMultigrid.__call__`` (V-cycles) in the block:
    yields a one-element list that holds the count."""
    from lpfem_torch import multigrid
    calls = [0]
    orig = multigrid.PMultigrid.__call__

    def counted(self, r):
        calls[0] += 1
        return orig(self, r)

    multigrid.PMultigrid.__call__ = counted
    try:
        yield calls
    finally:
        multigrid.PMultigrid.__call__ = orig


def _read_counts() -> dict:
    from lpfem_torch.kernels import (cheb_step, coarse_cheb, lattice_apply,
                                     pa_apply, sep_apply, sep_apply_ds)
    return {"sep_apply": sep_apply.LAUNCHES,
            "coarse_cheb": sum(coarse_cheb.LAUNCHES.values()),
            "coarse_cheb_by_dtype": dict(coarse_cheb.LAUNCHES),
            "cheb_step": cheb_step.LAUNCHES,
            "cheb_step_by_dtype": dict(cheb_step.LAUNCHES_BY_DTYPE),
            "pa_apply_element": pa_apply.LAUNCHES,
            "pa_apply_affine": pa_apply.LAUNCHES_AFFINE,
            "lattice_affine_apply": lattice_apply.LAUNCHES,
            "sep_apply_ds": sep_apply_ds.LAUNCHES,
            "sep_apply_by_p": dict(sorted(sep_apply.LAUNCHES_BY_P.items())),
            "pa_apply_element_by_p": dict(sorted(
                pa_apply.LAUNCHES_BY_P.items())),
            "pa_apply_affine_by_p": dict(sorted(
                pa_apply.LAUNCHES_AFFINE_BY_P.items())),
            "lattice_affine_apply_by_p": dict(sorted(
                lattice_apply.LAUNCHES_BY_P.items()))}


def phase_ss_path(report: dict) -> int:
    import torch
    import lpfem_torch

    cfg = lpfem_torch.preset("scaling_base", **CFG)
    torch.cuda.reset_peak_memory_stats()     # phase 2 assembled matrices
    t0 = time.perf_counter()
    prob = lpfem_torch.Problem(cfg, device="cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    n = prob.space.n_dofs
    ns = prob.surf.n_dofs
    print(f"[3] setup {setup:.2f} s: {n} dofs {prob.space.dof_dims}, "
          f"{ns} surface dofs, p-MG levels "
          f"{[lv.op.space.dof_dims for lv in prob.precond.levels]}, "
          f"lmax {prob.precond.lmax}")
    if n != 2_179_584:
        raise AssertionError(f"expected 2,179,584 dofs, got {n}")

    y0, phi0 = prob.initial_state()
    _, cold = prob.fso.solve_laplace(y0[ns:], phi0)
    print(f"[3] cold solve: {cold.iters} inner CG iterations (JAX reference "
          f"on TPU: {EXPECTED_COLD_ITERS}), converged={cold.converged}, "
          f"{cold.syncs} host syncs")
    if not cold.converged:
        raise AssertionError("cold solve did not converge")

    prob.run(n_steps=1)                                   # warm-up
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    t, y, phi = prob.run(n_steps=N_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    launches = counts["sep_apply"]
    stats = prob.last_solver_stats
    prob.check_state(y, phi)
    if stats.unconverged:
        raise AssertionError(f"a solve did not converge: {stats}")
    if stats.n_solves != 4 * N_STEPS:
        raise AssertionError(f"expected {4 * N_STEPS} solves, ran "
                             f"{stats.n_solves} (the run stopped early)")
    if launches <= 0 or counts["cheb_step"] <= 0:
        raise AssertionError(f"the ss.cpp path launched no sep_apply or no "
                             f"cheb_step kernel: {counts}")
    err_protocol = prob.eta_error_inf(y, t, quad=False)
    print(f"[3] protocol run ends at t = {t:.6f} (T = {prob.t_final:.6f}); "
          f"nodal eta error inf {err_protocol:.3e} (dt = T/{N_STEPS} is "
          "beyond RK4's stability limit for the fastest discrete surface "
          "modes at this resolution, so this number is not an accuracy "
          "check)")
    rate = n * 4 * N_STEPS / wall
    sync_us = _sync_round_trip_us()
    print(f"[3] {N_STEPS} RK4 steps = {stats.n_solves} solves: wall "
          f"{wall:.3f} s, {rate:.4e} dof*solves/s, {stats.total_iters} "
          f"inner CG iterations (max {stats.max_iters} per solve), "
          f"{stats.syncs} host syncs ({stats.syncs / stats.n_solves:.1f} per "
          f"solve, idle round trip {sync_us:.1f} us each), launches {counts}")
    b1_by_p = {p: c / N_STEPS for p, c in counts["sep_apply_by_p"].items()}
    print(f"[3] B1 sep_apply calls per RK4 step by order p: {b1_by_p}")
    report["ss_path"] = dict(b1_calls_per_step_by_p=b1_by_p,
        dofs=n, surface_dofs=ns, setup_s=setup, wall_s=wall,
        dof_solves_per_s=rate, n_solves=stats.n_solves,
        cold_solve_iters=cold.iters, expected_cold_iters=EXPECTED_COLD_ITERS,
        total_inner_iters=stats.total_iters, max_iters=stats.max_iters,
        syncs=stats.syncs, sync_round_trip_us=sync_us, launches=counts,
        eta_error_inf_protocol=err_protocol, t=t, lmax=prob.precond.lmax,
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    y0, phi0 = prob.initial_state()
    prof = _profile_step(prob, (y0, phi0), 0.0)
    prof["busy_share_unprofiled"] = prof["device_ms"] / (1e3 * wall / N_STEPS)
    _print_profile("[3]", prof)
    print(f"[3] device time over the unprofiled step wall "
          f"{prof['busy_share_unprofiled']:.3f}")
    report["ss_path"]["profile"] = prof

    # accuracy: the same configuration over one period at a stable step
    acc = lpfem_torch.Problem(
        lpfem_torch.preset("scaling_base", **CFG, nsteps=ACCURACY_STEPS),
        device="cuda", lmax=prob.precond.lmax)
    t, y, phi = acc.run()
    acc.check_state(y, phi)
    if acc.last_solver_stats.unconverged:
        raise AssertionError(f"a solve did not converge: "
                             f"{acc.last_solver_stats}")
    err = acc.eta_error_inf(y, t, quad=False)
    print(f"[3] accuracy run, {ACCURACY_STEPS} RK4 steps over one period: "
          f"t = {t:.6f} (T = {acc.t_final:.6f}), nodal eta error inf "
          f"{err:.3e} (limit 0.1 H = {0.1 * cfg.H:.1e}), "
          f"{acc.last_solver_stats.total_iters} inner CG iterations")
    if not (abs(t - acc.t_final) < 1e-9 * acc.t_final and err < 0.1 * cfg.H):
        raise AssertionError(f"eta error {err} at t={t} fails 0.1 H")
    report["accuracy"] = dict(nsteps=ACCURACY_STEPS, eta_error_inf_nodal=err,
                              t=t, total_inner_iters=acc.last_solver_stats
                              .total_iters)
    return dict(launches=launches, err=err, lmax=prob.precond.lmax,
                wall=wall, eta=y[:ns].clone(), busy=prof["busy_share"])


def phase_diffraction(report: dict) -> int:
    import torch
    from lpfem_torch.experiments.diffraction import build_problem

    mesh = _study_mesh()
    runs = {}
    for dtype in ("float64", "mixed"):
        t0 = time.perf_counter()
        prob = build_problem("cuda", dtype=dtype, mesh=mesh)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        n, ns = prob.space.n_dofs, prob.surf.n_dofs
        if n != CYL_DOFS:
            raise AssertionError(f"expected {CYL_DOFS} dofs, got {n}")
        coarse = prob.precond.coarse_route
        if coarse != "fused":
            raise AssertionError(f"{dtype}: the study's coarse route is "
                                 f"{coarse!r}, not 'fused'")
        print(f"[4] {dtype}: setup {setup:.2f} s: {prob.space.mesh.n_elems} "
              f"curved hexes, {n} dofs {prob.space.dof_dims}, {ns} surface "
              f"dofs, p-MG orders {prob.precond.orders}, coarse {coarse}, "
              f"T = {prob.wave.T:.5f}, dt = {prob.dt:.5f}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        with _count_vcycles() as vcycles:
            t0 = time.perf_counter()
            t, y, phi = prob.run(n_steps=CYL_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = _read_counts()
        stats = prob.last_solver_stats
        prob.check_state(y, phi)
        # the fused coarse solve: one launch a V-cycle, in the dtype of the
        # preconditioner's operator (float32 in the mixed run), and in the
        # float64 run one V-cycle an iteration and one a solve
        cc_dtype = str(prob.precond.levels[-1].op.dtype).removeprefix(
            "torch.")
        cc_want = {cc_dtype: vcycles[0]}
        if counts["coarse_cheb_by_dtype"] != cc_want or (
                dtype == "float64"
                and vcycles[0] != stats.total_iters + stats.n_solves):
            raise AssertionError(
                f"{dtype}: coarse_cheb launches "
                f"{counts['coarse_cheb_by_dtype']} over {vcycles[0]} "
                f"V-cycles ({stats.total_iters} iterations, "
                f"{stats.n_solves} solves)")
        if stats.unconverged:
            raise AssertionError(f"a solve did not converge: {stats}")
        if stats.n_solves != 4 * CYL_STEPS:
            raise AssertionError(f"expected {4 * CYL_STEPS} solves, ran "
                                 f"{stats.n_solves}")
        if counts["pa_apply_element"] <= 0:
            raise AssertionError("the diffraction path launched no "
                                 "pa_apply_element kernel")
        eta = y[:ns].double()
        amax = float(eta.abs().max())
        if not 0.0 < amax < prob.cfg.H:
            raise AssertionError(f"max|eta| = {amax} outside (0, H)")
        peak = torch.cuda.max_memory_allocated()
        print(f"[4] {dtype}: {CYL_STEPS} RK4 steps = {stats.n_solves} solves "
              f"to t = {t:.5f}: wall {wall:.3f} s, {stats.total_iters} inner "
              f"CG iterations (max {stats.max_iters} per solve), "
              f"{stats.syncs} host syncs, {vcycles[0]} V-cycles, launches "
              f"{counts}, max|eta| "
              f"{amax:.5f}, peak device memory {peak / 1e6:.0f} MB")
        b3b_by_p = {p: c / CYL_STEPS
                    for p, c in counts["pa_apply_element_by_p"].items()}
        print(f"[4] {dtype}: B3b pa_apply_element calls per RK4 step by "
              f"order p: {b3b_by_p}")
        prof = None
        if dtype == "float64":
            prof = _profile_step(prob, (y, phi), t)
            prof["busy_share_unprofiled"] = (
                prof["device_ms"] / (1e3 * wall / CYL_STEPS))
            _print_profile(f"[4] {dtype}:", prof)
            print(f"[4] {dtype}: device time over the unprofiled step wall "
                  f"{prof['busy_share_unprofiled']:.3f}")
        runs[dtype] = dict(eta=eta.cpu(), record=dict(profile=prof,
            dofs=n, surface_dofs=ns, setup_s=setup, wall_s=wall,
            n_solves=stats.n_solves, total_inner_iters=stats.total_iters,
            max_iters=stats.max_iters, syncs=stats.syncs, launches=counts,
            vcycles=vcycles[0], coarse_route=coarse,
            b3b_calls_per_step_by_p=b3b_by_p,
            max_abs_eta=amax, t=t, peak_mem_bytes=peak,
            lmax=prob.precond.lmax))
        del prob, y, phi
        torch.cuda.empty_cache()
    d = float((runs["mixed"]["eta"] - runs["float64"]["eta"]).abs().max())
    amax = runs["float64"]["record"]["max_abs_eta"]
    print(f"[4] mixed vs float64 final eta: max abs diff {d:.3e} "
          f"(limit 1e-2 max|eta| = {1e-2 * amax:.3e})")
    if not d <= 1e-2 * amax:
        raise AssertionError(f"mixed run's eta differs by {d}")
    report["diffraction"] = {k: v["record"] for k, v in runs.items()}
    report["diffraction"]["mixed_vs_f64_max_abs_diff"] = d
    return sum(v["record"]["launches"]["pa_apply_element"]
               for v in runs.values())


def _run_period(tag, prob, cfg, kernel, what, report_key, report,
                profile=False):
    """One wave period (``cfg.nsteps`` RK4 steps) of ``prob`` with the
    launch counts set to 0 just before and read just after; requires every
    solve converged, a finite state, launches of ``kernel`` and the nodal
    eta error below 0.1 H. Returns (error, launches)."""
    import torch
    n, ns = prob.space.n_dofs, prob.surf.n_dofs
    y0, phi0 = prob.initial_state()
    _, cold = prob.fso.solve_laplace(y0[ns:], phi0)
    print(f"{tag} cold solve: {cold.iters} inner CG iterations, "
          f"converged={cold.converged}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    t, y, phi = prob.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    stats = prob.last_solver_stats
    prob.check_state(y, phi)
    if stats.unconverged or not cold.converged:
        raise AssertionError(f"a solve did not converge: {stats}")
    if stats.n_solves != 4 * cfg.nsteps:
        raise AssertionError(f"expected {4 * cfg.nsteps} solves, ran "
                             f"{stats.n_solves}")
    if counts[kernel] <= 0:
        raise AssertionError(f"{what} launched no {kernel} kernel")
    err = prob.eta_error_inf(y, t, quad=False)
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag} {cfg.nsteps} RK4 steps = {stats.n_solves} solves over one "
          f"period: wall {wall:.3f} s, {n * stats.n_solves / wall:.4e} "
          f"dof*solves/s, {stats.total_iters} inner CG iterations (max "
          f"{stats.max_iters} per solve), {stats.syncs} host syncs, launches "
          f"{counts}, nodal eta error inf {err:.3e} (limit 0.1 H = "
          f"{0.1 * cfg.H:.1e}), peak device memory {peak / 1e6:.0f} MB")
    if not (abs(t - prob.t_final) < 1e-9 * prob.t_final
            and err < 0.1 * cfg.H):
        raise AssertionError(f"eta error {err} at t={t} fails 0.1 H")
    by_p = {p: c / cfg.nsteps
            for p, c in counts.get(f"{kernel}_by_p", {}).items()}
    print(f"{tag} {kernel} calls per RK4 step by order p: {by_p}")
    report[report_key] = dict(launches_per_step_by_p=by_p,
        dofs=n, surface_dofs=ns, wall_s=wall, n_solves=stats.n_solves,
        cold_solve_iters=cold.iters, total_inner_iters=stats.total_iters,
        max_iters=stats.max_iters, syncs=stats.syncs, launches=counts,
        eta_error_inf_nodal=err, t=t, peak_mem_bytes=peak,
        lmax=prob.precond.lmax)
    if profile:
        prof = _profile_step(prob, (y, phi), t)
        prof["busy_share_unprofiled"] = (prof["device_ms"]
                                         / (1e3 * wall / cfg.nsteps))
        _print_profile(tag, prof)
        print(f"{tag} device time over the unprofiled step wall "
              f"{prof['busy_share_unprofiled']:.3f}")
        report[report_key]["profile"] = prof
    return err, counts[kernel]


def phase_general_mesh(report: dict, ss_err: float) -> dict:
    import torch
    import lpfem_torch
    from lpfem_torch.experiments.leaning_tank import leaning_tank
    from lpfem_torch.mesh import make_wave_tank, save_mfem
    from lpfem_torch.operators import (AffineLatticeLaplace, ElementLaplace,
                                       SeparableLattice)

    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    dims, sizes = _tank_dims()
    launches = {}

    # ---- path A: leaning along z, lattice declared -> B2
    cfg = lpfem_torch.preset("scaling_base", **CFG, **LEAN,
                             nsteps=ACCURACY_STEPS)
    t0 = time.perf_counter()
    prob = lpfem_torch.Problem(cfg, device="cuda", mesh=_leaning_mesh())
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    levels = prob.precond.levels
    coarse = prob.precond.coarse_route
    print(f"[5A] setup {setup:.2f} s: {prob.space.mesh.n_elems} leaning "
          f"hexes, {prob.space.n_dofs} dofs {prob.space.dof_dims}, operator "
          f"{type(prob.op).__name__}, p-MG levels "
          f"{[lv.op.space.dof_dims for lv in levels]} ({coarse} coarse "
          f"solve), trace fast path {prob.fso.zderiv.jz is not None}, lmax "
          f"{prob.precond.lmax}")
    if prob.space.n_dofs != 2_179_584:
        raise AssertionError(f"expected 2,179,584 dofs, got "
                             f"{prob.space.n_dofs}")
    for op in (prob.op, prob.op_hi, *(lv.op for lv in levels)):
        if type(op) is not AffineLatticeLaplace:
            raise AssertionError(f"path A runs {type(op).__name__}, not the "
                                 "fused affine lattice operator")
    err, launches["A"] = _run_period(
        "[5A]", prob, cfg, "lattice_affine_apply", "path A", "path_a",
        report, profile=True)
    report["path_a"]["setup_s"] = setup
    print(f"[5A] eta error {err:.3e} against {ss_err:.3e} on the unsheared "
          f"tank (phase 3): ratio {err / ss_err:.2f} (limit 10)")
    if not err < 10.0 * ss_err:
        raise AssertionError(f"path A's eta error {err} is not within a "
                             f"factor 10 of phase 3's {ss_err}")
    del prob, levels
    torch.cuda.empty_cache()

    # ---- path B: leaning along y, through a mesh file -> B3a
    path = out / "leaning-y.mesh"
    save_mfem(leaning_tank(*dims, *sizes, lean="y", declare=False), str(path))
    cfg = lpfem_torch.preset(
        "scaling_base", **{**CFG, "ref_levels": PATH_B_REF_LEVELS}, **LEAN,
        nsteps=ACCURACY_STEPS, mesh_kind="mfem", mesh_file=str(path))
    t0 = time.perf_counter()
    prob = lpfem_torch.Problem(cfg, device="cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    sp = prob.space
    print(f"[5B] host set-up {setup:.2f} s (load, {PATH_B_REF_LEVELS} "
          f"refinement(s), topological numbering, operators): "
          f"{sp.mesh.n_elems} hexes, {sp.n_dofs} dofs, lattice "
          f"{sp.struct is not None}, z-extruded {sp.extruded is not None}, "
          f"operator {type(prob.op).__name__} (affine metric "
          f"{prob.op.C64 is not None}), trace layout "
          f"{prob.fso.zderiv.layout}, p-MG orders {prob.precond.orders}")
    if sp.struct is not None or sp.extruded is None:
        raise AssertionError("path B's mesh should have no lattice and be "
                             "z-extruded")
    for op in (prob.op, prob.op_hi, *(lv.op for lv in prob.precond.levels)):
        if type(op) is not ElementLaplace or op.C64 is None:
            raise AssertionError("path B should run the affine element "
                                 "operator on every level")
    _, launches["B"] = _run_period(
        "[5B]", prob, cfg, "pa_apply_affine", "path B", "path_b", report,
        profile=True)
    report["path_b"]["setup_s"] = setup
    del prob
    torch.cuda.empty_cache()

    # ---- path C: the unsheared tank through a mesh file -> B1
    path = out / "plain.mesh"
    save_mfem(make_wave_tank(*dims, *sizes), str(path))
    kw = {**CFG, "ref_levels": 1, "nsteps": ACCURACY_STEPS}   # a stable dt
    loaded = lpfem_torch.Problem(lpfem_torch.preset(
        "scaling_base", **kw, mesh_kind="mfem", mesh_file=str(path)),
        device="cuda")
    if type(loaded.op) is not SeparableLattice:
        raise AssertionError(f"path C runs {type(loaded.op).__name__}, not "
                             "the Kronecker operator")
    made = lpfem_torch.Problem(lpfem_torch.preset("scaling_base", **kw),
                               device="cuda", lmax=loaded.precond.lmax)
    _zero_counts()
    _, y_l, phi_l = loaded.run(n_steps=PATH_C_STEPS)
    torch.cuda.synchronize()
    counts = _read_counts()
    _, y_m, phi_m = made.run(n_steps=PATH_C_STEPS)
    loaded.check_state(y_l, phi_l)
    if loaded.last_solver_stats.unconverged:
        raise AssertionError("path C: a solve did not converge")
    launches["C"] = counts["sep_apply"]
    if launches["C"] <= 0:
        raise AssertionError("path C launched no sep_apply kernel")
    # the loaded tank's surface order is the mesh's; the generated tank's is
    # the top plane in lattice order
    Dx, Dy, Dz = made.space.dof_dims
    perm = torch.as_tensor(loaded.surf.surf_to_vol - Dx * Dy * (Dz - 1),
                           device="cuda")
    ns = made.surf.n_dofs
    d_eta = float((y_l[:ns] - y_m[:ns][perm]).abs().max())
    d_phi = float((phi_l - phi_m).abs().max())
    print(f"[5C] the unsheared tank loaded from a file: "
          f"{loaded.space.n_dofs} dofs, operator SeparableLattice, "
          f"{PATH_C_STEPS} RK4 steps, launches {counts}; against the "
          f"generated tank max|eta diff| {d_eta:.2e}, max|phi diff| "
          f"{d_phi:.2e} (limit 1e-12)")
    c_by_p = {p: c / PATH_C_STEPS
              for p, c in counts["sep_apply_by_p"].items()}
    print(f"[5C] B1 sep_apply calls per RK4 step by order p: {c_by_p}")
    if not (d_eta <= 1e-12 and d_phi <= 1e-12):
        raise AssertionError("path C disagrees with the generated tank")
    report["path_c"] = dict(dofs=loaded.space.n_dofs, launches=counts,
                            max_eta_diff=d_eta, max_phi_diff=d_phi)
    return launches


def phase_ds_path(report: dict, ss: dict) -> int:
    """Phase 3's protocol and accuracy run with the double-single outer
    loop (``hi_apply="ds"``): the outer residuals on B4."""
    import torch
    import lpfem_torch

    cfg = lpfem_torch.preset("scaling_base", **CFG, hi_apply="ds")
    t0 = time.perf_counter()
    prob = lpfem_torch.Problem(cfg, device="cuda", lmax=ss["lmax"])
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    if prob.fso._ds_op is None:
        raise AssertionError("hi_apply='ds' did not engage the DS outer")
    n, ns = prob.space.n_dofs, prob.surf.n_dofs
    y0, phi0 = prob.initial_state()
    _, cold = prob.fso.solve_laplace(y0[ns:], phi0)
    print(f"[6] setup {setup:.2f} s; cold solve: {cold.iters} inner CG "
          f"iterations (JAX reference on TPU, this outer loop: "
          f"{EXPECTED_COLD_ITERS}), converged={cold.converged}, "
          f"{cold.syncs} host syncs")
    if not cold.converged:
        raise AssertionError("cold DS solve did not converge")

    prob.run(n_steps=1)                                   # warm-up
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    t, y, phi = prob.run(n_steps=N_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    stats = prob.last_solver_stats
    prob.check_state(y, phi)
    if stats.unconverged:
        raise AssertionError(f"a DS solve did not converge: {stats}")
    if stats.n_solves != 4 * N_STEPS:
        raise AssertionError(f"expected {4 * N_STEPS} solves, ran "
                             f"{stats.n_solves}")
    if counts["sep_apply_ds"] <= 0:
        raise AssertionError("the DS path launched no sep_apply_ds kernel")
    rate = n * 4 * N_STEPS / wall
    print(f"[6] {N_STEPS} RK4 steps = {stats.n_solves} solves: wall "
          f"{wall:.3f} s ({ss['wall']:.3f} s with the float64 outer, phase "
          f"3), {rate:.4e} dof*solves/s, {stats.total_iters} inner CG "
          f"iterations (max {stats.max_iters} per solve), {stats.syncs} host "
          f"syncs, launches {counts}")
    report["ds_path"] = dict(
        setup_s=setup, wall_s=wall, dof_solves_per_s=rate,
        n_solves=stats.n_solves, cold_solve_iters=cold.iters,
        total_inner_iters=stats.total_iters, max_iters=stats.max_iters,
        syncs=stats.syncs, launches=counts, f64_outer_wall_s=ss["wall"])

    acc = lpfem_torch.Problem(
        lpfem_torch.preset("scaling_base", **CFG, hi_apply="ds",
                           nsteps=ACCURACY_STEPS),
        device="cuda", lmax=ss["lmax"])
    t_a, y_a, phi_a = acc.run()
    acc.check_state(y_a, phi_a)
    if acc.last_solver_stats.unconverged:
        raise AssertionError(f"a DS solve did not converge: "
                             f"{acc.last_solver_stats}")
    err = acc.eta_error_inf(y_a, t_a, quad=False)
    eta = y_a[:ns]
    d = float((eta - ss["eta"]).abs().max())
    amax = float(ss["eta"].abs().max())
    print(f"[6] accuracy run, {ACCURACY_STEPS} RK4 steps over one period: "
          f"nodal eta error inf {err:.3e} (float64 outer {ss['err']:.3e}, "
          f"limits 0.1 H and 1 %), max|eta_ds - eta_f64| {d:.3e} (limit "
          f"1e-5 max|eta| = {1e-5 * amax:.3e}), "
          f"{acc.last_solver_stats.total_iters} inner CG iterations")
    if not (abs(t_a - acc.t_final) < 1e-9 * acc.t_final
            and err < 0.1 * cfg.H and abs(err - ss["err"]) <= 0.01 * ss["err"]
            and d <= 1e-5 * amax):
        raise AssertionError(f"DS accuracy run: error {err} against "
                             f"{ss['err']}, eta difference {d}")
    report["ds_path"].update(eta_error_inf_nodal=err, eta_max_abs_diff=d,
                             accuracy_inner_iters=acc.last_solver_stats
                             .total_iters)
    del acc
    prof = _profile_step(prob, (y, phi), t)
    prof["busy_share_unprofiled"] = prof["device_ms"] / (1e3 * wall / N_STEPS)
    _print_profile("[6]", prof)
    b4 = prof["by_category"]["B4 sep_apply_ds"]
    print(f"[6] device time over the unprofiled step wall "
          f"{prof['busy_share_unprofiled']:.3f} (float64 outer, phase 3: "
          f"{ss['busy']:.3f} profiled); B4: "
          f"{counts['sep_apply_ds'] / N_STEPS:.1f} calls per RK4 step in the "
          f"timed run, {b4['kernels']} kernels ({b4['ms']:.3f} ms) in the "
          f"profiled step")
    report["ds_path"]["profile"] = prof
    report["ds_path"]["b4_calls_per_step"] = counts["sep_apply_ds"] / N_STEPS
    return counts["sep_apply_ds"]


BENCH_DOFS = {1: 282_880, 2: 2_179_584, 3: 17_105_920, 4: 135_530_496}
# data/laplace-pconv-phi.txt (the JAX package's float64 p-sweep): the limits
# of phase 8's float64 and mixed sweeps (1.5x the committed err_inf up to
# p = 8; at p = 9, 10 the round-off floor, at most 1e-13); the same ratio
# holds phase 8's p = 4 dynamic case to data/pf-parallel-pconv-eta.txt
CONV_RATIO = 1.5
CONV_FLOOR = 1e-13
PF_RUN_STEPS = 40      # the flagship's 5 T in 40 steps (20 diverge: dt = T/4
                       # is past RK4's limit for the fastest surface modes)


def _gib(b) -> str:
    return "n/a" if b is None else f"{b / 2 ** 30:.3f} GiB"


def _bench_row(args, refs: int, tag: str, **kw) -> dict:
    """One ``bench_once`` row with the launch counts set to 0 just before
    and read just after; requires the protocol's dofs, a converged cold
    solve, every timed stage converged, B1 launches and value = dofs x
    solves / wall, recomputed from the protocol's dofs and the median of
    the measured walls (rounded to 0.1 ms, hence the 1e-4 relative)."""
    import torch
    from lpfem_torch import bench
    torch.cuda.empty_cache()
    _zero_counts()
    r = bench.bench_once(args, refs, **kw)
    r["launches"] = _read_counts()
    print(f"[7] {tag}: {json.dumps(r)}")
    print(f"[7] {tag}: {r['n_dofs']} dofs, set-up {r['setup_s']:.2f} s, "
          f"wall {r['wall_s']:.4f} s (walls {r['walls']}) -> "
          f"{r['value']:.4e} dof*solves/s; timed stages all converged "
          f"{not r['unconverged_steps']} ({r['timed_inner_iters']} inner CG "
          f"iterations); cold solve {r['cg_iters']} inner "
          f"CG iterations (converged {r['cold_converged']}); apply "
          f"{r['apply_ms']:.4f} ms; peak device memory "
          f"{_gib(r['peak_device_mem_bytes'])}, peak host RSS "
          f"{_gib(r['peak_rss_bytes'])}; B1 calls by p "
          f"{r['launches']['sep_apply_by_p']}")
    if r["n_dofs"] != BENCH_DOFS[refs]:
        raise AssertionError(f"refs={refs}: {r['n_dofs']} dofs, expected "
                             f"{BENCH_DOFS[refs]}")
    if not r["cold_converged"]:
        raise AssertionError(f"{tag}: the cold solve did not converge")
    if r["unconverged_steps"]:
        raise AssertionError(f"{tag}: a timed stage's solve did not converge")
    value = BENCH_DOFS[refs] * 4 * args.steps / statistics.median(r["walls"])
    if abs(r["value"] - value) > 1e-4 * value:
        raise AssertionError(f"{tag}: value {r['value']} is not dofs x "
                             f"solves / median wall = {value}")
    if r["launches"]["sep_apply"] <= 0:
        raise AssertionError(f"{tag}: no sep_apply launch")
    return r


def phase_bench(report: dict) -> dict:
    """The bench twin, ``lpfem_torch.bench.bench_once``: refs 2 with the
    full protocol (10 RK4 steps after a warm-up step, median of 3) and its
    float32 / rtol_sq 1e-8 secondary row; refs 1 and 3 with one repeat;
    refs 4 (135,530,496 dofs) as set-up, a warm-up and one timed RK4 step,
    and the cold solve."""
    from lpfem_torch import bench
    full = bench.parser().parse_args([])
    one = bench.parser().parse_args(["--repeats", "1"])
    step = bench.parser().parse_args(["--repeats", "1", "--steps", "1"])
    print(f"[7] card: {report['nvidia_smi']}")
    rows = {"refs2": _bench_row(full, 2, "refs 2, the protocol")}
    if rows["refs2"]["cg_iters"] != EXPECTED_COLD_ITERS:
        raise AssertionError(f"refs 2: {rows['refs2']['cg_iters']} cold "
                             f"iterations, expected {EXPECTED_COLD_ITERS}")
    rows["refs2_f32"] = _bench_row(full, 2, "refs 2, float32 rtol_sq 1e-8",
                                   dtype="float32", rtol_sq=1e-8)
    rows["refs1"] = _bench_row(one, 1, "refs 1, one repeat")
    rows["refs3"] = _bench_row(one, 3, "refs 3, one repeat")
    rows["refs4"] = _bench_row(step, 4, "refs 4, one RK4 step")
    report["bench"] = rows
    return rows


def _conv_table(dtype: str) -> tuple:
    """``laplace_conv --mode p`` (p = 1..10) in ``dtype``, launch counts set
    to 0 just before and read just after; (table, counts)."""
    import numpy as np
    from lpfem_torch.experiments import laplace_conv
    path = Path("chiprun_out") / f"laplace-pconv-phi-{dtype}.txt"
    path.unlink(missing_ok=True)
    _zero_counts()
    laplace_conv.main(["--mode", "p", "--dtype", dtype, "--out", str(path)])
    return np.loadtxt(path, ndmin=2), _read_counts()


def phase_drivers(report: dict) -> set:
    """The stationary p-sweep in float64 and mixed, the dynamic p = 4 case,
    the preset runner with ParaView output and a resumed checkpoint, and
    ``entry()``'s step. Returns the orders B1 ran at."""
    import numpy as np
    import torch
    import lpfem_torch
    from lpfem_torch import io as lio
    from lpfem_torch.entry import entry
    from lpfem_torch.experiments import pf_conv, pf_run

    out = Path("chiprun_out")
    orders = set()
    ref = np.loadtxt("data/laplace-pconv-phi.txt", ndmin=2)
    rep = report["drivers"] = {}
    for dtype in ("float64", "mixed"):
        t0 = time.perf_counter()
        tab, counts = _conv_table(dtype)
        by_p = counts["sep_apply_by_p"]
        orders |= set(by_p)
        print(f"[8] laplace_conv --mode p --dtype {dtype}: "
              f"{time.perf_counter() - t0:.1f} s, B1 calls by p {by_p}")
        for row, rrow in zip(tab, ref):
            print(f"[8]   p={int(row[0]):2d} dofs={int(row[1]):6d} err_inf="
                  f"{row[2]:.3e} (data {rrow[2]:.3e}, ratio "
                  f"{row[2] / rrow[2]:.3f}) err_l2={row[3]:.3e} (data "
                  f"{rrow[3]:.3e}) iters={int(row[4])} (data "
                  f"{int(rrow[4])}) wall={row[5]:.3f} s")
        rep[f"laplace_conv_{dtype}"] = dict(table=tab.tolist(),
                                            b1_calls_by_p=by_p)
        if not np.array_equal(tab[:, :2], ref[:, :2]):
            raise AssertionError(f"laplace_conv {dtype}: orders / dofs "
                                 "differ from data/laplace-pconv-phi.txt")
        missing = set(range(1, 11)) - set(by_p)
        if missing:
            raise AssertionError(f"laplace_conv {dtype}: B1 not launched at "
                                 f"p = {sorted(missing)}")
        lo = tab[:, 0] <= 8
        if not (np.all(tab[lo, 2] <= CONV_RATIO * ref[lo, 2])
                and np.all(tab[~lo, 2] <= CONV_FLOOR)):
            raise AssertionError(f"laplace_conv {dtype}: err_inf past "
                                 f"{CONV_RATIO}x data (p <= 8) or "
                                 f"{CONV_FLOOR} (p = 9, 10)")

    # the dynamic p-sweep's p = 4 case over one period in 150 steps
    pf_path = out / "pf-parallel-pconv-eta-p4.txt"
    pf_path.unlink(missing_ok=True)
    _zero_counts()
    t0 = time.perf_counter()
    pf_conv.main(["--mode", "p", "--min-order", "4", "--max-order", "4",
                  "--out", str(pf_path)])
    counts = _read_counts()
    orders |= set(counts["sep_apply_by_p"])
    row = np.loadtxt(pf_path, ndmin=2)[0]
    pref = np.loadtxt("data/pf-parallel-pconv-eta.txt", ndmin=2)[3]
    print(f"[8] pf_conv p=4, 150 steps: {time.perf_counter() - t0:.1f} s; "
          f"surface dofs {int(row[1])} (data {int(pref[1])}), eta_err "
          f"{row[2]:.4e} (data {pref[2]:.4e}), w_err {row[3]:.4e} (data "
          f"{pref[3]:.4e}), B1 calls by p {counts['sep_apply_by_p']}")
    rep["pf_conv_p4"] = dict(row=row.tolist(), data=pref.tolist(),
                             b1_calls_by_p=counts["sep_apply_by_p"])
    if not (int(row[1]) == int(pref[1])
            and np.all(row[2:4] <= CONV_RATIO * pref[2:4])):
        raise AssertionError(f"pf_conv p=4: {row} against {pref} (limit "
                             f"{CONV_RATIO}x)")

    # the preset runner: the flagship in 40 steps with ParaView output every
    # 10; then the checkpoint a run stopped at step 20 leaves (written by
    # the library), resumed by the driver, must end on the same bits
    pv = out / "ParaView"
    ck_full, ck_half = out / "pf_run_full.npz", out / "pf_run_step20.npz"
    common = ["--preset", "pf_linear_par_partial", "--nsteps",
              str(PF_RUN_STEPS), "--checkpoint-every", "20"]
    _zero_counts()
    t0 = time.perf_counter()
    t, y, phi = pf_run.main(common + ["--paraview-every", "10",
                                      "--paraview-dir", str(pv),
                                      "--checkpoint", str(ck_full)])
    counts = _read_counts()
    orders |= set(counts["sep_apply_by_p"])
    wall = time.perf_counter() - t0
    cfg = lpfem_torch.preset("pf_linear_par_partial", nsteps=PF_RUN_STEPS)
    prob = lpfem_torch.Problem(cfg, "cuda")
    t20, y20, phi20 = prob.run(n_steps=PF_RUN_STEPS // 2)
    lio.save_checkpoint(str(ck_half), step=PF_RUN_STEPS // 2, t=t20, y=y20,
                        phi=phi20, config=cfg.name)
    t2, y2, phi2 = pf_run.main(common + ["--resume", str(ck_half),
                                         "--checkpoint",
                                         str(out / "pf_run_resumed.npz")])
    ns = prob.surf.n_dofs
    amax = float(y[:ns].abs().max())
    same = t2 == t and torch.equal(y2, y) and torch.equal(phi2, phi)
    vtus = {d.name: len(list(d.glob("*.vtu"))) for d in pv.iterdir()}
    print(f"[8] pf_run pf_linear_par_partial, {PF_RUN_STEPS} steps: "
          f"{wall:.1f} s, max|eta| {amax:.4e} (H = {cfg.H}), resumed from "
          f"step {PF_RUN_STEPS // 2} bit for bit: {same}; ParaView files "
          f"{vtus}; B1 calls by p {counts['sep_apply_by_p']}")
    rep["pf_run"] = dict(wall_s=wall, max_eta=amax, resumed_same=same,
                         vtus=vtus)
    if not (same and 0 < amax < cfg.H):
        raise AssertionError(f"pf_run: resumed bits equal {same}, max|eta| "
                             f"{amax}")
    if vtus != {f"{cfg.name}_vol": 4, f"{cfg.name}_fs": 4}:
        raise AssertionError(f"pf_run ParaView output: {vtus}")

    # entry(): one RK4 step of the flagship at entry size, against the CPU
    fn, args = entry()
    _zero_counts()
    y, phi = fn(*args)
    torch.cuda.synchronize()
    counts = _read_counts()
    orders |= set(counts["sep_apply_by_p"])
    fc, ac = entry("cpu")
    yc, phic = fc(*ac)
    d = float((y.cpu() - yc).abs().max() / yc.abs().max())
    print(f"[8] entry(): fn ran one RK4 step, {counts['sep_apply']} B1 "
          f"calls; max|y - y_cpu| / max|y_cpu| = {d:.3e} (limit 1e-10)")
    rep["entry"] = dict(rel_diff_cpu=d, b1_calls=counts["sep_apply"])
    if not (bool(torch.isfinite(y).all()) and d <= 1e-10
            and counts["sep_apply"] > 0):
        raise AssertionError(f"entry step: {d}, {counts}")
    rep["orders_on_path"] = sorted(orders)
    return orders


SHARD_COUNTS = (4, 3)          # z-slabs of 8 layers; 11, 11, 10 (padded)
SHARD_STEPS = 10                # the timed protocol over 4 shards
SHARD_REPEATS = 3
B2_SHARD_KERNEL = ("lattice_affine_kernel", "lattice_affine_fold")


def _zero_shard_counts():
    from lpfem_torch.kernels import lattice_apply, sep_apply
    sep_apply.LAUNCHES_SHARD = 0
    sep_apply.LAUNCHES_SHARD_BY_P.clear()
    lattice_apply.LAUNCHES_SHARD = 0
    lattice_apply.LAUNCHES_SHARD_BY_P.clear()


def _read_shard_counts() -> dict:
    from lpfem_torch.kernels import lattice_apply, sep_apply
    return {"sep_apply_shard": sep_apply.LAUNCHES_SHARD,
            "sep_apply_shard_by_p": dict(sorted(
                sep_apply.LAUNCHES_SHARD_BY_P.items())),
            "lattice_affine_apply_shard": lattice_apply.LAUNCHES_SHARD,
            "lattice_affine_apply_shard_by_p": dict(sorted(
                lattice_apply.LAUNCHES_SHARD_BY_P.items()))}


def _window_csr(lv, elop, dtype):
    """The stacked windows' local operator (no constraint) as one
    block-diagonal CSR matrix on the card, from the element matrices of
    ``elop`` (the same tank in element form), each shard's elements in its
    window numbering: the cuSPARSE yardstick of the shard kernels."""
    import numpy as np
    import torch
    from lpfem_torch.operators import assemble_csr
    pt, w = lv.pt, lv.pt.win
    ed = np.asarray(elop.space.elem_dofs)
    z, rem = ed // w["plane"], ed % w["plane"]
    shard = np.asarray(pt.part)[:, None]
    loc = (z - w["p"] * np.asarray(w["ez0"])[shard]) * w["plane"] + rem
    A = assemble_csr(elop, dtype, elem_dofs=shard * (lv.N_max + 1) + loc,
                     n=lv.ndev * (lv.N_max + 1))
    torch.cuda.empty_cache()
    return A


def phase_sharded_kernels(report: dict) -> dict:
    """9a: B1's and B2's shard modes against their plain versions on the
    refs 2 windows over 4 and 3 shards, the sharded apply against the
    unsharded kernel on one global vector, and their times."""
    import torch
    import lpfem_torch
    from lpfem_torch.kernels import lattice_apply as klat
    from lpfem_torch.kernels import sep_apply as ksep
    from lpfem_torch.operators import AffineLatticeLaplace, SeparableLattice
    from lpfem_torch.shard import Partition, ShardComm, ShardedLevel
    from lpfem_torch.space import CurvedLatticeSpace, LatticeSpace

    gen = torch.Generator(device="cuda").manual_seed(9)
    fine = LatticeSpace.from_config(lpfem_torch.preset("scaling_base", **CFG))
    lean = CurvedLatticeSpace(_leaning_mesh(), CFG["order"])

    def run(lv, scal, x, p0, plain=False):
        w = lv.pt.win
        if lv.mode == "sep":
            f = (ksep.sep_apply_shard_reference if plain
                 else ksep.sep_apply_shard)
            return f(x, lv.bands_xy, lv.zbands, w["periodic"][0], scal, p0,
                     lv.dims)
        f = (klat.lattice_affine_apply_shard_reference if plain
             else klat.lattice_affine_apply_shard)
        return f(x, lv.C6, lv.w3, lv.B, lv.D, w["dims"],
                 (w["periodic"][0], False, False), scal, p0)

    def check(lv, tag):
        dt = str(lv.dtype)[6:]
        x = torch.randn(lv.ndev, lv.N_max + 1, generator=gen, device="cuda",
                        dtype=torch.float64).to(lv.dtype)
        x[:, lv.N_max] = 0.0
        p0 = torch.randn(lv.ndev, lv.pt.win["plane"], generator=gen,
                         device="cuda", dtype=torch.float64).to(lv.dtype)
        flip = lv.scal_c.clone()
        flip[:, 1] = 1 - flip[:, 1]
        worst = 0.0
        for name, scal in (("constrained", lv.scal_c),
                           ("unconstrained", lv.scal_o), ("own0 flipped", flip)):
            y, yh = run(lv, scal, x, p0)
            y2, yh2 = run(lv, scal, x, p0)
            torch.cuda.synchronize()
            if not (torch.equal(y, y2) and torch.equal(yh, yh2)):
                raise AssertionError(f"{tag} {name}: two calls differ")
            y_r, yh_r = run(lv, scal, x, p0, plain=True)
            abs_err, rel = _rel_err(torch.cat([y, yh], 1),
                                    torch.cat([y_r, yh_r], 1))
            if not rel <= TOL[dt]:
                raise AssertionError(f"{tag} {name}: kernel vs plain "
                                     f"{rel:.3e} (limit {TOL[dt]:.0e})")
            worst = max(worst, abs_err)
        print(f"[9a] {tag} {dt}: kernel = plain within {TOL[dt]:.0e} of "
              f"max|y| (constrained, unconstrained, own0 flipped), max abs "
              f"err {worst:.3e}; same bits twice")
        return x, p0, worst

    def through_exchange(lv, op, tag):
        """The sharded constrained apply through the exchange against the
        unsharded kernel on the same global vector."""
        dt = str(lv.dtype)[6:]
        xg = torch.randn(op.n_dofs, generator=gen, device="cuda",
                         dtype=torch.float64).to(lv.dtype)
        xs = torch.as_tensor(lv.pt.stack_dof(xg.cpu().numpy())).to("cuda")
        ys = lv.apply_c(xs)
        yg = op.constrained_apply_top(xg)
        torch.cuda.synchronize()
        got = torch.as_tensor(lv.pt.unstack_dof(ys.cpu().numpy())).to("cuda")
        _, rel = _rel_err(got, yg)
        if not rel <= TOL[dt]:
            raise AssertionError(f"{tag}: sharded apply vs unsharded "
                                 f"{rel:.3e}")
        print(f"[9a] {tag} {dt}: sharded apply through the {lv.exchange} "
              f"exchange = unsharded kernel within {rel:.3e} of max|y|")
        return rel

    def timed(lv, x, p0, tag, kernel, bound, lib=None):
        dt = str(lv.dtype)[6:]
        fn = lambda v, q: run(lv, lv.scal_c, v, q)         # noqa: E731
        ms = _time_chain(fn, [(x, p0)])
        acts = _profile_calls(fn, [(x, p0)])
        dev = _device_ms(fn, [(x, p0)], kernel, acts)
        act = _per_call(acts)
        # the plain version takes ~1e2 x the kernel's time: one chain
        plain = _time_chain(lambda v, q: run(lv, lv.scal_c, v, q,
                                             plain=True), [(x, p0)], reps=1)
        apply_ms = _time_chain(lambda v: lv.apply_c(v), [(x,)])
        # device ms per apply: each kernel's mean per recorded launch,
        # summed (the profiler drops launches, up to most of a window)
        row = dict(tag=tag, dtype=dt, ndev=lv.ndev, p=lv.op.p,
                   window=[lv.ndev, *lv.pt.win["dims"]],
                   window_dofs=[lv.ndev, lv.pt.win["Dz_win"],
                                lv.pt.win["Dy"], lv.pt.win["Dx"]],
                   ms=act["launch_ms"] or dev or ms, call_ms=ms,
                   device_ms_over_calls=dev, launch_ms=act["launch_ms"],
                   launches_per_apply=len(act["kernels"]),
                   kernels_per_call_recorded=act["kernels_per_call"],
                   plain_ms=plain, bound_ms=bound[0], bound_by=bound[1],
                   library_ms=None, apply_through_exchange_ms=apply_ms)
        if lib is not None:
            # the materialised windows through the matrix, their outputs
            # assembled through the exchange: the sharded unconstrained apply
            A = _window_csr(lv, lib, lv.dtype)
            xw = torch.cat([lv.window(x).reshape(lv.ndev, -1),
                            x.new_zeros(lv.ndev, 1)], 1).reshape(-1)
            yw = (A @ xw).view(lv.ndev, -1)[:, : lv.N_max]
            _, rel = _rel_err(lv.unwindow(yw), lv.apply_own(x))
            row["library_ms"] = _time_chain(lambda v: A @ v, [(xw,)])
            row["library_device_ms"] = _device_ms(lambda v: A @ v, [(xw,)],
                                                  None)
            row["library_nnz"] = int(A.values().numel())
            row["library_vs_kernel"] = rel
            del A
            torch.cuda.empty_cache()
        print(f"[9a] time {tag} {dt}: {row['ms']:.4f} ms per apply on the "
              f"device ({len(act['kernels'])} kernel(s) per apply, "
              f"{act['kernels_per_call']:.2f} launches per call recorded; "
              f"{ms:.4f} ms per call with the host), plain "
              f"{plain:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}), the "
              f"apply through the exchange {apply_ms:.4f} ms per call"
              + (f", cuSPARSE SpMV of the windows' matrix "
                 f"{row['library_ms']:.4f} ms ({row['library_nnz']} "
                 f"nonzeros; assembled through unwindow, vs the sharded "
                 f"apply {row['library_vs_kernel']:.2e} of max|y|)"
                 if lib is not None else ""))
        return row

    rows = {"sep_apply_shard": [], "lattice_affine_apply_shard": []}
    worst = dict.fromkeys(rows, 0.0)
    for ndev in SHARD_COUNTS:
        comm = ShardComm(ndev)
        pt = Partition(fine, ndev)
        print(f"[9a] {ndev} shards: layers {list(pt.win['nlay'])}, window "
              f"{pt.win['Dz_win']} x {pt.win['Dy']} x {pt.win['Dx']} at "
              f"p = 4, exchange tables of {pt.NS} interface dofs")
        for p in (4, 2, 1):
            sp = fine if p == 4 else fine.with_order(p)
            ptp = pt if p == 4 else Partition(sp, ndev, part=pt.part)
            for dtype in (torch.float32, torch.float64):
                op = SeparableLattice(sp, dtype, "cuda")
                lv = ShardedLevel(op, ptp, sp.top_plane_dofs(), comm, "cuda")
                tag = f"B1-shard {ndev} shards p={p}"
                x, p0, err = check(lv, tag)
                worst["sep_apply_shard"] = max(worst["sep_apply_shard"], err)
                if p == 4:
                    through_exchange(lv, op, tag)
                Dx, Dy, Dz = lv.dims
                n, R = ndev * Dx * Dy * Dz, 2 * p + 1
                nbytes = x.element_size() * (
                    2 * n + 2 * ndev * Dx * Dy + 4 * R * (Dx + Dy)
                    + 2 * ndev * R * Dz)
                bound = _bound(nbytes, 2 * 7 * R * n,
                               PEAK_FLOPS[str(dtype)[6:]])
                if ndev != SHARD_COUNTS[0]:
                    continue                  # timed at the protocol's 4
                lib = None
                if p == 4 and dtype == torch.float32:
                    lib = AffineLatticeLaplace(
                        CurvedLatticeSpace(_plain_mesh(), 4), dtype, "cuda")
                row = timed(lv, x, p0, tag, B1_KERNEL, bound, lib)
                row["max_abs_err"] = err
                rows["sep_apply_shard"].append(row)
        lpt = Partition(lean, ndev)
        for dtype in (torch.float32, torch.float64):
            op = AffineLatticeLaplace(lean, dtype, "cuda")
            lv = ShardedLevel(op, lpt, lean.top_plane_dofs(), comm, "cuda")
            if lv.mode != "affine":
                raise AssertionError(f"the leaning tank's level is {lv.mode}")
            tag = f"B2-shard {ndev} shards p=4"
            x, p0, err = check(lv, tag)
            worst["lattice_affine_apply_shard"] = max(
                worst["lattice_affine_apply_shard"], err)
            through_exchange(lv, op, tag)
            w = lpt.win
            n = ndev * w["Dz_win"] * w["plane"]
            ne = ndev * w["dims"][0] * w["dims"][1] * w["dims"][2]
            nbytes = x.element_size() * (2 * n + 2 * ndev * w["plane"]
                                         + 6 * ne)
            bound = _bound(nbytes, _element_flops(ne, 5, 5, affine=True),
                           PEAK_FLOPS[str(dtype)[6:]])
            if ndev != SHARD_COUNTS[0]:
                continue
            lib = op if dtype == torch.float32 else None
            row = timed(lv, x, p0, tag, B2_SHARD_KERNEL, bound, lib)
            row["max_abs_err"] = err
            rows["lattice_affine_apply_shard"].append(row)
    report["shard_kernels"] = rows
    report["shard_kernels_max_abs_err"] = worst
    pick = {k: dict(next(r for r in v if r["p"] == 4
                         and r["dtype"] == "float32"), max_abs_err=worst[k])
            for k, v in rows.items()}
    return pick


def phase_sharded_path(report: dict) -> dict:
    """9b: rank invariance at the protocol's size, then the timed ss.cpp
    protocol over 4 shards."""
    import torch
    import lpfem_torch
    from lpfem_torch.shard import ShardedProblem

    cfg = lpfem_torch.preset("scaling_base", **{**CFG, "cg_rtol_sq": 1e-24})
    prob = lpfem_torch.Problem(cfg, device="cuda")
    _, y1, _ = prob.run(n_steps=1)
    scale = float(y1.abs().max())
    out = {}
    for ndev in SHARD_COUNTS:
        t0 = time.perf_counter()
        sprob = ShardedProblem(prob, ndev)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        _, y, phi = sprob.run(n_steps=1)
        sprob.check_state(y, phi)
        d = float((y - y1).abs().max())
        levels = [f"{lv.op.space.dof_dims} {lv.mode}/"
                  f"{'window' if lv.pt.win else 'compact'}"
                  for lv in sprob.pmg.levels]
        print(f"[9b] {ndev} shards (set-up {setup:.2f} s; levels {levels}): "
              f"one RK4 step at r.z <= rz0*1e-24, max|y_sharded - y_single| "
              f"{d:.3e} of max|y| {scale:.3e} (limit 1e-8 of it); "
              f"{sprob.last_solver_stats.total_iters} inner iterations "
              f"against {prob.last_solver_stats.total_iters} single-device")
        if not d <= 1e-8 * scale or sprob.last_solver_stats.unconverged:
            raise AssertionError(f"{ndev} shards: {d} ({sprob.last_solver_stats})")
        out[f"invariance_{ndev}"] = dict(max_abs_diff=d, scale=scale,
                                         setup_s=setup, levels=levels)
    del prob, sprob
    torch.cuda.empty_cache()

    cfg = lpfem_torch.preset("scaling_base", **CFG)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sprob = ShardedProblem.from_config(cfg, 4, device="cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    n = sprob.prob.space.n_dofs
    y0, phi0 = sprob.initial_state()
    _, cold = sprob.solve_laplace(y0[sprob.NSurf:], phi0)
    print(f"[9b] protocol over 4 shards: set-up on the host {setup:.2f} s "
          f"(lambda_max through the sharded operators {sprob.pmg.lmax}); "
          f"cold solve {cold.iters} inner CG iterations (single device: "
          f"{EXPECTED_COLD_ITERS}; the sharded p-multigrid's coarsest level "
          f"is Chebyshev-16 where the single-device one inverts it), "
          f"converged={cold.converged}")
    if not cold.converged:
        raise AssertionError("the sharded cold solve did not converge")
    sprob.run(n_steps=1, state=(y0, phi0))                   # warm-up
    torch.cuda.synchronize()
    walls, counts = [], None
    for _ in range(SHARD_REPEATS):
        _zero_counts()
        _zero_shard_counts()
        t0 = time.perf_counter()
        t, y, phi = sprob.run(n_steps=SHARD_STEPS, state=(y0, phi0))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = {**_read_counts(), **_read_shard_counts()}
        stats = sprob.last_solver_stats
        sprob.check_state(y, phi)
        if stats.unconverged or stats.n_solves != 4 * SHARD_STEPS:
            raise AssertionError(f"a timed stage did not converge: {stats}")
        if counts["sep_apply_shard"] <= 0:
            raise AssertionError("the sharded path launched no B1-shard")
    wall = statistics.median(walls)
    rate = n * 4 * SHARD_STEPS / wall
    by_p = {p: c / SHARD_STEPS
            for p, c in counts["sep_apply_shard_by_p"].items()}
    print(f"[9b] {SHARD_STEPS} RK4 steps over 4 shards: wall median "
          f"{wall:.3f} s of {[round(w, 3) for w in walls]}, {rate:.4e} "
          f"dof*solves/s, every timed stage converged, "
          f"{stats.total_iters} inner CG iterations, {stats.syncs} host "
          f"syncs; B1-shard launches per RK4 step by order {by_p}; peak "
          f"device memory {_gib(torch.cuda.max_memory_allocated())}")
    prof = _profile_step(sprob, (y0, phi0), 0.0)
    prof["busy_share_unprofiled"] = prof["device_ms"] / (
        1e3 * wall / SHARD_STEPS)
    _print_profile("[9b]", prof)
    out.update(setup_s=setup, cold_iters=cold.iters, walls_s=walls,
               wall_s=wall, dof_solves_per_s=rate,
               total_inner_iters=stats.total_iters, syncs=stats.syncs,
               launches=counts, b1_shard_calls_per_step_by_p=by_p,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               profile=prof, lmax=sprob.pmg.lmax, dofs=n)
    report["shard_path"] = out
    return out


def phase_sharded_lean(report: dict) -> dict:
    """9c: the leaning tank of phase 5A over 4 shards, one step against the
    single-device step; B2's shard mode must launch."""
    import torch
    import lpfem_torch
    from lpfem_torch.shard import ShardedProblem

    cfg = lpfem_torch.preset("scaling_base", **{**CFG, "cg_rtol_sq": 1e-24},
                             **LEAN)
    prob = lpfem_torch.Problem(cfg, device="cuda", mesh=_leaning_mesh())
    _, y1, _ = prob.run(n_steps=1)
    sprob = ShardedProblem(prob, 4)
    modes = [lv.mode for lv in sprob.pmg.levels]
    _zero_shard_counts()
    _, y, phi = sprob.run(n_steps=1)
    torch.cuda.synchronize()
    counts = _read_shard_counts()
    sprob.check_state(y, phi)
    d = float((y - y1).abs().max())
    scale = float(y1.abs().max())
    print(f"[9c] leaning tank over 4 shards (levels {modes}): max|y_sharded "
          f"- y_single| {d:.3e} of max|y| {scale:.3e} (limit 1e-8 of it); "
          f"launches {counts}")
    if not d <= 1e-8 * scale or sprob.last_solver_stats.unconverged:
        raise AssertionError(f"leaning tank: {d} ({sprob.last_solver_stats})")
    if counts["lattice_affine_apply_shard"] <= 0:
        raise AssertionError("the leaning tank launched no B2-shard")
    report["shard_lean"] = dict(max_abs_diff=d, scale=scale, modes=modes,
                                launches=counts)
    return report["shard_lean"]


def phase_sharded_drivers(report: dict) -> dict:
    """9d: dryrun_multichip(4), the strong-scaling driver over 1, 2, 4
    shards, and the diffraction study over 4 shards for 2 steps."""
    import numpy as np
    from lpfem_torch.entry import dryrun_multichip
    from lpfem_torch.experiments import diffraction, scaling
    from lpfem_torch.kernels import pa_apply

    out = {"dryrun": dryrun_multichip(4)}
    table = "chiprun_out/strong-scaling-torch.txt"
    Path(table).unlink(missing_ok=True)
    rows = scaling.main(["--mode", "strong", "--shards", "1", "2", "4",
                         "--orders", "4", "--par-ref", "2", "--precond",
                         "pmg", "--repeats", "1", "--out", table])
    cold = [r["cold_iters"] for r in rows]
    print(f"[9d] scaling rows: cold iterations by shards {cold} (the bench "
          f"on one device: {EXPECTED_COLD_ITERS}); walls "
          f"{[round(r['median_wall_s'], 3) for r in rows]} s")
    if len(set(cold)) != 1 or not all(r["converged"] for r in rows):
        raise AssertionError(f"scaling rows differ: {rows}")
    out["scaling"] = rows

    steps, res = 2, {}
    for shard in (0, 4):
        tag = f"shard{shard}"
        n0 = pa_apply.LAUNCHES
        res[shard] = diffraction.main([
            "--nsteps", str(steps), "--periods", str(steps / 35),
            "--shard", str(shard), "--out",
            f"chiprun_out/cylinder-diffraction-{tag}.txt", "--out-exact",
            "chiprun_out/cylinder_boundary-torch.txt", "--compare", ""])
        res[shard]["b3b_launches"] = pa_apply.LAUNCHES - n0
        res[shard]["rim"] = np.loadtxt(
            f"chiprun_out/cylinder-diffraction-{tag}.txt", ndmin=2)
    a, b = res[0]["rim"], res[4]["rim"]
    d = float(np.max(np.abs(a[:, 1] - b[:, 1])))
    scale = float(np.max(np.abs(a[:, 1])))
    print(f"[9d] diffraction --shard 4, {steps} steps: rim envelope within "
          f"{d:.3e} of the single-device run's (max {scale:.3e}; limit 1e-8 "
          f"of it), B3b launches {res[4]['b3b_launches']}")
    if (not np.array_equal(a[:, 0], b[:, 0]) or not d <= 1e-8 * scale
            or res[4]["unconverged"] or res[4]["b3b_launches"] <= 0):
        raise AssertionError(f"diffraction --shard 4: {d}, {res[4]}")
    out["diffraction"] = dict(max_abs_diff=d, scale=scale,
                              b3b_launches=res[4]["b3b_launches"],
                              wall_s={k: v["wall_s"] for k, v in res.items()})
    report["shard_drivers"] = out
    return out


# ---------------------------------------------------------------- phase 10
WIDE_ORDERS = (8, 9, 10)
WIDE_LEAN_REFS = 1        # 10a: path A's leaning tank at one refinement
                          # (4,096 hexes; phase 5A runs two, 32,768)
WIDE_RUN_TANK = (6, 2, 2)  # 10a's one-step runs: the leaning tank's hexes
GMSH_FILE = "chiprun_out/cylinder_half.msh"
GMSH_STEPS = 2
ASM_SS_STEPS = 2
ASM_SHARDS = 4
SUMFACT_STEPS = 12        # 10g: --quick's dt (T/20), cut from its 60 steps


def _same_bits_and_plain(fn, plain, args, label, dt) -> float:
    """Run ``fn(*args)`` twice (the same bits required) and hold it against
    ``plain(*args)`` at ``TOL``; returns the max abs error."""
    import torch
    y = fn(*args)
    if not torch.equal(y, fn(*args)):
        raise AssertionError(f"{label} {dt}: two calls differ")
    abs_err, rel = _rel_err(y, plain(*args))
    print(f"[10a] {label:52s} {dt:8s} rel_err={rel:.2e}")
    if not rel <= TOL[dt]:
        raise AssertionError(f"kernel disagrees with plain version: "
                             f"{label} {dt}: {rel:.3e}")
    return abs_err


def _wide_row(name, fn, plain, args, kernel_names, nbytes, flops, dt,
              **extra) -> dict:
    """Device ms per launch (torch.profiler, each kernel's mean per recorded
    launch), ms per call (CUDA events), the plain version's ms and the
    bound of one call at the shapes of ``args``."""
    import torch
    size = args[0].element_size()
    n_sets = max(1, -(-60_000_000 // (2 * args[0].numel() * size)))
    sets = [tuple(a.clone() if i == 0 else a for i, a in enumerate(args))
            for _ in range(n_sets)]
    ms = _time_chain(fn, sets)
    acts = _profile_calls(fn, sets)
    act = _per_call([a for a in acts if any(k in a[0] for k in kernel_names)]
                    or acts)
    dev = act["launch_ms"] or None
    plain_ms = _time_chain(plain, sets[:1], reps=3)
    bound, by = _bound(nbytes, flops, PEAK_FLOPS[dt])
    row = dict(name=name, dtype=dt, ms=dev if dev is not None else ms,
               device_ms=dev, call_ms=ms, plain_ms=plain_ms, bound_ms=bound,
               bound_by=by, library_ms=None, flops=flops,
               kernels_per_call_recorded=act["kernels_per_call"], **extra)
    print(f"[10a] time {name} p={extra['p']} {dt}: kernel {row['ms']:.4f} ms "
          f"on the device ({ms:.4f} ms per call), plain {plain_ms:.4f} ms, "
          f"bound {bound:.4f} ms ({by})")
    del sets
    torch.cuda.empty_cache()
    return row


def phase_wide_orders(report: dict) -> dict:
    """10a: B3b, B3a and B2 at p = 8, 9, 10 at real shapes against their
    plain versions with their times; then the paths at those orders."""
    import torch
    import lpfem_torch
    import numpy as np
    from lpfem_torch.experiments.diffraction import build_problem
    from lpfem_torch.experiments.leaning_tank import leaning_tank
    from lpfem_torch.geometry import affine_c6
    from lpfem_torch.kernels import lattice_apply as klat
    from lpfem_torch.kernels import pa_apply as kpa
    from lpfem_torch.mesh import Mesh
    from lpfem_torch.operators import AffineLatticeLaplace, ElementLaplace
    from lpfem_torch.space import CurvedLatticeSpace

    gen = torch.Generator(device="cuda").manual_seed(10)
    dims, sizes = _tank_dims()
    lean = leaning_tank(*dims, *sizes, ref_levels=WIDE_LEAN_REFS, lean="z")
    cyl = _study_mesh()
    rows = {"pa_apply_element": [], "pa_apply_affine": [],
            "lattice_affine_apply": []}
    for p in WIDE_ORDERS:
        q, p1 = p + 1, p + 1
        L, Q = p1 ** 3, q ** 3
        el64 = ElementLaplace(CurvedLatticeSpace(cyl, p), torch.float64,
                              "cuda")
        # the metric constants from 2 Gauss points: at q = 11 the float64
        # affine test (1e-12, lpfem's) rejects this tank by round-off, and
        # the operator rule then takes B3b (lpfem too); the kernels take it
        lspace = CurvedLatticeSpace(lean, p)
        lat64 = AffineLatticeLaplace(lspace, torch.float64, "cuda",
                                     C6=affine_c6(lspace, 2, np.float64))
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype)[6:]
            size = torch.empty((), dtype=dtype).element_size()
            # B3b on the study tank's curved elements
            G6q, B, D = (t.to(dtype) for t in (el64.G6q, el64.B, el64.D))
            ne = G6q.shape[0]
            u = torch.randn(ne, L, generator=gen, device="cuda", dtype=dtype)
            b3b = lambda a, G6q=G6q, B=B, D=D: kpa.pa_apply_element(
                a, G6q, B, D)
            ref = lambda a, G6q=G6q, B=B, D=D: \
                kpa.pa_apply_element_reference(a, G6q, B, D)
            err = _same_bits_and_plain(b3b, ref, (u,),
                                       f"pa_apply_element p={p} ne={ne}", dt)
            rows["pa_apply_element"].append(_wide_row(
                "pa_apply_element", b3b, ref, (u,), ("pa_element_kernel",),
                size * (2 * ne * L + ne * 6 * Q + 2 * q * p1),
                _element_flops(ne, p1, q), dt, p=p, ne=ne,
                max_abs_err=err))
            del u, G6q
            # B3a on the leaning tank's E-vectors, B2 on its lattice
            C6, w3, B, D = (t.to(dtype) for t in (lat64.C6, lat64.w3,
                                                   lat64.B, lat64.D))
            ne, n = C6.shape[0], lat64.n_dofs
            tables = 6 * ne + Q + 2 * q * p1
            flops = _element_flops(ne, p1, q, affine=True)
            x = torch.randn(n, generator=gen, device="cuda", dtype=dtype)
            u = lat64.gather(x)
            b3a = lambda a, C6=C6, w3=w3, B=B, D=D: kpa.pa_apply_affine(
                a, C6, w3, B, D)
            ref = lambda a, C6=C6, w3=w3, B=B, D=D: \
                kpa.pa_apply_affine_reference(a, C6, w3, B, D)
            err = _same_bits_and_plain(b3a, ref, (u,),
                                       f"pa_apply_affine p={p} ne={ne}", dt)
            rows["pa_apply_affine"].append(_wide_row(
                "pa_apply_affine", b3a, ref, (u,), ("pa_affine_kernel",),
                size * (2 * ne * L + tables), flops, dt, p=p, ne=ne,
                max_abs_err=err))
            del u
            sd, per = lat64.space.elem_dims, lat64.periodic
            b2 = lambda v, C6=C6, w3=w3, B=B, D=D: klat.lattice_affine_apply(
                v, C6, w3, B, D, sd, per, True)
            ref = lambda v, C6=C6, w3=w3, B=B, D=D: \
                klat.lattice_affine_apply_reference(v, C6, w3, B, D, sd, per,
                                                    True)
            err = _same_bits_and_plain(b2, ref, (x,),
                                       f"lattice_affine_apply p={p} n={n}",
                                       dt)
            rows["lattice_affine_apply"].append(_wide_row(
                "lattice_affine_apply", b2, ref, (x,),
                ("lattice_affine_kernel", "lattice_affine_fold"),
                size * (2 * n + tables), flops, dt, p=p, ne=ne, dofs=n,
                max_abs_err=err))
            del x, C6
        del el64, lat64
        torch.cuda.empty_cache()

    # the paths at p = 8..10, one RK4 step each, counts set to 0 just before
    # and read just after: B3b on the small cylinder tank, B2 on a leaning
    # tank with its lattice declared, B3a on the same tank without it
    small = leaning_tank(*WIDE_RUN_TANK, *sizes, lean="z")
    plain_mesh = Mesh(small.verts, small.elems, small.corner_coords,
                      small.bdr_quads, small.bdr_attrs, small.periodic,
                      periodic_axes=small.periodic_axes)
    runs = {}
    for p in WIDE_ORDERS:
        cfg = lpfem_torch.preset("scaling_base", order=p, dtype="float64",
                                 precond="pmg", cheb_degree=4,
                                 cg_rtol_sq=1e-20, cg_max_iter=400,
                                 nsteps=40, **LEAN)
        for kernel, make in (
                ("pa_apply_element", lambda p=p: build_problem(
                    "cuda", order=p, n_theta=12, n_r=6, dr_max=0.0, nz=1,
                    nsteps=35, periods=1.0)),
                ("lattice_affine_apply", lambda cfg=cfg: lpfem_torch.Problem(
                    cfg, "cuda", mesh=small)),
                ("pa_apply_affine", lambda cfg=cfg: lpfem_torch.Problem(
                    cfg, "cuda", mesh=plain_mesh))):
            prob = make()
            _zero_counts()
            t0 = time.perf_counter()
            _, y, phi = prob.run(n_steps=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _read_counts()
            prob.check_state(y, phi)
            stats = prob.last_solver_stats
            by_p = counts[f"{kernel}_by_p"]
            print(f"[10a] one RK4 step at p={p} on {type(prob.op).__name__} "
                  f"({prob.space.n_dofs} dofs): {wall:.2f} s, "
                  f"{stats.total_iters} inner CG iterations (max "
                  f"{stats.max_iters}), {kernel} launches by p {by_p}")
            if stats.unconverged or by_p.get(p, 0) <= 0:
                raise AssertionError(f"p={p} {kernel}: {stats}, {counts}")
            runs[f"{kernel} p={p}"] = dict(dofs=prob.space.n_dofs,
                                           wall_s=wall, launches_by_p=by_p,
                                           total_inner_iters=stats.total_iters)
            del prob
    report["wide_orders"] = dict(rows=rows, runs=runs,
                                 lean_refs=WIDE_LEAN_REFS)
    orders = {k: sorted({p for r, v in runs.items() if r.startswith(k + " ")
                         for p in v["launches_by_p"]}) for k in rows}
    return dict(rows=rows, orders=orders)


def phase_gmsh(report: dict) -> dict:
    """10b: the study tank's linear corners through a Gmsh v2.2 file, both
    parsers, SetCurvature with the rim snap, and the diffraction driver on
    the import."""
    import numpy as np
    import torch
    from lpfem_torch import native
    from lpfem_torch.experiments import diffraction
    from lpfem_torch.mesh import (cylinder_projector, load_gmsh,
                                  parse_gmsh_python, save_gmsh,
                                  set_curvature)

    mesh = _study_mesh()
    save_gmsh(mesh, GMSH_FILE)
    t0 = time.perf_counter()
    nat = native.parse_gmsh(GMSH_FILE)
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = parse_gmsh_python(GMSH_FILE)
    t_py = time.perf_counter() - t0
    for a, b in zip(nat, py):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError("the native and the Python Gmsh parsers "
                                 "disagree")
    m = load_gmsh(GMSH_FILE)
    attrs = sorted(set(m.bdr_attrs.tolist()))
    if m.n_elems != mesh.n_elems or attrs != [1, 2, 3]:
        raise AssertionError(f"{m.n_elems} hexes, attributes {attrs}")
    set_curvature(m, 4, {3: cylinder_projector(4.0, 0.0, 0.5)})
    r = np.hypot(m.geom_nodes[..., 0] - 4.0, m.geom_nodes[..., 1])
    rim = np.abs(r - 0.5) < 1e-3
    off = float(np.max(np.abs(r[rim] - 0.5)))
    print(f"[10b] {GMSH_FILE}: {m.n_elems} hexes, attributes {attrs}; "
          f"native parse {t_nat:.3f} s, Python {t_py:.3f} s, integer-equal; "
          f"rim geometry nodes {int(rim.sum())} within {off:.2e} of the "
          "circle after SetCurvature(4)")
    if not off <= 1e-12:
        raise AssertionError(f"rim nodes {off} off the circle")
    _zero_counts()
    res = diffraction.main([
        "--gmsh", GMSH_FILE, "--nsteps", str(GMSH_STEPS), "--periods",
        str(GMSH_STEPS / 35), "--cy", "0", "--out",
        "chiprun_out/cylinder-diffraction-gmsh.txt", "--out-exact",
        "chiprun_out/cylinder_boundary-torch.txt", "--compare", ""])
    counts = _read_counts()
    amax, H = res.pop("max_abs_eta"), 0.01
    vtu = Path(res["envelope_vtu"])
    print(f"[10b] diffraction --gmsh: {res['dofs']} dofs, set-up "
          f"{res['setup_s']:.2f} s, {res['wall_s'] / GMSH_STEPS:.3f} s per "
          f"step, {res['total_inner_iters']} inner CG iterations (max "
          f"{res['max_iters']} per solve: the cold first one's), B3b by "
          f"order {counts['pa_apply_element_by_p']}, max|eta| {amax:.4e}, "
          f"{vtu} {vtu.stat().st_size} bytes")
    if (res["dofs"] != CYL_DOFS or res["unconverged"]
            or not 0.0 < amax < H
            or counts["pa_apply_element"] <= 0 or vtu.stat().st_size <= 0
            or b'format="appended"' not in vtu.read_bytes()[:4096]):
        raise AssertionError(f"diffraction --gmsh: {res}, {counts}")
    out = dict(native_parse_s=t_nat, python_parse_s=t_py, rim_off=off,
               dofs=res["dofs"], setup_s=res["setup_s"],
               wall_per_step_s=res["wall_s"] / GMSH_STEPS,
               max_iters=res["max_iters"],
               total_inner_iters=res["total_inner_iters"],
               b3b_by_p=counts["pa_apply_element_by_p"], max_abs_eta=amax)
    report["gmsh"] = out
    torch.cuda.empty_cache()
    return out


def phase_assembled(report: dict) -> dict:
    """10c: apply_mode="assembled" on one card."""
    import dataclasses
    import torch
    import lpfem_torch
    from lpfem_torch.operators import AssembledLaplace

    out = {}
    # pf_linear_par at its own size, assembled against the PA operator
    runs = {}
    for mode in ("pallas", "assembled"):
        prob = lpfem_torch.Problem(lpfem_torch.preset(
            "pf_linear_par", apply_mode=mode, dtype="float64"), "cuda")
        _zero_counts()
        t0 = time.perf_counter()
        t, y, phi = prob.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prob.check_state(y, phi)
        st = prob.last_solver_stats
        if st.unconverged or st.n_solves != 4 * prob.cfg.nsteps:
            raise AssertionError(f"pf_linear_par {mode}: {st}")
        runs[mode] = dict(eta=y[:prob.surf.n_dofs].clone(), wall_s=wall,
                          total_inner_iters=st.total_iters,
                          dofs=prob.space.n_dofs, counts=_read_counts())
        print(f"[10c] pf_linear_par {mode}: {prob.space.n_dofs} dofs, "
              f"{prob.cfg.nsteps} steps in {wall:.2f} s, {st.total_iters} "
              f"Jacobi-CG iterations, launches {runs[mode]['counts']}")
    a, b = runs["pallas"]["eta"], runs["assembled"]["eta"]
    d, amax = float((a - b).abs().max()), float(a.abs().max())
    print(f"[10c] final eta assembled vs PA: {d:.3e} (limit 1e-9 of "
          f"max|eta| = {amax:.3e})")
    if not d <= 1e-9 * amax:
        raise AssertionError(f"assembled pf_linear_par differs by {d}")
    out["pf_linear_par"] = dict(max_abs_diff=d, max_abs_eta=amax, **{
        f"{k}_{f}": v[f] for k, v in runs.items()
        for f in ("wall_s", "total_inner_iters")})

    # the ss.cpp tank at refs 2 in float64, two RK4 steps
    cfg = lpfem_torch.preset("scaling_base", **dict(CFG, dtype="float64"))
    pa = lpfem_torch.Problem(cfg, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    A = AssembledLaplace(pa.op)
    torch.cuda.synchronize()
    asm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(pa.space.n_dofs, generator=gen, device="cuda",
                    dtype=torch.float64)
    _, rel = _rel_err(A.apply(x), pa.op.apply(x))
    if not rel <= ELEMENT_CSR_TOL_F64:
        raise AssertionError(f"assembled apply vs B1: {rel:.3e}")
    spmv = _time_chain(A.apply, [(x,)])
    spmv_dev = _device_ms(A.apply, [(x,)], None)
    b1 = next(r for r in report["sep_apply_times"] if r["level"] == 0
              and r["dtype"] == "float64" and not r["ess_top"])
    print(f"[10c] ss.cpp tank refs 2: assembled {A.nnz} nonzeros in "
          f"{asm_s:.2f} s (peak {_gib(peak)} above the PA problem, "
          f"{_gib(held)} held); SpMV {spmv_dev or spmv:.4f} ms per apply on "
          f"the device ({spmv:.4f} ms per call) beside B1 float64 "
          f"{b1['ms']:.4f} ms; vs B1 rel {rel:.2e}")
    del A
    torch.cuda.empty_cache()
    asm = lpfem_torch.Problem(dataclasses.replace(cfg, apply_mode="assembled"),
                              "cuda", lmax=pa.precond.lmax)
    res = {}
    for tag, prob in (("pa", pa), ("assembled", asm)):
        _zero_counts()
        t0 = time.perf_counter()
        t, y, phi = prob.run(n_steps=ASM_SS_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prob.check_state(y, phi)
        st = prob.last_solver_stats
        if st.unconverged:
            raise AssertionError(f"ss.cpp {tag}: {st}")
        res[tag] = dict(y=y, wall_s=wall, total_inner_iters=st.total_iters,
                        max_iters=st.max_iters)
    d = float((res["pa"]["y"] - res["assembled"]["y"]).abs().max())
    ymax = float(res["pa"]["y"].abs().max())
    its = [res[k]["total_inner_iters"] for k in ("pa", "assembled")]
    print(f"[10c] ss.cpp tank {ASM_SS_STEPS} RK4 steps, assembled vs PA: "
          f"max|dy| {d:.3e} (limit 1e-9 of max|y| = {ymax:.3e}); CG "
          f"iterations {its}; walls {res['pa']['wall_s']:.3f} / "
          f"{res['assembled']['wall_s']:.3f} s")
    if not d <= 1e-9 * ymax or its[0] != its[1]:
        raise AssertionError(f"assembled ss.cpp run: {d}, {its}")
    out["ss_refs2"] = dict(nnz=asm.op_solve.nnz, assembly_s=asm_s,
                           peak_assembly_bytes=peak, held_bytes=held,
                           spmv_ms=spmv, spmv_device_ms=spmv_dev,
                           b1_f64_ms=b1["ms"], max_abs_diff=d, max_abs_y=ymax,
                           iters=its, walls_s=[res[k]["wall_s"]
                                               for k in ("pa", "assembled")])
    report["assembled"] = out
    del pa, asm, res
    torch.cuda.empty_cache()
    return out


def phase_sharded_assembled(report: dict) -> dict:
    """10d: the ELL level of pf_linear_par over 4 shards against one card."""
    import numpy as np
    import torch
    import lpfem_torch
    from lpfem_torch.shard import ShardedProblem

    prob = lpfem_torch.Problem(lpfem_torch.preset(
        "pf_linear_par", apply_mode="assembled", dtype="float64"), "cuda")
    sprob = ShardedProblem(prob, ASM_SHARDS)
    lv, pt = sprob.fine, sprob.pt
    if lv.mode != "ell":
        raise AssertionError(f"the fine level is {lv.mode}, not ell")
    x = np.random.default_rng(12).standard_normal(prob.space.n_dofs)
    y_ref = prob.op_solve.apply(torch.tensor(x, device="cuda"))
    ys = lv.apply_own(torch.tensor(pt.stack_dof(x), device="cuda"))
    y = torch.tensor(pt.unstack_dof(ys.cpu().numpy()), device="cuda")
    _, rel = _rel_err(y, y_ref)
    _zero_counts()
    _, y1, _ = prob.run(n_steps=1)
    _, y2, phi2 = sprob.run(n_steps=1)
    sprob.check_state(y2, phi2)
    d = float((y1 - y2).abs().max())
    ymax = float(y1.abs().max())
    print(f"[10d] pf_linear_par over {ASM_SHARDS} shards: ELL apply vs one "
          f"card rel {rel:.2e} (limit 1e-12); one step max|dy| {d:.3e} "
          f"(limit 1e-10 of max|y| = {ymax:.3e})")
    if not (rel <= 1e-12 and d <= 1e-10 * ymax):
        raise AssertionError(f"sharded assembled: {rel}, {d}")
    out = dict(ell_rel=rel, step_max_abs_diff=d, max_abs_y=ymax,
               nnz=int(lv.A.values().numel()))
    report["sharded_assembled"] = out
    return out


def phase_native_io(report: dict) -> dict:
    """10e: path B's set-up with the native numbering (read from phase 5B),
    and the binary against the ASCII VTU writer."""
    import numpy as np
    import lpfem_torch
    from lpfem_torch.io import write_vtu
    from lpfem_torch.space import LatticeSpace

    setup_b = report["path_b"]["setup_s"]
    print(f"[10e] path B set-up with the native numbering: {setup_b:.2f} s "
          "(phase 5B; 13.6-23.2 s with NumPy's in earlier runs)")
    rows = []
    for refs, kinds in ((2, (True,)), (1, (True, False))):
        sp = LatticeSpace.from_config(lpfem_torch.preset("scaling_base",
                                                         ref_levels=refs))
        f = np.random.default_rng(refs).standard_normal(sp.n_dofs)
        for binary in kinds:
            path = Path(f"chiprun_out/volume-refs{refs}-"
                        f"{'binary' if binary else 'ascii'}.vtu")
            t0 = time.perf_counter()
            write_vtu(str(path), sp, {"phi": f}, binary=binary)
            secs = time.perf_counter() - t0
            rows.append(dict(refs=refs, dofs=sp.n_dofs, binary=binary,
                             bytes=path.stat().st_size, seconds=secs))
            print(f"[10e] VTU refs {refs} ({sp.n_dofs} dofs) "
                  f"{'binary' if binary else 'ASCII'}: {rows[-1]['bytes']} "
                  f"bytes in {secs:.3f} s")
            path.unlink()
    out = dict(path_b_setup_s=setup_b, vtu=rows)
    report["native_io"] = out
    return out


def phase_glvis(report: dict) -> dict:
    """10f: pf_run --glvis-every to a listener thread on localhost."""
    import socket
    import threading
    import lpfem_torch
    from lpfem_torch.experiments import pf_run
    from lpfem_torch.glvis import solution_text

    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    got = []

    def serve():
        conn, _ = srv.accept()
        with conn:
            buf = b""
            while chunk := conn.recv(1 << 16):
                buf += chunk
        got.append(buf)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    try:
        _zero_counts()
        _, y, _ = pf_run.main([
            "--preset", "pf_linear_periodic", "--nsteps", "40",
            "--glvis-every", "40", "--glvis-host", "127.0.0.1",
            "--glvis-port", str(port), "--checkpoint-every", "40"])
        counts = _read_counts()
        th.join(timeout=60)
    finally:
        srv.close()
    if th.is_alive() or not got:
        raise AssertionError("the GLVis listener received nothing")
    prob = lpfem_torch.Problem(lpfem_torch.preset("pf_linear_periodic",
                                                  nsteps=40), "cuda")
    want = solution_text(prob.surf, y[:prob.surf.n_dofs], keys="Rjlc")
    print(f"[10f] pf_run --glvis-every 40: {len(got[0])} bytes received on "
          f"localhost:{port}, equal to solution_text of the final state: "
          f"{got[0] == want.encode()}; B1 launches {counts['sep_apply']}")
    if got[0] != want.encode() or counts["sep_apply"] <= 0:
        raise AssertionError("GLVis bytes differ from solution_text")
    out = dict(bytes=len(got[0]))
    report["glvis"] = out
    return out


def phase_new_drivers(report: dict) -> dict:
    """10g: apply_bench --cylinder and diffraction --apply-mode sumfact
    (against the same run in the default mode)."""
    import numpy as np
    from lpfem_torch.experiments import apply_bench, diffraction

    _zero_counts()
    tiers = apply_bench.main(["--cylinder", "--iters", "30",
                              "--repeats", "3"])
    counts = _read_counts()
    print(f"[10g] apply_bench --cylinder: {tiers}; B3b launches "
          f"{counts['pa_apply_element']}")
    if counts["pa_apply_element"] <= 0:
        raise AssertionError("apply_bench --cylinder launched no B3b")
    res, rims = {}, {}
    for mode in ("sumfact", "pallas"):
        _zero_counts()
        rim = f"chiprun_out/cylinder-diffraction-{mode}.txt"
        res[mode] = diffraction.main([
            "--apply-mode", mode, "--quick", "--nsteps", str(SUMFACT_STEPS),
            "--periods", str(SUMFACT_STEPS / 20), "--out", rim,
            "--out-exact", "chiprun_out/cylinder_boundary-quick.txt",
            "--compare", ""])
        res[mode]["b3b_launches"] = _read_counts()["pa_apply_element"]
        rims[mode] = np.loadtxt(rim, ndmin=2)
    d = float(np.max(np.abs(rims["sumfact"][:, 1] - rims["pallas"][:, 1])))
    scale = float(np.max(np.abs(rims["pallas"][:, 1])))
    sf = res["sumfact"]
    print(f"[10g] diffraction --apply-mode sumfact --quick, "
          f"{SUMFACT_STEPS} steps: {sf['wall_s']:.2f} s (pallas "
          f"{res['pallas']['wall_s']:.2f} s), rim envelope within {d:.3e} of "
          f"the pallas run's (limit 1e-8 of {scale:.3e}), B3b launches "
          f"{sf['b3b_launches']} (none: the einsums) against "
          f"{res['pallas']['b3b_launches']}")
    if (sf["unconverged"] or sf["b3b_launches"] != 0
            or res["pallas"]["b3b_launches"] <= 0 or not d <= 1e-8 * scale):
        raise AssertionError(f"diffraction sumfact: {d}, {sf}")
    out = dict(apply_bench_cylinder=tiers, sumfact_rim_max_abs_diff=d,
               **{f"{k}_quick_wall_s": v["wall_s"] for k, v in res.items()})
    report["new_drivers"] = out
    return out


# ---------------------------------------------------------------- phase 11
RANK_SHARDS = 4                # 11a: the z-slabs of 9b, one per rank
RANK_STEPS = 2
RANK_LEAN_SHARDS = 3           # 11b: 11, 11, 10 leaning layers
RANK_TIMEOUT = 600             # seconds a run's ranks may take
RANK_TOL = 1e-10               # of max|y| (max|phi|): the sharded bound


def _check_no_descendants(where: str) -> None:
    """Raise if this process has a live descendant (``/proc``)."""
    from lpfem_torch.dist import live_descendants
    left = live_descendants()
    print(f"[11] live descendants {where}: {left}")
    if left:
        raise AssertionError(f"{where}: processes left running: {left}")


def _stacked_run(cfg, ndev, steps, mesh=None) -> dict:
    """The stacked ``ShardedProblem.from_config`` run the ranks are held
    to: ``steps`` steps from the initial state, its wall per step and its
    running maximum of the CG iterations after every step."""
    import torch
    from lpfem_torch.shard import ShardedProblem

    t0 = time.perf_counter()
    sp = ShardedProblem.from_config(cfg, ndev, device="cuda", mesh=mesh)
    y0, phi0 = sp.initial_state()
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    its, walls, last = [], [], [time.perf_counter()]

    def record(t, y, aux):
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - last[0])
        last[0] = time.perf_counter()
        its.append(aux.stats.max_iters)

    _zero_shard_counts()
    _, y, phi = sp.run(n_steps=steps, state=(y0, phi0), record=record)
    torch.cuda.synchronize()
    counts = _read_shard_counts()
    sp.check_state(y, phi)
    if sp.last_solver_stats.unconverged:
        raise AssertionError(f"stacked run: {sp.last_solver_stats}")
    out = dict(y=y.cpu().numpy(), phi=sp.phi_global(phi), iters=its,
               step_walls_s=walls, setup_s=setup, lmax=sp.pmg.lmax,
               launches=counts, levels=[lv.mode for lv in sp.pmg.levels])
    del sp
    torch.cuda.empty_cache()
    return out


def _ranks_vs_stacked(tag, cfg_kw, ndev, steps, mesh_spec, kernel) -> dict:
    """The spec's run over ``ndev`` gloo ranks on the card (``lpfem_torch.
    dist.run_spec``) against the stacked run from the same state with the
    same smoother bounds: y and the potential within ``RANK_TOL``, the
    per-step maximum iterations within one per outer pass, ``kernel``
    launched, summed over the ranks."""
    import numpy as np
    import lpfem_torch
    from lpfem_torch import dist

    mesh = None
    if mesh_spec is not None:
        mesh = dist._mesh({"mesh": mesh_spec})
    cfg = lpfem_torch.preset("scaling_base", **cfg_kw)
    ref = _stacked_run(cfg, ndev, steps, mesh)
    del mesh
    spec = {"preset": "scaling_base", "config": cfg_kw, "steps": steps,
            "device": "cuda", "lmax": ref["lmax"], "timing": True,
            "mesh": mesh_spec}
    t0 = time.perf_counter()
    res = dist.run_spec(spec, ndev, f"chiprun_out/ranks-{tag}",
                        timeout=RANK_TIMEOUT)
    launch_s = time.perf_counter() - t0
    ranks = res["ranks"]
    dy = float(np.max(np.abs(res["y"] - ref["y"])))
    ymax = float(np.max(np.abs(ref["y"])))
    dphi = float(np.max(np.abs(res["phi"] - ref["phi"])))
    phimax = float(np.max(np.abs(ref["phi"])))
    its = ranks[0]["max_iters_per_step"]
    launches = sum(r["launches"][kernel] for r in ranks)
    walls = ranks[0]["step_walls_s"]
    exch = [r["exchange_s"] / sum(r["step_walls_s"]) for r in ranks]
    calls = ranks[0]["collectives"]
    print(f"[{tag}] {ndev} gloo ranks on the card ({ranks[0]['dofs']} dofs, "
          f"levels {ref['levels']}): set-up per rank "
          f"{[round(r['setup_s'], 2) for r in ranks]} s (stacked "
          f"{ref['setup_s']:.2f} s), wall per step {walls} s (stacked "
          f"{ref['step_walls_s']} s), the ranks' call {launch_s:.1f} s; "
          f"max|dy| {dy:.3e} of max|y| {ymax:.3e}, max|dphi| {dphi:.3e} of "
          f"max|phi| {phimax:.3e} (limit {RANK_TOL:g} of each); iterations "
          f"per step {its} (stacked {ref['iters']}); {kernel} launches "
          f"{[r['launches'][kernel] for r in ranks]} (stacked "
          f"{ref['launches'][kernel]}); collectives per rank {calls}; "
          f"exchange share of the steps' wall per rank "
          f"{[round(e, 3) for e in exch]}; one shift alone "
          f"{[round(r['shift_ms'], 4) for r in ranks]} ms (its two copies "
          f"{[round(r['staging_ms'], 4) for r in ranks]} ms, gloo on host "
          f"tensors {[round(r['gloo_ms'], 4) for r in ranks]} ms)")
    outer = lpfem_torch.preset("scaling_base", **cfg_kw).ir_max_outer
    if (not dy <= RANK_TOL * ymax or not dphi <= RANK_TOL * phimax
            or any(r["unconverged"] for r in ranks)
            or any(r["max_iters_per_step"] != its for r in ranks)
            or len(its) != steps
            or any(abs(a - b) > outer for a, b in zip(its, ref["iters"]))):
        raise AssertionError(f"{tag}: ranks vs stacked: dy {dy}, dphi "
                             f"{dphi}, iterations {its} vs {ref['iters']}, "
                             f"{ranks}")
    if launches <= 0:
        raise AssertionError(f"{tag}: the ranks launched no {kernel}")
    return dict(max_abs_dy=dy, max_abs_y=ymax, max_abs_dphi=dphi,
                max_abs_phi=phimax, iters=its, stacked_iters=ref["iters"],
                launches=launches,
                launches_per_rank=[r["launches"][kernel] for r in ranks],
                launches_per_step=launches / steps,
                stacked_launches_per_step=ref["launches"][kernel] / steps,
                setup_s=[r["setup_s"] for r in ranks],
                stacked_setup_s=ref["setup_s"], step_walls_s=walls,
                stacked_step_walls_s=ref["step_walls_s"],
                exchange_share=exch, collectives=calls, ranks_call_s=launch_s,
                shift_ms=[r["shift_ms"] for r in ranks],
                staging_ms=[r["staging_ms"] for r in ranks],
                gloo_ms=[r["gloo_ms"] for r in ranks],
                dofs=ranks[0]["dofs"])


def phase_ranks(report: dict) -> dict:
    """11a: the ss.cpp tank of 9b over 4 gloo ranks on the card against the
    stacked 4-shard run; 11b: the leaning tank over 3 ranks."""
    dims, sizes = _tank_dims()
    # a stable dt (T/40): at the protocol's T/10 the state grows
    # (ROADMAP C-known 5), so two valid runs whose inner solves exit one
    # iteration apart drift past 1e-10 of max|y| within two steps; from
    # the closer warm start of T/40, rz0 * 1e-24 lies below the float64
    # outer loop's floor, so r.z <= rz0 * 1e-20
    kw = {**CFG, "cg_rtol_sq": 1e-20, "nsteps": ACCURACY_STEPS}
    out = {"11a": _ranks_vs_stacked("11a", kw, RANK_SHARDS, RANK_STEPS,
                                    None, "sep_apply_shard")}
    _check_no_descendants("after 11a")
    lean = {"fn": "lpfem_torch.experiments.leaning_tank:leaning_tank",
            "kwargs": dict(nx=dims[0], ny=dims[1], nz=dims[2], Lx=sizes[0],
                           Ly=sizes[1], Lz=sizes[2],
                           ref_levels=CFG["ref_levels"], lean="z")}
    out["11b"] = _ranks_vs_stacked("11b", {**kw, **LEAN}, RANK_LEAN_SHARDS, 1,
                                   lean, "lattice_affine_apply_shard")
    _check_no_descendants("after phase 11")
    report["ranks"] = out
    return out


def phase_coarse_cheb(report: dict) -> dict:
    import torch
    from lpfem_torch.experiments.diffraction import build_problem
    from lpfem_torch.kernels import coarse_cheb as kcc

    # the kernel against the eager chain and its plain mirror on the card,
    # on the coarse level of each of phase 4's runs: float64, and the mixed
    # run's float32 preconditioner
    gen = torch.Generator(device="cpu").manual_seed(12)
    errs = {}
    for dtype, tol in (("mixed", 1e-5), ("float64", 1e-12)):
        prob = build_problem("cuda", dtype=dtype, mesh=_study_mesh())
        pm = prob.precond
        if pm.coarse_route != "fused":
            raise AssertionError(f"{dtype}: the study's coarse route is "
                                 f"{pm.coarse_route!r}, not 'fused'")
        cc = pm.coarse_solve
        lv = pm.levels[-1]
        ne, n = lv.op.space.elem_dofs.shape[0], lv.op.n_dofs
        r = torch.randn(n, generator=gen, dtype=torch.float64).cuda().to(
            lv.op.dtype) * lv.free
        z = cc(r)
        same = torch.equal(cc(r), z)
        rel = {k: _rel_err(z, f(r))[1] for k, f in
               (("eager", cc.chebyshev),
                ("mirror", lambda v: kcc.coarse_cheb_mirror(v, cc)))}
        name = str(lv.op.dtype).removeprefix("torch.")
        print(f"[12] {dtype} run's coarse level p = 1 in {name}: {ne} "
              f"elements, {n} dofs, cluster of {cc.clusters} blocks; fused "
              f"vs eager Chebyshev-{cc.degree} {rel['eager']:.3e}, vs the "
              f"plain mirror {rel['mirror']:.3e} of max|z| (limit {tol:g}), "
              f"same bits twice {same}")
        if not (max(rel.values()) <= tol and same):
            raise AssertionError(f"coarse_cheb {name}: {rel} of max|z|, "
                                 f"same {same}")
        errs[name] = rel
        if dtype == "mixed":
            del prob, pm, cc, lv
            torch.cuda.empty_cache()
    eager = cc.chebyshev

    # device ms per coarse solve, the kernel and the eager chain
    ms = {"fused": _time_chain(cc, [(r,)]), "eager": _time_chain(eager,
                                                                [(r,)])}
    per = {k: _per_call(_profile_calls(f, [(r,)]))
           for k, f in (("fused", cc), ("eager", eager))}
    for k in ("fused", "eager"):
        print(f"[12] {k} coarse solve: {ms[k]:.4f} ms a solve (CUDA events, "
              f"30 solves), device {per[k]['launch_ms']:.4f} ms over "
              f"{per[k]['kernels_per_call']:.1f} kernels, "
              f"{per[k]['memsets'] / CHAIN:.1f} memsets, "
              f"{per[k]['copies'] / CHAIN:.1f} copies a solve")
    ne_max = cc.tables.eaddr.shape[2]
    smem = kcc.smem_bytes(8, ne_max, cc.nd_max, cc.mult)
    ptxas = {k: v for k, v in report.get("ptxas", {}).items()
             if "coarse_cheb_kernel" in k}
    print(f"[12] shared memory {smem} bytes a block (ne_max {ne_max}, "
          f"nd_max {cc.nd_max}, {cc.mult} copies a dof at most); ptxas "
          f"{ptxas}")

    # device activities per V-cycle, fused and eager coarse solve
    r0 = torch.randn(pm.levels[0].op.n_dofs, generator=gen,
                     dtype=torch.float64).cuda() * pm.levels[0].free
    vcycle = {}
    for k, solve in (("fused", cc), ("eager", eager)):
        pm.coarse_solve = solve
        acts = _profile_calls(pm, [(r0,)])
        vcycle[k] = dict(activities=sum(c for _, c, _ in acts) / CHAIN,
                         **_per_call(acts))
        print(f"[12] a V-cycle with the {k} coarse solve: "
              f"{vcycle[k]['activities']:.1f} device activities "
              f"({vcycle[k]['kernels_per_call']:.1f} kernels)")
    pm.coarse_solve = cc

    # the untraced step wall, fused and eager, from one state; the launches
    # against the V-cycles
    t, y, phi = prob.run(n_steps=1)
    torch.cuda.synchronize()
    steps, walls, iters = 3, {"fused": [], "eager": []}, {}
    for k in ("fused", "eager", "eager", "fused"):
        pm.coarse_solve = cc if k == "fused" else eager
        before = sum(kcc.LAUNCHES.values())
        with _count_vcycles() as calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prob.run(n_steps=steps, t0=t, state=(y.clone(), phi.clone()))
            torch.cuda.synchronize()
            walls[k].append((time.perf_counter() - t0) / steps)
        launched = sum(kcc.LAUNCHES.values()) - before
        want = calls[0] if k == "fused" else 0
        if launched != want:
            raise AssertionError(f"{k}: {launched} coarse_cheb launches "
                                 f"over {calls[0]} V-cycles")
        iters.setdefault(k, prob.last_solver_stats.total_iters)
        print(f"[12] {k}: {walls[k][-1]:.4f} s a step untraced, "
              f"{calls[0]} V-cycles, {launched} coarse_cheb launches, "
              f"{prob.last_solver_stats.total_iters} inner iterations")
    pm.coarse_solve = cc
    if iters["fused"] != iters["eager"]:
        raise AssertionError(f"iterations differ: {iters}")
    wf = statistics.median(walls["fused"])
    we = statistics.median(walls["eager"])
    vcs = calls[0] / steps
    share = (we - wf + vcs * ms["fused"] / 1e3) / we
    print(f"[12] untraced step: fused {wf:.4f} s, eager {we:.4f} s "
          f"({100 * (1 - wf / we):.1f} % less); the eager coarse solve's "
          f"share of its step {100 * share:.1f} % ({vcs:.0f} V-cycles a "
          f"step)")
    tank = report["ss_path"]["launches"]["coarse_cheb"]
    print(f"[12] coarse_cheb launches in phase 3's tank: {tank}")
    if tank != 0:
        raise AssertionError(f"the tank launched coarse_cheb {tank} times")
    # the bound: the metric, r, inv_diag, z and the tables read or written
    # once; the element applies and updates of the degree - 1 steps
    nbytes = 8 * (48 * ne + 3 * n) + 4 * (8 * ne + cc.mult * n + n)
    flops = (cc.degree - 1) * (_element_flops(ne, 2, 2) + 6 * n)
    bound_ms, bound_by = _bound(nbytes, flops, PEAK_FLOPS["float64"])
    print(f"[12] bound {bound_ms:.5f} ms ({bound_by}: {nbytes} bytes, "
          f"{flops} flops) against {per['fused']['launch_ms']:.4f} ms")
    out = dict(clusters=cc.clusters, smem_bytes=smem, ptxas=ptxas,
               max_rel_err=errs, ms=ms,
               bound_ms=bound_ms, bound_by=bound_by,
               per_solve=per, vcycle=vcycle, step_walls=walls,
               inner_iters=iters, vcycles_per_step=vcs,
               eager_coarse_share=share, tank_launches=tank)
    report["coarse_cheb"] = out
    del prob
    torch.cuda.empty_cache()
    return out


# passes over the vector of each step mode: the kernel's (operands read
# once, d and z written once) and the eager chain's
CHEB_PASSES = {"zero": (4, 9), "z0": (6, 11), "step": (7, 16)}


def _eager_smoother(sm, r, z0=None):
    """``sm(r, z0)`` with each step's eager expressions on the card."""
    from lpfem_torch.kernels import cheb_step as kcs
    d, z = kcs.cheb_first_reference(r, sm.inv_diag, sm.theta, z0,
                                    None if z0 is None else sm.apply_fn(z0))
    for c1, c2 in sm.coefs:
        d, z = kcs.cheb_step_reference(r, sm.apply_fn(z), sm.inv_diag, d, z,
                                       c1, c2)
    return z


def phase_cheb_step(report: dict) -> dict:
    import torch
    import lpfem_torch
    from lpfem_torch.kernels import cheb_step as kcs
    from lpfem_torch.kernels.coarse_cheb import chebyshev_coefficients
    from lpfem_torch.multigrid import ChebyshevSmoother, _Level
    from lpfem_torch.operators import SeparableLattice
    from lpfem_torch.space import LatticeSpace

    gen = torch.Generator(device="cuda").manual_seed(13)
    theta = 1.5121337882677715    # float32 1 / theta rounds two ways
    c1, c2 = chebyshev_coefficients(theta, 1.4145, 4)[1]
    rows = []
    for n in (17_105_920, 2_179_584):
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).removeprefix("torch.")
            v = {k: torch.randn(n, generator=gen, device="cuda",
                                dtype=dtype)
                 for k in ("r", "Az", "d", "z", "z0")}
            v["inv_diag"] = torch.rand(n, generator=gen, device="cuda",
                                       dtype=dtype) + 0.5
            r, Az, invD, z0 = v["r"], v["Az"], v["inv_diag"], v["z0"]
            d, z = v["d"], v["z"]
            fused = {
                "zero": lambda: kcs.cheb_first(r, invD, theta, d, z),
                "z0": lambda: kcs.cheb_first(r, invD, theta, d, z, z0=z0,
                                             Az0=Az),
                "step": lambda: kcs.cheb_step(r, Az, invD, d, z, c1, c2)}
            eager = {
                "zero": lambda: kcs.cheb_first_reference(r, invD, theta),
                "z0": lambda: kcs.cheb_first_reference(r, invD, theta, z0,
                                                       Az),
                "step": lambda: kcs.cheb_step_reference(r, Az, invD, d, z,
                                                        c1, c2)}
            for mode, (kp, ep) in CHEB_PASSES.items():
                d_ref, z_ref = eager[mode]()
                fused[mode]()
                torch.cuda.synchronize()
                same = torch.equal(d, d_ref) and torch.equal(z, z_ref)
                if not same:
                    raise AssertionError(
                        f"cheb_step {mode} {name} n = {n}: not the eager "
                        f"bits (d {float((d - d_ref).abs().max()):.3e}, z "
                        f"{float((z - z_ref).abs().max()):.3e})")
                del d_ref, z_ref
                size = r.element_size()
                per = _per_call(_profile_calls(fused[mode], [()]))
                ev = _time_chain(fused[mode], [()])
                bound_ms, _ = _bound(kp * n * size, 0, 1.0)
                ms = per["launch_ms"]
                # the eager chain by CUDA events: the profiler drops some
                # of its launches, and two of them share a kernel's name
                row = dict(n=n, dtype=name, mode=mode, same_bits=same,
                           ms=ms, events_ms=ev,
                           kernels_per_call=per["kernels_per_call"],
                           eager_ms=_time_chain(eager[mode], [()]),
                           bound_ms=bound_ms,
                           eager_bound_ms=_bound(ep * n * size, 0, 1.0)[0],
                           tb_per_s=kp * n * size / ms / 1e9,
                           share=bound_ms / ms)
                rows.append(row)
                print(f"[13] {mode:4s} {name} n = {n}: {ms:.4f} ms device "
                      f"({row['kernels_per_call']:.1f} kernels), "
                      f"{ev:.4f} ms events, bound {bound_ms:.4f} ms "
                      f"({kp} passes), {row['tb_per_s']:.3f} TB/s = "
                      f"{100 * row['share']:.1f} % of 3.35; eager "
                      f"{row['eager_ms']:.4f} ms (events; {ep} passes, "
                      f"bound {row['eager_bound_ms']:.4f} ms); same bits")
            del v, r, Az, invD, z0, d, z, fused, eager
            torch.cuda.empty_cache()

    # a whole Chebyshev-4 call on the order-8 tank's top level
    sp = LatticeSpace.from_config(lpfem_torch.preset(
        "scaling_base", order=8, ref_levels=2))
    lv = _Level(SeparableLattice(sp, torch.float64, "cuda"))
    sm = ChebyshevSmoother(lv.apply_c, lv.inv_diag, 2.9, degree=4)
    r = torch.randn(lv.op.n_dofs, generator=gen, device="cuda",
                    dtype=torch.float64) * lv.free
    z0 = torch.randn(lv.op.n_dofs, generator=gen, device="cuda",
                     dtype=torch.float64) * lv.free
    calls = {}
    for start, args in (("zero", (r,)), ("z0", (r, z0))):
        if not torch.equal(sm(*args), _eager_smoother(sm, *args)):
            raise AssertionError(f"Chebyshev-4 from {start}: not the eager "
                                 f"chain's bits")
        before = kcs.LAUNCHES
        sm(*args)
        steps = kcs.LAUNCHES - before
        calls[start] = dict(
            fused_ms=_time_chain(sm, [args]),
            eager_ms=_time_chain(lambda *a: _eager_smoother(sm, *a),
                                 [args]), step_launches=steps)
        c = calls[start]
        print(f"[13] Chebyshev-4 from {start} on {lv.op.n_dofs} dofs (p = "
              f"8, float64), CUDA events: fused {c['fused_ms']:.4f} ms a "
              f"call ({steps} step launches), eager {c['eager_ms']:.4f} "
              f"ms; same bits")
    ptxas = {k: v for k, v in report.get("ptxas", {}).items()
             if "cheb_step_kernel" in k}
    print(f"[13] ptxas {ptxas}")
    out = dict(rows=rows, smoother_p8=calls, ptxas=ptxas)
    report["cheb_step"] = out
    del lv, sm, r, z0
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import warnings
    # torch's notes that sparse CSR is beta / unchecked (the yardsticks)
    warnings.filterwarnings("ignore", message="Sparse")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    import lpfem_torch  # noqa: F401  (fails here when run outside a checkout)
    report: dict = {"phase_s": {}}
    t_start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(report, *args)
        report["phase_s"][name] = time.perf_counter() - t0
        print(f"[{name[0]}] phase {name} took "
              f"{report['phase_s'][name]:.1f} s")
        return out

    timed("1 build", phase_device_and_build)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    sep = timed("2 sep_apply", phase_sep_apply)
    pa = timed("2 pa_apply", phase_pa_apply)
    b3a, b2 = timed("2 affine kernels", phase_affine)
    ds = timed("2 sep_apply_ds", phase_sep_apply_ds)
    ss = timed("3 ss.cpp path", phase_ss_path)
    pa_launches = timed("4 diffraction", phase_diffraction)
    launches = timed("5 general mesh", phase_general_mesh, ss["err"])
    ds_launches = timed("6 double-single outer", phase_ds_path, ss)
    bench_rows = timed("7 bench twin", phase_bench)
    orders = sorted(timed("8 drivers", phase_drivers)
                    | set(bench_rows["refs2"]["launches"]["sep_apply_by_p"]))
    shard_k = timed("9a sharded kernels", phase_sharded_kernels)
    shard = timed("9b sharded path", phase_sharded_path)
    lean = timed("9c sharded leaning tank", phase_sharded_lean)
    timed("9d sharded drivers", phase_sharded_drivers)
    wide = timed("10a wide orders", phase_wide_orders)
    gmsh = timed("10b gmsh", phase_gmsh)
    timed("10c assembled", phase_assembled)
    timed("10d sharded assembled", phase_sharded_assembled)
    timed("10e native and io", phase_native_io)
    timed("10f glvis", phase_glvis)
    timed("10g drivers", phase_new_drivers)
    ranks = timed("11 ranks", phase_ranks)
    coarse = timed("12 coarse solve", phase_coarse_cheb)
    cheb = timed("13 smoother steps", phase_cheb_step)
    report["total_s"] = time.perf_counter() - t_start
    element_orders = {
        "pa_apply_element": set(report["diffraction"]["float64"][
            "b3b_calls_per_step_by_p"]) | set(gmsh["b3b_by_p"]),
        "pa_apply_affine": set(report["path_b"]["launches_per_step_by_p"]),
        "lattice_affine_apply": set(report["path_a"][
            "launches_per_step_by_p"])}
    element_orders = {k: sorted(v | set(wide["orders"][k]))
                      for k, v in element_orders.items()}
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"total {report['total_s']:.1f} s")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    cyl_runs = [report["diffraction"][d] for d in ("float64", "mixed")]
    kernels = {"kernels": [
        dict(name="sep_apply", route="cuda",
             source="lpfem_torch/csrc/sep_apply.cu",
             replaces="lpfem/kernels/sep_apply.py:230",
             launches=ss["launches"], path_c_launches=launches["C"],
             launches_per_step_by_p=report["ss_path"][
                 "b1_calls_per_step_by_p"],
             orders_on_path=orders,
             bench_refs2_launches=bench_rows["refs2"]["launches"][
                 "sep_apply"],
             stationary_tank_ms_by_p={
                 f"{r['p']} {r['dtype']}": r["ms"]
                 for r in report["sep_apply_conv_times"]},
             **{k: sep[k] for k in keys}),
        dict(name="pa_apply_element", route="cuda",
             source="lpfem_torch/csrc/pa_apply.cu",
             replaces="lpfem/kernels/pa_apply.py:124",
             launches=pa_launches, library_ms=None,
             launches_per_step_by_p=report["diffraction"]["float64"][
                 "b3b_calls_per_step_by_p"],
             full_apply_ms=pa["full_apply_ms"],
             library_full_apply_ms=pa["library_full_apply_ms"],
             orders_on_path=element_orders["pa_apply_element"],
             wide_orders=wide["rows"]["pa_apply_element"],
             **{k: pa[k] for k in keys if k != "library_ms"}),
        dict(name="pa_apply_affine", route="cuda",
             source="lpfem_torch/csrc/pa_apply.cu",
             replaces="lpfem/kernels/pa_apply.py:73",
             launches=launches["B"],
             launches_per_call=b3a["launches_per_call"], redesigned=True,
             orders_on_path=element_orders["pa_apply_affine"],
             wide_orders=wide["rows"]["pa_apply_affine"],
             **{k: b3a[k] for k in keys}),
        dict(name="lattice_affine_apply", route="cuda",
             source="lpfem_torch/csrc/lattice_apply.cu",
             replaces="lpfem/kernels/lattice_apply.py:238",
             launches=launches["A"],
             launches_per_call=b2["launches_per_call"], redesigned=True,
             orders_on_path=element_orders["lattice_affine_apply"],
             wide_orders=wide["rows"]["lattice_affine_apply"],
             three_step_device_ms=b2["three_step_device_ms"],
             b1_device_ms=b2["b1_device_ms"],
             **{k: b2[k] for k in keys}),
        dict(name="coarse_cheb", route="cuda",
             source="lpfem_torch/csrc/coarse_cheb.cu",
             replaces="none: the eager Chebyshev-16 coarse solve",
             launches=sum(sum(r["launches"]["coarse_cheb_by_dtype"].values())
                          for r in cyl_runs),
             launches_by_dtype={
                 k: v for r in cyl_runs
                 for k, v in r["launches"]["coarse_cheb_by_dtype"].items()},
             vcycles=sum(r["vcycles"] for r in cyl_runs),
             max_abs_err=None, max_rel_err=coarse["max_rel_err"],
             ms=coarse["per_solve"]["fused"]["launch_ms"],
             plain_ms=coarse["per_solve"]["eager"]["launch_ms"],
             events_ms=coarse["ms"], bound_ms=coarse["bound_ms"],
             bound_by=coarse["bound_by"], library_ms=None,
             launches_per_call=coarse["per_solve"]["fused"][
                 "kernels_per_call"],
             vcycle_activities={k: v["activities"] for k, v in
                                coarse["vcycle"].items()},
             smem_bytes=coarse["smem_bytes"], ptxas=coarse["ptxas"]),
        dict(name="cheb_step", route="cuda",
             source="lpfem_torch/csrc/cheb_step.cu",
             replaces="none: the smoother's eager vector updates",
             launches=report["ss_path"]["launches"]["cheb_step"],
             max_abs_err=0.0, launches_by_dtype=report["ss_path"]["launches"][
                 "cheb_step_by_dtype"],
             rows=cheb["rows"], smoother_p8=cheb["smoother_p8"],
             ptxas=cheb["ptxas"]),
        dict(name="sep_apply_ds", route="cuda",
             source="lpfem_torch/csrc/sep_apply_ds.cu",
             replaces="lpfem/kernels/sep_apply_ds.py:291",
             launches=ds_launches,
             launches_per_call=ds["launches_per_call"], redesigned=True,
             bound_counts=ds["bound_counts"], b1_f64_ms=ds["b1_f64_ms"],
             spmv_f64_ms=ds["spmv_f64_ms"],
             **{k: ds[k] for k in keys}),
        dict(name="sep_apply_shard", route="cuda",
             source="lpfem_torch/csrc/sep_apply.cu",
             replaces="lpfem/kernels/sep_apply.py:238",
             launches=shard["launches"]["sep_apply_shard"],
             launches_per_step_by_p=shard["b1_shard_calls_per_step_by_p"],
             launches_under_ranks=ranks["11a"]["launches"],
             launches_per_step_under_ranks=ranks["11a"]["launches_per_step"],
             window=shard_k["sep_apply_shard"]["window_dofs"],
             launches_per_apply=shard_k["sep_apply_shard"][
                 "launches_per_apply"],
             **{k: shard_k["sep_apply_shard"][k] for k in keys}),
        dict(name="lattice_affine_apply_shard", route="cuda",
             source="lpfem_torch/csrc/lattice_apply.cu",
             replaces="lpfem/kernels/lattice_apply.py:245",
             launches=lean["launches"]["lattice_affine_apply_shard"],
             launches_under_ranks=ranks["11b"]["launches"],
             launches_per_step_under_ranks=ranks["11b"]["launches_per_step"],
             window=shard_k["lattice_affine_apply_shard"]["window_dofs"],
             launches_per_apply=shard_k["lattice_affine_apply_shard"][
                 "launches_per_apply"],
             **{k: shard_k["lattice_affine_apply_shard"][k] for k in keys})]}
    _check_no_descendants("before the last line")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
