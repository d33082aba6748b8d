#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ndsm_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):

  1. device: the card's name and ``nvidia-smi`` name/power limit; the
     kernels are built from ``ndsm_tpu_torch/csrc`` and the build timed;
     ptxas's registers, stack and spills of every kernel ("[pass]" for
     the multi-sweep pass).
  2. kernels: each CUDA kernel wrapper against its plain PyTorch version
     on the card, bitwise, each timed beside its plain version (CUDA
     events, warm, median of 7, plain-kernel-kernel-plain):
       - the pass plan (``zc.pass_plan``) of every level of path 1;
       - the 3D smoothers and the defect at the main path's 220^3 and
         110^3 levels (float64 for the defect), three component BC sets;
         the defect's four forms also at odd extents (221x219x37,
         37x45x29, 2x3x5: partial column tiles, a short last z chunk);
       - the one-lane calls of the 3D red-black pass (zc_smooth_3d, which
         is also fused_smooth_3d, and the residual and correction forms)
         at path 1b's 55^3, 27^3, 13^3 and 6^3 levels, 221x220x220 and
         2x3x5;
       - the lane forms (the three forms on the three component lanes
         stacked) at every level of path 1 (220^3 down to 6^3) and 2x3x5,
         also against three per-lane zc kernel calls and with the Az lane
         frozen; at 220^3 and 110^3 timed;
       - the pass plan's measurements ("[width]"): at every level, three
         lanes, the plan as fixed and marching passes of width 1, 2 and 3
         (device busy time, each bitwise against the plain lane form);
       - the 2D smoother (v2d) at every level it smooths on the chi faces
         of a 220^3 and a 512^3 box (220^2 down to 6^2, 512^2 down to
         4^2), (221, 220), the one-block/cluster boundaries (168^2,
         169^2, 234^2, 235^2) and 700^2 (past a 16-block cluster: the
         global route), one lane and six, all-Neumann and mixed BCs,
         each shape's plan printed ("[v2d plan]": the one-block, cluster or
         global route, C, rows a block, shared bytes); timed on six 220^2
         and six 512^2 lanes; the lane kernel against the previous design
         (the one-block global-memory kernel, still the route of lanes past
         a 16-block cluster, also held bitwise there) in turns at six
         110^2, 220^2 and 512^2 lanes,
         with device busy times ("[design]"); the plan's cluster size
         against larger ones at six 220^2 and 512^2 lanes ("[v2d C]");
       - the all-Neumann 3D smoother (one launch a call: a cooperative
         grid, or one block for a level that fits its shared memory), each
         shape's plan printed ("[mean plan]"), bitwise at every level of
         the 128^3 and 256^3 hierarchies, 220^3, 33^3 and 65x64x63, ns 1, 2
         and 5, on the plan's route and on the grid route where the plan
         takes the block route; timed at 220^3, 128^3, 256^3 and 16^3 with
         each call's host enqueue and device events (more than one device
         event a call fails the phase);
       - the colour-split smoother (compact_smooth_3d: ceil(ns / w)
         launches of the halves form of the pass, "[compact plan]" lines
         for every level of path 3) with its split and merge passes at
         220^3, 110^3, 55^3 and 221x220x221 (odd nx), three component BC
         sets: halves against the plain version (ghosts included), merged
         against the dense kernel zc_smooth_3d, the split and merge as an exact round
         trip; the lane form on the three stacked lanes at 220^3 and 110^3
         against three one-lane calls and with the Az lane frozen; the
         whole dense-interface call (split, sweeps, merge) timed beside
         zc_smooth_3d;
       - ``DiffusionOperator``'s sweep and residual (csrc/diffusion.cu)
         bitwise at 257^3, 129^3, 65x64x63 and 2x3x5, float32 and float64,
         three face sets, two coefficients, both colour flips; timed at
         257^3 ("[diffusion]", "[time]": the float32 sweep and the float64
         residual are the table's rows).
  3. path 1, the main path: ``vector_potential`` in mixed precision with
     default options (the three component solves batched on the card) on
     the analytic potential-field case at 22^3 and 220^3, checked against
     the golden rows (bench.py's gate: |err - golden| < 2e-3 golden); the
     launch counters are zeroed before the warm 220^3 run and every kernel
     of the path (the three lane forms, the defect, the three v2d forms)
     must have launched during it, with no plain version run on the card;
     the pass launches behind the 3D smoothing calls are counted (paths 1
     and 1b); each v2d form launched once a float32 chi level and V-cycle
     (85 at 220^3), on the one-block and cluster routes and never the
     global one.
     One more 220^3 run under torch.profiler gives the device busy time,
     the kernels that take it, and the chi phase's launches and idle share.
     Path 1b: the same 220^3 case with ``batch_components="off"`` (the
     components one after the other: the one-lane 3D smoothers and the
     defect), golden-checked, counted, and held to path 1: per-component
     cycles within 1, max|A_on - A_off| <= 5e-9.
     Path 3: the same case with ``Options(smoother="compact")``, components
     batched: the colour-split lane kernel with its split and merge passes
     must have launched and the dense lane smoothers must not; the compact
     pass launches of the warm call are counted and must be there, the
     dense pass's must not.  Path 3b: the same with
     ``batch_components="off"`` (the one-lane calls).  Both
     are held to path 1 like path 1b, and the script prints whether A is
     exactly the dense route's of the same batching.  Each route runs three times
     warm without the profiler (once counted, twice in turns); paths 1, 1b
     and 3 run once more under the profiler.
     The sharded kernels (B10 and B11 of the sharded engine, and their
     (z, y) forms B10y and B11y) on the blocks of a level cut over a z mesh
     or a (z, y) mesh on the one card and halo-extended by the port's
     collectives (z, then y on the z-extended blocks): 220^3 over 2 (110
     planes) and 4 (55 planes, odd offsets) and 256^3 over 4 on a z mesh,
     Ax and Az BCs (Dirichlet and Neumann z faces); 220^3 over 2 x 2
     (110 x 110) and 4 x 2 (55 x 110) and 256^3 over 4 x 2 (64 x 128) on a
     (z, y) mesh, Ax, Az and Ay BCs (Neumann y faces too): each kernel (ns
     1, 2, 5, with and without the residual, on every shard; the defect in
     its four forms on every shard, r32 over the real block and v over the
     whole extended block) against its plain version,
     the stitched shards against the unsharded zc_smooth_3d /
     zc_smooth_residual_3d / df_residual_3d of the whole level, and the
     engine's passes of width 2 (width 1 on 256^3's 4-plane blocks) with
     their exchanges against the unsharded 5-sweep kernels; all bitwise.
     B10/B10y are one launch a call of the pass's shard form ("[shard
     plan]": its tile, window and grid at level 0; more than one device
     event a call fails the phase).  Timed at the level 0
     of paths 4 and 4b (shard 0 with its halo).  B11/B11y are one launch
     of the shard form of the defect's z-marching tile, timed there too.
  4. path 2: a 3D all-Neumann mixed ``PoissonBVP.solve`` on
     u = cos(pi x) cos(pi y) cos(pi z) at 128^3 and 256^3; ierr 0,
     zc_smooth_mean_3d launched, no plain version on the card, and the
     error against the exact solution falls as h^2 (ratio 3.5-4.5); one
     more warm solve of each under torch.profiler: its device events, busy
     time, idle share and the all-Neumann kernel's launches.
     Path 4: ``vector_potential(..., dist=DistConfig(make_mesh(2,
     devices=["cuda:0"] * 2)))`` and path 4b: ``dist=DistConfig(
     make_mesh_nd((2, 2), devices=["cuda:0"] * 4), ("z", "y"))``, each at
     22^3 and 220^3, mixed: golden digits exact, cycles within 1 of path 1b
     per chi face and component, max|A_dist - A_1b| <= 5e-9, their mesh's
     per-shard kernels launched (B10/B11, or B10y/B11y) and the other
     mesh's not, no plain sharded 3D route and no plain version on the
     card, the messages and bytes of a warm call printed, max|A_4b - A_4|
     printed; timed in turns with path 1b.  Paths 5 and 5b:
     ``ShardedPoissonBVP`` at 256^3, Ax BCs, mixed, over a z mesh of 4 and
     a (z, y) mesh of 4 x 2, held to ``PoissonBVP`` on the card (cycles
     within 1, max|u_sh - u| <= 5e-9).  Path 5c: path 5's engine's
     ``solve_checkpointed`` every 4 and every 32 cycles, bitwise equal to
     each other, within 5e-9 of its strict sibling's ``solve`` (the line
     says whether bitwise), a resume from the every-4 file running no
     cycle; B10 and B11 launched, no plain sharded 3D route on the card.
  5. path 6: ``solve_poisson_bvp(..., device="cuda")`` without an
     operator, mixed, Ax BCs, u* = sin(pi z) sin(pi y) cos(pi x) at 129^3
     and 257^3: ierr 0, the error falls as h^2 (ratio 3.5-4.5), the warm
     257^3 call launched B1-B4 (the one-lane 3D smoothers and the defect)
     with no plain version on the card, and ran once more under
     torch.profiler; on its BVP ``solve(history=True)`` gives solve's u bit
     for bit and one du a cycle; ``solve_checkpointed`` every 4 and every
     32 cycles (two files in a temporary directory) gives the same u bit
     for bit, within 5e-9 of ``solve`` with ``mixed_inner_max=1`` (the
     line says whether bitwise), and a second call on the 4-cycle file
     runs no cycle.  ``vcycle``, ``two_grid`` (ngrids=2, niterex_max=4) and
     ``one_grid`` (niterex_max=200) at 33^3 in fp32, within 1e-5 max|u| of
     the port's CPU run, with the one-lane 3D smoothers launched.
     Paths 7 and 7b: ``solve_poisson_bvp`` with ``HelmholtzOperator(1.9)``
     (vc_tol 1e-10) and ``DiffusionOperator(lambda a, b, c: 1 + a*b*c)``,
     Dirichlet boxes, mixed, at 129^3 and 257^3 on the manufactured cases
     of examples/helmholtz_operator.py and diffusion_operator.py: ierr 0,
     error ratio 3.5-4.5, no plain version run during the warm calls, no
     kernel launched under Helmholtz (plain tensor code) and only its own
     two (csrc/diffusion.cu) under the diffusion operator, each 257^3 call
     profiled once; the generic coarse assembly timed on the host.
  6. path 8: both golden tables through
     ``ndsm_tpu_torch.examples.integration_scaling`` (--warm, mixed,
     components batched; the max metric with default options, the mean
     metric with --mean --strict), each written with --out and
     digit-compared by scripts/compare_golden.py: ierr 0 and bench.py's
     gate in every cell, the 22^3 and 220^3 max rows digit-exact; the
     digit-exact counts, the power-law indices beside the reference's and
     each row's warm wall printed, and a row with a differing digit run
     again with the other ``mixed_inner_max``.  Path 8b:
     ``examples.unit_test_2d_solve`` at its nine sizes (27 x 36 to 675 x
     900, all-Neumann, mixed), each size's v2d plan printed: ierr 0, index
     1.9-2.1, every row within 1e-4 relative of
     docs/unit_test_2d_solve_r04.txt, the v2d forms launched with the
     global route among them.  Path 9: 220^3 with the default device curl,
     ``host_curl=True`` and ``host_curl`` with ``fetch_encoding="split16"``
     in turns, three times each, every phase printed: host_curl's A bitwise
     the default's, B within 1e-13 max|B| (the line says whether bitwise);
     split16's A within max|A - f32(A)| / 32767 with the golden digits; one
     ``output_dtype="float32"`` call.  Path 10: ``per_face=True`` at 22^3
     and 220^3 in the gate, the one-lane kernels and the defect launched
     and no lane form, A and B within 1e-6 / 1e-4 of path 1b's.  Then
     ``utils.profiling``: a warm 220^3 call inside ``trace`` (the file must
     name both phase ranges and the lane pass) and a ``Timer`` with
     ``sync`` around three calls.
  7. the multi-process paths (gloo ranks started as fresh interpreters of
     ``ndsm_tpu_torch.parallel._mh_worker``, each under a timeout; two
     ranks on the one card measure host staging and process overlap, not
     a multi-card cost).  Path 11: ``multihost.dryrun(2, 2,
     device="cuda")`` (JAX's worker problem, u bitwise the one-process
     mesh on every rank, the messages and bytes summed over the ranks equal
     to its counts, the checksum within 1e-8 of ``PoissonBVP``); then
     ``ShardedPoissonBVP`` at 256^3, Ax, mixed on a (2, 2) (z, y) mesh of 2
     ranks with 2 positions each on ``cuda:0`` (``min_rows_per_shard=8``:
     256^3 to 16^3 sharded, 8^3 and 4^3 on the root), held to the same mesh
     driven from this process: u bitwise on both ranks, the same cycles,
     the summed messages and bytes equal, the remote and sync traffic and
     both walls printed, B10y and B11y launched on every rank, B1-B3 on the
     root's rank only; ``solve_checkpointed`` every 4 (rank 0 writes) bitwise
     the strict sibling's ``solve``, and a second pair of ranks resuming
     from the file runs no cycle and gives the same u.  The NCCL form (one
     rank a card) runs the same dryrun and 256^3 solve where there are two
     cards or more; on one card a line says it was not run and why.
     Path 11b: ``vector_potential(dist=...)`` at 220^3, mixed, over 2 ranks
     (a z mesh, one position each, on ``cuda:0``): golden digits, the cycles
     of path 4, max|A_mp - A_4| and max|B_mp - B_4| both 0.0 on both ranks,
     the walls beside path 4's.  Path 12: ``PoissonBVP(shard_spec=
     ShardSpec(make_mesh(4, devices=["cuda:0"] * 4), min_rows_per_shard=4))``
     at 256^3, Ax, mixed: u bitwise path 5's, B10/B11 launched.  The
     ranks' launch counts go into ``launches_by_path``.
  8. the last pieces of the sharded API (after path 7).  Paths 13 and 13b:
     paths 7/7b's Helmholtz and diffusion cases through
     ``solve_poisson_bvp(..., shard_spec=ShardSpec(make_mesh(4,
     devices=["cuda"] * 4)))`` at 128^3 and 256^3, mixed, and at 256^3
     over a 2 x 2 (z, y) mesh: the error ratio 3.5-4.5, against the same
     operator's unsharded 256^3 solve on the card (cycles within 1,
     max|u_sh - u| <= 5e-9 max|u|), no Poisson kernel, no plain version
     and no plain sharded route launched (13b launches the diffusion
     operator's own kernels on the blocks), the messages and bytes, the warm walls
     beside path 7/7b's, the 256^3 z-mesh solve profiled.  Path 13c: the
     reduced drivers under the spec, Poisson, fp32, Ax: ``vcycle`` and
     ``two_grid`` (level 1 sharded) at 256^3, ``one_grid`` at 64^3, each
     within 1e-5 max|u| of the unsharded driver on the card, B10 (and on
     ``vcycle`` B1-B3) launched.  Path 11c: 2 gloo ranks laid out along y
     of a (2, 2) mesh: ``ShardedPoissonBVP(axis_names=("z",))`` at 256^3
     on each rank's own z line, u bitwise the one-process mesh on both
     ranks with no message across processes; ``vector_potential(dist=
     (z, y))`` at 220^3, golden digits, A and B exactly path 4b's.  The
     new phases' seconds and the whole run's are printed.
  9. ``[native]``: the port's native core (``ndsm_tpu_torch/native``,
     C++/OpenMP compiled with g++ on the card's host at first use) as an
     independent float64 oracle of whole solves.  (a) The fp64 route,
     which runs no kernel: ``solve_poisson_bvp(..., device="cuda")`` in
     fp64 with ``smoother="masked"``, ``coarse_solver="relax"`` on the
     Dirichlet sine case (u* = sin(pi x) sin(pi y) sin(pi z)) at 129^3 and
     257^3 against ``solve_poisson_bvp_native`` on the host: the same
     cycles, max|u_card - u_native| <= 1e-11 max|u|, the error ratio
     3.5-4.5 in both.  (b) The mixed kernel path: ``vector_potential``
     with default ``Options`` on the card at 22^3 and 110^3 against
     ``vector_potential_native``: bench.py's gate on Ea_max and Eb_max for
     both (the golden row at 22^3, the h^2 prefactor at 110^3), the
     native 22^3 errors the golden values at rtol 1e-4, the nine solves'
     cycles side by side, max|A_card - A_native| / max|A| and the same for
     B within ``NATIVE_REL``, the lane smoothers (B5), the defect (B4) and
     the v2d forms (B7) launched in each counted call.  (c) The phase's
     wall, each native solve's wall, the host CPU (``lscpu``), the core's
     OpenMP threads and the card's name and power limit.
 10. the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

Imports only the port, torch, numpy and the standard library.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

# (n) -> (Ea_max, Eb_max): the reference's golden rows
# (tests/integration_test/results_test1.txt, as in bench.py).
GOLDEN = {22: (1.86048e-03, 7.65805e-02), 220: (1.71483e-05, 7.90579e-04)}
GATE = 2e-3

# Component BC sets of the vector-potential solves, per (z, y, x) axis.
BC_SETS = {
    "Ax": (("D", "D"), ("D", "D"), ("N", "N")),
    "Ay": (("D", "D"), ("N", "N"), ("D", "D")),
    "Az": (("N", "N"), ("D", "D"), ("D", "D")),
}
BC_2D = {"all_neumann": (("N", "N"), ("N", "N")), "mixed": (("D", "N"), ("N", "D"))}
ALL_N_3D = (("N", "N"),) * 3
SWEEPS = (1, 2, 5)
REPS = 7
MS = 5  # Options().ms: the sweeps of every smoothing call on both paths

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# device memory 3.35 TB/s; float32 67 TFLOP/s and float64 34 TFLOP/s
# outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12

# Names of one wrapper: fused_smooth_3d is zc_smooth_3d (ops/fused.py).
ALIASES = {"zc_smooth_3d": ("fused_smooth_3d",)}

# Work of one call per point, at ns sweeps: (bytes, operations, peak).
# Bytes count each input read once and each output written once; the
# operations are the update's adds and multiplies (10 a point-sweep in
# 3D, 7 in 2D), +2 a point-sweep for the mean (its sum and subtraction),
# +13 (3D) / +9 (2D) for a residual, +1 for the correction's add.  The
# per-shard kernels' work is counted from their extended blocks instead
# (``_time_sharded``): their halo planes are read and swept too.
WORK = {
    "zc_smooth_3d": lambda ns: (12, 10 * ns, PEAK_F32),
    "zc_smooth_residual_3d": lambda ns: (16, 10 * ns + 13, PEAK_F32),
    "zc_smooth_cor_3d": lambda ns: (16, 10 * ns + 1, PEAK_F32),
    "df_residual_3d": lambda ns: (24, 14, PEAK_F64),  # f64 u, f32 e in; f32 r, f64 u out
    "zc_smooth_mean_3d": lambda ns: (12, 12 * ns, PEAK_F32),
    "v2d_smooth": lambda ns: (12, 9 * ns, PEAK_F32),
    "v2d_smooth_residual": lambda ns: (16, 9 * ns + 9, PEAK_F32),
    "v2d_smooth_cor": lambda ns: (16, 9 * ns + 1, PEAK_F32),
    "fused_smooth_3d_batched": lambda ns: (12, 10 * ns, PEAK_F32),  # per lane
    "fused_smooth_residual_3d_batched": lambda ns: (16, 10 * ns + 13, PEAK_F32),
    "fused_smooth_cor_3d_batched": lambda ns: (16, 10 * ns + 1, PEAK_F32),
    "fused_smooth_3d": lambda ns: (12, 10 * ns, PEAK_F32),
    # four halves read, two written: 6 half-arrays of 2 bytes a point each
    "compact_smooth_3d": lambda ns: (12, 10 * ns, PEAK_F32),
    "compact_smooth_3d_batched": lambda ns: (12, 10 * ns, PEAK_F32),  # per lane
    "split_colors_3d": lambda ns: (8, 0, PEAK_F32),  # u in, two halves out
    "merge_colors_3d": lambda ns: (8, 0, PEAK_F32),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(key: str, points: int, ns: int, work=None):
    """(least ms the card could take, "bytes" or "operations"), from WORK
    per point, or from ``work`` = (bytes, operations, peak) of the call."""
    b, ops, peak = WORK[key](ns) if work is None else (work[0] / points, work[1] / points,
                                                        work[2])
    tb, to = b * points / PEAK_BYTES * 1e3, ops * points / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_ms(fn, reps: int = REPS) -> float:
    """Median device time of ``fn()`` in ms (CUDA events; one warm call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def enqueue_ms(fn, reps: int = REPS) -> float:
    """Median host time of ``fn()`` in ms, the device idle at its start and
    not waited for at its end: what the host spends issuing the launches."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(out)


def device_ms(fn, reps: int = 5):
    """(device busy ms, device events) of one ``fn()``: the summed durations
    of the device-side events of ``reps`` calls under torch.profiler, over
    ``reps``.  Unlike an event pair around the call it leaves out the gaps
    in which the device waits for the host's next launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(3):  # a profile now and then records a part or nothing: keep the fullest
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
        if sum(e.count for e in dev) > sum(e.count for e in best):
            best = dev
        if sum(e.count for e in best) >= reps:  # every call launches at least once
            break
    if not best:
        raise AssertionError("the profiler recorded no device events")
    return (sum(e.self_device_time_total for e in best) / 1e3 / reps,
            sum(e.count for e in best) / reps)


def device_ms_split(first, second, name, reps: int = 5):
    """Device busy ms and events of one ``first()`` and one ``second()``,
    as ``device_ms``, from one profile over ``reps`` calls of
    each: the events whose kernel name holds ``name`` are ``second``'s,
    the rest ``first``'s."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    first(), second()
    torch.cuda.synchronize()

    def fewest(parts):
        return min(sum(e.count for e in ev) for ev in parts)

    best = [[], []]
    for _ in range(3):  # a profile now and then records a part or nothing: keep the fullest
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                first()
            for _ in range(reps):
                second()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
        parts = [[e for e in dev if (name in e.key) == mine] for mine in (False, True)]
        if fewest(parts) > fewest(best):
            best = parts
        if fewest(best) >= reps:  # every call launches at least once
            break
    if not fewest(best):
        raise AssertionError("the profiler recorded no device events")
    return tuple((sum(e.self_device_time_total for e in ev) / 1e3 / reps,
                  sum(e.count for e in ev) / reps) for ev in best)


def time_pair(kern, plain):
    """(kernel ms, plain ms): plain, kernel, kernel, plain; min of each."""
    p1, k1, k2, p2 = time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain)
    return min(k1, k2), min(p1, p2)


def compare(name: str, got, want):
    """Max |got - want| and the same in ulps of max|want|; raises unless
    bitwise equal."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.abs().max())
    ulp = float(np.spacing(np.float32(scale) if want.dtype == torch.float32 else scale))
    if not torch.equal(got, want):
        raise AssertionError(
            f"{name}: kernel differs from its plain version: max|diff| {err:.3e} "
            f"= {err / ulp:.2f} ulp of max|plain| {scale:.3e}"
        )
    return err, err / ulp


class Stats:
    """Per kernel: worst difference from the plain version, and the times
    (kernel, plain, bound) at the configuration its path runs."""

    def __init__(self):
        self.s = {}

    def note(self, key, err, ulp):
        for k in (key,) + ALIASES.get(key, ()):
            st = self.s.setdefault(k, {"err": 0.0, "ulp": 0.0})
            st["err"] = max(st["err"], err)
            st["ulp"] = max(st["ulp"], ulp)

    def timed(self, key, kern, plain, points, ns, label, headline, busy=False, work=None):
        kms, pms = time_pair(kern, plain)
        bms, by = bound(key, points, ns, work)
        log(f"[time] {key:22s} {label}: kernel {kms:.4f} ms  plain {pms:.4f} ms  bound "
            f"{bms:.4f} ms ({by}; {100 * bms / kms:.1f}% of it)")
        if headline:
            for k in (key,) + ALIASES.get(key, ()):
                self.s[k].update(ms=kms, plain_ms=pms, bound_ms=bms, bound_by=by)
        if headline or busy:
            # what of the event time is the device, and what the host issuing
            hms, (dms, nev) = enqueue_ms(kern), device_ms(kern)
            log(f"[time] {key:22s} {label}: host enqueue {hms:.4f} ms, device busy "
                f"{dms:.4f} ms in {nev:.0f} device events (the bound is "
                f"{100 * bms / dms:.1f}% of it)")
            return nev
        return None


# The defect at odd extents: partial column tiles in y and x, a last z chunk
# shorter than the others, the smallest extents.
DF_ODD = ((221, 219, 37), (37, 45, 29), (2, 3, 5))


def v2d_levels():
    """(shape, dq) of every level the v2d kernel smooths on the chi faces
    of a 220^3 and a 512^3 box (extents >= 3, as mg/engine.py routes
    them), then (221, 220) and the largest and smallest squares of the
    one-block route and of a cluster of two (168^2, 169^2, 234^2, 235^2)."""
    from ndsm_tpu_torch.grids import GridHierarchy
    from ndsm_tpu_torch.utils.testing import build_test_mesh

    out = []
    for n in (220, 512):
        x = build_test_mesh(n)[0]
        h = GridHierarchy.from_mesh((x, x))
        out += [(s, h.dq[l]) for l, s in enumerate(h.shapes) if min(s) >= 3]
    for shape in ((221, 220), (168, 168), (169, 169), (234, 234), (235, 235)):
        out.append((shape, tuple(1.0 / (n - 1) for n in shape)))
    return out


def _plan_text(p):
    return (f"{p.route} route, C={p.cluster}, rows {p.rows} a block, smem {p.smem_bytes} B, "
            f"grid {p.grid}")


def compare_kernel_designs(key, label, pts, plain, previous, kern, name):
    """A kernel beside its previous design on the same inputs, timed in
    turns (plain, previous, new, new, previous, plain; CUDA events, min of
    two medians), then each design's device busy time under torch.profiler
    (the events whose name holds ``name`` are the new kernel's), the host's
    enqueue time of a call of each, and the share of the bound."""
    t = [time_ms(f) for f in (plain, previous, kern, kern, previous, plain)]
    pms, oms, kms = min(t[0], t[5]), min(t[1], t[4]), min(t[2], t[3])
    (obusy, oev), (kbusy, kev) = device_ms_split(previous, kern, name)
    bms, by = bound(key, pts, MS)
    ohost, khost = enqueue_ms(previous), enqueue_ms(kern)
    log(f"[design] {key:32s} {label}: previous {oms:.4f} ms, busy {obusy:.4f} ms ({oev:.0f} "
        f"events, host enqueue {ohost:.4f} ms a call); new {kms:.4f} ms, busy {kbusy:.4f} ms "
        f"({kev:.0f} events, host enqueue {khost:.4f} ms); busy "
        f"{obusy / kbusy:.2f}x, events {oms / kms:.2f}x faster; plain {pms:.4f} ms; bound "
        f"{bms:.4f} ms ({by}) = {100 * bms / kbusy:.1f}% of the new busy time, "
        f"{100 * bms / obusy:.1f}% of the previous; new faster: {kbusy < obusy}")


def log_pass_plans(h, nb=3):
    """Each level's pass plan at ns = MS (smoothing; the residual form's
    last pass in brackets)."""
    from ndsm_tpu_torch.ops import zc

    for shape in h.shapes:
        plan, res = zc.pass_plan(shape, MS, nb), zc.pass_plan(shape, MS, nb, True)[-1]
        log(f"[pass] plan {'x'.join(map(str, shape))} x{nb} ns={MS}: " + "; ".join(
            f"w={p.width} tile {p.tile} halo {p.halo} window {p.window} ring {p.ring} smem "
            f"{p.smem_bytes} B grid {p.grid}" for p in plan)
            + f" [residual pass: halo {res.halo} tile {res.tile} ring {res.ring} smem "
              f"{res.smem_bytes} B grid {res.grid}]")


# lane_pass's template flags (S, C) as mangled in ptxas's entry names:
# the lane form, the shard form and the halves form
PASS_FORMS = {"Lb0ELb0": "lane form", "Lb1ELb0": "shard form", "Lb0ELb1": "halves form"}


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    from ndsm_tpu_torch.utils import cuda_build

    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"python {sys.version.split()[0]}; {torch.cuda.device_count()} device(s)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    cuda_build.kernels()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(one nvcc per source, in parallel; {' '.join(cuda_build.NVCC_FLAGS)})")
    # ptxas's resource lines for every kernel (registers, stack, spills)
    entry = None
    for line in (cuda_build.build_dir() / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and ("stack frame" in line or "Used" in line):
            what = line.split(':', 1)[-1].strip()
            log(f"[build] {entry[:60]}: {what}")
            if "lane_pass" in entry:  # the multi-sweep pass (32- and 64-bit indexing)
                bits = 64 if "lane_passIy" in entry else 32
                flags = entry.split("lane_passI", 1)[1][1:].split("EEEv", 1)[0]
                form = PASS_FORMS.get(flags, flags)
                log(f"[pass] ptxas, lane_pass {form} ({bits}-bit lane indices): {what}")
            entry = entry if "stack frame" in line else None
    return name, smi


def phase_kernels(stats: Stats):
    """Parity and timing of every kernel wrapper at its path's shapes."""
    import numpy as np
    import torch

    from ndsm_tpu_torch.grids import GridHierarchy
    from ndsm_tpu_torch.ops import df, fused, v2d, zc
    from ndsm_tpu_torch.utils.testing import build_test_mesh

    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)

    def f32(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    def defect_forms(u64, rhs64, e32, dq, bcs, where):
        """The defect's four forms against its plain version, bitwise."""
        for form, r_, e_ in (("zero-rhs", None, None), ("rhs", rhs64, None),
                             ("zero-rhs+update", None, e32), ("rhs+update", rhs64, e32)):
            got = df.df_residual_3d(u64, r_, e_, dq, bcs)
            want = df.df_residual_3d_plain(u64, r_, e_, dq, bcs)
            for part, g, w in zip(("r32", "max", "u"), got, want):
                stats.note("df_residual_3d", *compare(
                    f"df_residual_3d {form} ({part}) {where}", g, w))

    def one_lane(shape, dq, tag, bcs):
        """The three one-lane calls against their plain versions, bitwise."""
        u, rhs, cor = f32(shape), f32(shape), f32(shape)
        for ns in SWEEPS:
            lab = f"{'x'.join(map(str, shape))} {tag} ns={ns}"
            stats.note("zc_smooth_3d", *compare(
                f"zc_smooth_3d {lab}", zc.zc_smooth_3d(u, rhs, dq, bcs, ns),
                zc.zc_smooth_3d_plain(u, rhs, dq, bcs, ns)))
            got = zc.zc_smooth_residual_3d(u, rhs, dq, bcs, ns)
            want = zc.zc_smooth_residual_3d_plain(u, rhs, dq, bcs, ns)
            for part, g, w in zip(("u", "r"), got, want):
                stats.note("zc_smooth_residual_3d", *compare(
                    f"zc_smooth_residual_3d({part}) {lab}", g, w))
            stats.note("zc_smooth_cor_3d", *compare(
                f"zc_smooth_cor_3d {lab}", zc.zc_smooth_cor_3d(u, cor, rhs, dq, bcs, ns),
                zc.zc_smooth_cor_3d_plain(u, cor, rhs, dq, bcs, ns)))

    # -- the 3D smoothers and the defect (main path, component solves)
    h = GridHierarchy.from_mesh(build_test_mesh(220)[::-1])
    log_pass_plans(h)
    for level in (0, 1):
        shape, dq = h.shapes[level], h.dq[level]
        n = shape[0]
        pts = int(np.prod(shape))
        for tag, bcs in BC_SETS.items():
            u, rhs, cor = f32(shape), f32(shape), f32(shape)
            for ns in SWEEPS:
                stats.note("zc_smooth_3d", *compare(
                    f"zc_smooth_3d {n}^3 {tag} ns={ns}",
                    zc.zc_smooth_3d(u, rhs, dq, bcs, ns),
                    zc.zc_smooth_3d_plain(u, rhs, dq, bcs, ns)))
                got_u, got_r = zc.zc_smooth_residual_3d(u, rhs, dq, bcs, ns)
                want_u, want_r = zc.zc_smooth_residual_3d_plain(u, rhs, dq, bcs, ns)
                stats.note("zc_smooth_residual_3d", *compare(
                    f"zc_smooth_residual_3d(u) {n}^3 {tag} ns={ns}", got_u, want_u))
                stats.note("zc_smooth_residual_3d", *compare(
                    f"zc_smooth_residual_3d(r) {n}^3 {tag} ns={ns}", got_r, want_r))
                stats.note("zc_smooth_cor_3d", *compare(
                    f"zc_smooth_cor_3d {n}^3 {tag} ns={ns}",
                    zc.zc_smooth_cor_3d(u, cor, rhs, dq, bcs, ns),
                    zc.zc_smooth_cor_3d_plain(u, cor, rhs, dq, bcs, ns)))
            # The defect in the regime it runs in: a smooth iterate of O(1)
            # with a small random part, so r is a cancellation of w-sized terms.
            zz, yy, xx = np.meshgrid(*h.meshes[level], indexing="ij")
            u64 = torch.as_tensor(
                np.sin(2.1 * zz + 0.3) * np.cos(1.7 * yy) * np.sin(2.9 * xx + 1.1)
                + 1e-6 * rng.standard_normal(shape), dtype=torch.float64, device=dev)
            rhs64 = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float64, device=dev)
            e32 = 1e-4 * f32(shape)
            defect_forms(u64, rhs64, e32, dq, bcs, f"{n}^3 {tag}")
            log(f"[kernels] {n}^3 {tag}: 3D smoothers and defect bitwise equal to their "
                f"plain versions (ns in {SWEEPS}; defect zero-rhs/rhs/update)")
            head = n == 220 and tag == "Ax"
            lab = f"{n}^3 {tag} ns={MS}"
            stats.timed("zc_smooth_3d", lambda: zc.zc_smooth_3d(u, rhs, dq, bcs, MS),
                        lambda: zc.zc_smooth_3d_plain(u, rhs, dq, bcs, MS), pts, MS, lab, head,
                        busy=tag == "Ax")
            stats.timed("zc_smooth_residual_3d",
                        lambda: zc.zc_smooth_residual_3d(u, rhs, dq, bcs, MS),
                        lambda: zc.zc_smooth_residual_3d_plain(u, rhs, dq, bcs, MS),
                        pts, MS, lab, head)
            stats.timed("zc_smooth_cor_3d",
                        lambda: zc.zc_smooth_cor_3d(u, cor, rhs, dq, bcs, MS),
                        lambda: zc.zc_smooth_cor_3d_plain(u, cor, rhs, dq, bcs, MS),
                        pts, MS, lab, head)
            stats.timed("df_residual_3d", lambda: df.df_residual_3d(u64, None, e32, dq, bcs),
                        lambda: df.df_residual_3d_plain(u64, None, e32, dq, bcs),
                        pts, 1, f"{n}^3 {tag} zero-rhs+update", head)

    # -- the defect's four forms at odd extents (partial column tiles, a
    # last z chunk shorter than the others)
    for shape in DF_ODD:
        dq = h.dq[0]
        u64 = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float64, device=dev)
        rhs64 = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float64, device=dev)
        e32 = 1e-4 * f32(shape)
        for tag, bcs in BC_SETS.items():
            defect_forms(u64, rhs64, e32, dq, bcs, f"{shape} {tag}")
        log(f"[kernels] {shape}: defect bitwise equal to its plain version (three BC sets, "
            f"zero-rhs/rhs/update)")
        del u64, rhs64, e32

    # -- the one-lane calls at odd nz and on the small levels: path 1b's
    # 55^3, 27^3, 13^3 and 6^3 levels, the shape class the JAX package sends
    # to fused_smooth_3d (221 x 220 x 220), and the smallest extents (2, 3, 5)
    small = [(h.shapes[l], h.dq[l]) for l in range(2, h.ngrids)] + [((2, 3, 5), h.dq[0])]
    for shape, dq in small[:1] + [((221, 220, 220), h.dq[0])] + small[1:]:
        for tag, bcs in BC_SETS.items():
            one_lane(shape, dq, tag, bcs)
        log(f"[kernels] {shape}: one-lane calls (zc_smooth_3d = fused_smooth_3d, residual, "
            f"correction) bitwise equal to their plain versions (three BC sets, ns in {SWEEPS})")

    # -- path 6's hierarchy (solve_poisson_bvp at 257^3, Ax BCs, odd on
    # every axis): the one-lane calls on every level, the defect on the
    # finest in the regime it runs in there
    x6 = np.linspace(0.0, 1.0, OP_SIZES[1])
    h6 = GridHierarchy.from_mesh((x6, x6, x6))
    bcs = BC_SETS["Ax"]
    for shape, dq in zip(h6.shapes, h6.dq):
        one_lane(shape, dq, "Ax", bcs)
    shape, dq = h6.shapes[0], h6.dq[0]
    zb, yb, xb = (m.reshape([-1 if a == ax else 1 for a in range(3)])
                  for ax, m in enumerate(h6.meshes[0]))
    u64 = torch.as_tensor(
        np.sin(2.1 * zb + 0.3) * np.cos(1.7 * yb) * np.sin(2.9 * xb + 1.1)
        + 1e-6 * rng.standard_normal(shape), dtype=torch.float64, device=dev)
    rhs64 = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float64, device=dev)
    defect_forms(u64, rhs64, 1e-4 * f32(shape), dq, bcs, f"{shape[0]}^3 Ax (path 6)")
    log(f"[kernels] path 6's levels {', '.join(f'{s[0]}^3' for s in h6.shapes)} (Ax, dq of "
        f"the {OP_SIZES[1]}^3 hierarchy): one-lane calls bitwise equal to their plain versions (ns in "
        f"{SWEEPS}); the defect's four forms at {shape[0]}^3 bitwise too")
    del u64, rhs64

    # -- the lane kernels: the three component lanes of the batched solve,
    # timed at 220^3 and 110^3, checked at every level of path 1
    lanes = tuple(BC_SETS.values())
    frozen = (True, True, False)  # Az stops first on the main path
    for level in list(range(h.ngrids)) + [None]:
        shape, dq = (h.shapes[level], h.dq[level]) if level is not None else ((2, 3, 5), h.dq[0])
        n = "x".join(map(str, shape)) if len(set(shape)) > 1 else f"{shape[0]}^3"
        pts = 3 * int(np.prod(shape))
        u, rhs, cor = f32((3,) + shape), f32((3,) + shape), f32((3,) + shape)
        for ns in SWEEPS:
            lab = f"{n} x3 ns={ns}"
            full = {
                "fused_smooth_3d_batched":
                    (fused.fused_smooth_3d_batched(u, rhs, dq, lanes, ns),
                     fused.fused_smooth_3d_batched_plain(u, rhs, dq, lanes, ns),
                     [zc.zc_smooth_3d(u[b], rhs[b], dq, bc, ns) for b, bc in enumerate(lanes)]),
                "fused_smooth_residual_3d_batched":
                    (fused.fused_smooth_residual_3d_batched(u, rhs, dq, lanes, ns),
                     fused.fused_smooth_residual_3d_batched_plain(u, rhs, dq, lanes, ns),
                     [zc.zc_smooth_residual_3d(u[b], rhs[b], dq, bc, ns)
                      for b, bc in enumerate(lanes)]),
                "fused_smooth_cor_3d_batched":
                    (fused.fused_smooth_cor_3d_batched(u, cor, rhs, dq, lanes, ns),
                     fused.fused_smooth_cor_3d_batched_plain(u, cor, rhs, dq, lanes, ns),
                     [zc.zc_smooth_cor_3d(u[b], cor[b], rhs[b], dq, bc, ns)
                      for b, bc in enumerate(lanes)]),
            }
            part = {
                "fused_smooth_3d_batched":
                    fused.fused_smooth_3d_batched(u, rhs, dq, lanes, ns, frozen),
                "fused_smooth_residual_3d_batched":
                    fused.fused_smooth_residual_3d_batched(u, rhs, dq, lanes, ns, frozen),
                "fused_smooth_cor_3d_batched":
                    fused.fused_smooth_cor_3d_batched(u, cor, rhs, dq, lanes, ns, frozen),
            }
            for key, (got, want, per_lane) in full.items():
                got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
                for part_name, g, w in zip(("u", "r"), got, want):
                    stats.note(key, *compare(f"{key}({part_name}) {lab}", g, w))
                for b in range(3):
                    zb = per_lane[b] if isinstance(per_lane[b], tuple) else (per_lane[b],)
                    for part_name, g, w in zip(("u", "r"), got, zb):
                        stats.note(key, *compare(
                            f"{key}({part_name}) {lab} lane {b} vs the zc kernel", g[b], w))
                pg = part[key] if isinstance(part[key], tuple) else (part[key],)
                for b, on in enumerate(frozen):
                    for part_name, g, w in zip(("u", "r"), pg, got):
                        if on:
                            want_b = w[b]
                        else:  # a frozen lane: u unchanged, zero residual
                            want_b = u[b] if part_name == "u" else torch.zeros_like(u[b])
                        stats.note(key, *compare(
                            f"{key}({part_name}) {lab} Az frozen, lane {b}", g[b], want_b))
            del full, part
        log(f"[kernels] {n} x3 lanes: lane forms bitwise equal to their plain versions "
            f"and to per-lane zc kernels, all lanes active and Az frozen (ns in {SWEEPS})")
        if level not in (0, 1):
            del u, rhs, cor
            continue
        head = level == 0
        lab = f"{n} x3 ns={MS}"
        stats.timed("fused_smooth_3d_batched",
                    lambda: fused.fused_smooth_3d_batched(u, rhs, dq, lanes, MS),
                    lambda: fused.fused_smooth_3d_batched_plain(u, rhs, dq, lanes, MS),
                    pts, MS, lab, head)
        stats.timed("fused_smooth_residual_3d_batched",
                    lambda: fused.fused_smooth_residual_3d_batched(u, rhs, dq, lanes, MS),
                    lambda: fused.fused_smooth_residual_3d_batched_plain(u, rhs, dq, lanes, MS),
                    pts, MS, lab, head)
        stats.timed("fused_smooth_cor_3d_batched",
                    lambda: fused.fused_smooth_cor_3d_batched(u, cor, rhs, dq, lanes, MS),
                    lambda: fused.fused_smooth_cor_3d_batched_plain(u, cor, rhs, dq, lanes, MS),
                    pts, MS, lab, head)
        # the lane call beside the three per-lane calls it replaces
        lms, zms = time_pair(
            lambda: fused.fused_smooth_residual_3d_batched(u, rhs, dq, lanes, MS),
            lambda: [zc.zc_smooth_residual_3d(u[b], rhs[b], dq, bc, MS)
                     for b, bc in enumerate(lanes)])
        fms = time_ms(lambda: fused.fused_smooth_residual_3d_batched(u, rhs, dq, lanes, MS,
                                                                     frozen))
        log(f"[time] lane residual form {lab}: one lane call {lms:.4f} ms, three per-lane "
            f"zc calls {zms:.4f} ms, Az frozen {fms:.4f} ms")
        del u, rhs, cor

    # -- v2d: every float32 level of the chi faces of 220^3 and 512^3, one
    # lane and six, (221, 220), the one-block/cluster boundaries and 700^2
    # (the global route), each shape's plan; timed on six 220^2 and six
    # 512^2 lanes
    for shape, dq in v2d_levels() + [((700, 700), (1.0 / 699, 1.0 / 699))]:
        log(f"[v2d plan] {shape[0]}x{shape[1]}: " + "; ".join(
            f"{lanes} lane(s): {_plan_text(v2d.v2d_plan(lanes, *shape))}" for lanes in (1, 6)))
        for tag, bcs in BC_2D.items():
            for lanes in (1, 6):
                full = shape if lanes == 1 else (lanes,) + shape
                u, rhs, cor = f32(full), f32(full), f32(full)
                lab = f"{'x'.join(map(str, full))} {tag}"
                for ns in SWEEPS:
                    stats.note("v2d_smooth", *compare(
                        f"v2d_smooth {lab} ns={ns}", v2d.v2d_smooth(u, rhs, dq, bcs, ns),
                        v2d.v2d_smooth_plain(u, rhs, dq, bcs, ns)))
                    got = v2d.v2d_smooth_residual(u, rhs, dq, bcs, ns)
                    want = v2d.v2d_smooth_residual_plain(u, rhs, dq, bcs, ns)
                    for part, g, w in zip(("u", "r"), got, want):
                        stats.note("v2d_smooth_residual", *compare(
                            f"v2d_smooth_residual({part}) {lab} ns={ns}", g, w))
                    stats.note("v2d_smooth_cor", *compare(
                        f"v2d_smooth_cor {lab} ns={ns}",
                        v2d.v2d_smooth_cor(u, cor, rhs, dq, bcs, ns),
                        v2d.v2d_smooth_cor_plain(u, cor, rhs, dq, bcs, ns)))
        log(f"[kernels] {shape[0]}x{shape[1]}, 1 and 6 lanes: v2d forms bitwise equal to "
            f"their plain versions (both BC sets, ns in {SWEEPS})")
        del u, rhs, cor
    for n in (220, 512):
        x = build_test_mesh(n)[0]
        dq = GridHierarchy.from_mesh((x, x)).dq[0]
        shape = (6, n, n)
        pts = 6 * n * n
        for tag, bcs in BC_2D.items():
            u, rhs, cor = f32(shape), f32(shape), f32(shape)
            head = n == 220 and tag == "all_neumann"
            lab = f"6x{n}^2 {tag} ns={MS}"
            stats.timed("v2d_smooth", lambda: v2d.v2d_smooth(u, rhs, dq, bcs, MS),
                        lambda: v2d.v2d_smooth_plain(u, rhs, dq, bcs, MS), pts, MS, lab, head)
            stats.timed("v2d_smooth_residual",
                        lambda: v2d.v2d_smooth_residual(u, rhs, dq, bcs, MS),
                        lambda: v2d.v2d_smooth_residual_plain(u, rhs, dq, bcs, MS),
                        pts, MS, lab, head)
            stats.timed("v2d_smooth_cor", lambda: v2d.v2d_smooth_cor(u, cor, rhs, dq, bcs, MS),
                        lambda: v2d.v2d_smooth_cor_plain(u, cor, rhs, dq, bcs, MS),
                        pts, MS, lab, head)

    # -- the v2d lane kernel beside the previous design (one block a lane in
    # global memory, the global route), six lanes of the chi faces' 110^2,
    # 220^2 and 512^2, all-Neumann, in turns
    glob = v2d.V2dPlan("global", 1, 0, 0, 0, (1, 6))
    for n in (110, 220, 512):
        x = build_test_mesh(2 * n if n == 110 else n)[0]
        h2 = GridHierarchy.from_mesh((x, x))
        dq = h2.dq[h2.shapes.index((n, n))]
        bcs = BC_2D["all_neumann"]
        u, rhs, cor = f32((6, n, n)), f32((6, n, n)), f32((6, n, n))
        lab = f"6x{n}^2 all_neumann ns={MS} ({_plan_text(v2d.v2d_plan(6, n, n))})"
        for key, args, res in (("v2d_smooth", (u, None, rhs), False),
                               ("v2d_smooth_residual", (u, None, rhs), True),
                               ("v2d_smooth_cor", (u, cor, rhs), False)):
            plain = getattr(v2d, key + "_plain")
            pargs = args if args[1] is not None else (u, rhs)
            # the global route is a route of its own (lanes past a 16-block
            # cluster): held to the plain version too
            got = v2d._v2d_cuda(*args, dq, bcs, MS, res, key, glob)
            want = plain(*pargs, dq, bcs, MS)
            for part, g, w in zip(("u", "r"), got[:2] if res else got[:1],
                                  want if res else (want,)):
                stats.note(key, *compare(f"{key}({part}) 6x{n}^2 global route", g, w))
            compare_kernel_designs(
                key, lab, 6 * n * n, lambda: plain(*pargs, dq, bcs, MS),
                lambda: v2d._v2d_cuda(*args, dq, bcs, MS, res, key, glob),
                lambda: v2d._v2d_cuda(*args, dq, bcs, MS, res, key), "v2d_lane")
        del u, rhs, cor
    # -- the plan's cluster size (the fewest blocks that fit) against larger
    # ones: six all-Neumann lanes, smoothing form, device busy, each bitwise
    for n in (220, 512):
        x = build_test_mesh(n)[0]
        dq = GridHierarchy.from_mesh((x, x)).dq[0]
        bcs = BC_2D["all_neumann"]
        u, rhs = f32((6, n, n)), f32((6, n, n))
        want = v2d.v2d_smooth_plain(u, rhs, dq, bcs, MS)
        fewest = v2d.v2d_plan(6, n, n).cluster
        cells = []
        for c in sorted({fewest, fewest + 1, fewest + 2, min(16, 2 * fewest), 16}):
            p = v2d.v2d_plan(6, n, n, cluster=c)
            run = lambda p=p: v2d._v2d_cuda(u, None, rhs, dq, bcs, MS, False, "v2d_smooth",  # noqa: E731
                                            p)[0]
            compare(f"v2d_smooth 6x{n}^2 C={c}", run(), want)
            cells.append(f"C={c}{' (plan)' if c == fewest else ''} {device_ms(run)[0]:.4f} ms")
        log(f"[v2d C] 6x{n}^2 all_neumann ns={MS} smoothing, device busy: " + "; ".join(cells))
        del u, rhs, want

    phase_mean_kernels(stats, f32)

    log("[kernels] max difference from the plain version, in ulps of max|plain|: "
        + ", ".join(f"{k} {v['ulp']:.1f}" for k, v in stats.s.items()))
    # Device-to-device copy bandwidth: the card's practical memory roof.
    big = torch.empty(2**27, dtype=torch.float32, device=dev)
    dst = torch.empty_like(big)
    cms = time_ms(lambda: dst.copy_(big))
    log(f"[time] device-to-device copy of 512 MiB: {cms:.4f} ms = "
        f"{2 * big.numel() * 4 / cms / 1e6:.1f} GB/s (read + write)")
    del big, dst


# Odd all-Neumann shapes beside path 2's levels: a grid of 36 blocks, and
# 65 x 64 x 63 (N not a multiple of 1024, more than 256 * 1024 points)
MEAN_ODD = ((33, 33, 33), (65, 64, 63))


def phase_mean_kernels(stats: Stats, f32):
    """B6, the all-Neumann smoother (one launch a call): each shape's plan
    ("[mean plan]": route, virtual blocks, the grid's blocks); bitwise
    against its plain version at every level of the 128^3 and 256^3
    hierarchies (path 2), at 220^3 and at MEAN_ODD, ns 1, 2 and 5, on the
    plan's route and, where that is the block route, on the grid route
    too; timed at 220^3, 128^3, 256^3 (the kernel row) and 16^3, with each
    call's host enqueue and device events (more than one a call fails)."""
    import numpy as np

    from ndsm_tpu_torch.grids import GridHierarchy
    from ndsm_tpu_torch.ops import zc
    from ndsm_tpu_torch.utils import cuda_build

    lib = cuda_build.kernels()
    shapes = {}
    for n in (128, 256):
        x = np.linspace(0.0, 1.0, n)
        h = GridHierarchy.from_mesh((x, x, x))
        for s_, dq in zip(h.shapes, h.dq):
            shapes.setdefault(tuple(s_), dq)
    for s_ in ((220, 220, 220),) + MEAN_ODD:
        shapes.setdefault(s_, tuple(1.0 / (e - 1) for e in s_))
    data = {}
    for shape, dq in sorted(shapes.items(), key=lambda kv: -math.prod(kv[0])):
        plan = zc.mean_plan(shape)
        resident = lib.ndsm_mean_resident_blocks(*shape)
        lab = "x".join(map(str, shape))
        log(f"[mean plan] {lab}: {plan.route} route, {plan.vblocks} virtual blocks, "
            + (f"a cooperative grid of {min(resident, plan.vblocks)} blocks ({resident} "
               "resident on the card)" if plan.route == "grid" else
               f"one block, {plan.smem_bytes} B of shared memory"))
        if resident <= 0:
            raise AssertionError(f"the card runs no cooperative grid of mean_grid ({resident})")
        u, rhs = f32(shape), f32(shape)
        routes = [plan] + ([zc.MeanPlan("grid", plan.vblocks, 0)] if plan.route == "block" else [])
        for ns in SWEEPS:
            want = zc.zc_smooth_mean_3d_plain(u, rhs, dq, ALL_N_3D, ns)
            for i, p in enumerate(routes):
                got = (zc.zc_smooth_mean_3d(u, rhs, dq, ALL_N_3D, ns) if i == 0 else
                       zc._mean_sweeps_cuda(u, rhs, dq, ALL_N_3D, ns, plan=p))
                stats.note("zc_smooth_mean_3d", *compare(
                    f"zc_smooth_mean_3d {lab} ns={ns} ({p.route} route)", got, want))
        log(f"[kernels] {lab} all-Neumann: zc_smooth_mean_3d bitwise equal to its plain version "
            f"on the {' and '.join(p.route for p in routes)} route (ns in {SWEEPS})")
        data[shape] = (u, rhs, dq)
    for n in (220, 128, 256, 16):
        u, rhs, dq = data[(n, n, n)]
        nev = stats.timed("zc_smooth_mean_3d",
                          lambda: zc.zc_smooth_mean_3d(u, rhs, dq, ALL_N_3D, MS),
                          lambda: zc.zc_smooth_mean_3d_plain(u, rhs, dq, ALL_N_3D, MS),
                          n**3, MS, f"{n}^3 ns={MS}", n == 256, busy=True)
        if nev > 1:
            raise AssertionError(f"zc_smooth_mean_3d {n}^3: {nev} device events a call, not 1")
    del data


def phase_compact_kernels(stats: Stats):
    """Parity and timing of the colour-split smoother, its split and its
    merge, at the levels of paths 3 and 3b and at an odd-nx shape."""
    import numpy as np
    import torch

    from ndsm_tpu_torch.grids import GridHierarchy
    from ndsm_tpu_torch.ops import compact, fused, zc
    from ndsm_tpu_torch.utils.testing import build_test_mesh

    dev = torch.device("cuda")
    rng = np.random.default_rng(2025)

    def f32(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    def halves(key, lab, got, want):
        for part, g, w in zip(("R", "B"), got, want):
            stats.note(key, *compare(f"{key}({part}) {lab}", g, w))

    h = GridHierarchy.from_mesh(build_test_mesh(220)[::-1])
    for shape in h.shapes:  # the passes of path 3 (3b: one lane; the same tiles)
        for nb in (3, 1):
            plan = compact.compact_plan(shape, MS, nb)
            log(f"[compact plan] {'x'.join(map(str, shape))} x{nb} ns={MS}: " + "; ".join(
                    f"w={p.width} {'resident' if p.resident else 'marching'} tile {p.tile} "
                    f"window {p.window} ring {p.ring} smem {p.smem_bytes} B grid {p.grid}"
                    for p in plan))
    shapes = [(h.shapes[l], h.dq[l]) for l in (0, 1, 2)] + [((221, 220, 221), h.dq[0])]
    for shape, dq in shapes:
        nx, pts = shape[-1], int(np.prod(shape))
        sname = "x".join(map(str, shape))
        for tag, bcs in BC_SETS.items():
            u, rhs, cor = f32(shape), f32(shape), f32(shape)
            R, B = compact.split_colors_3d(u)
            halves("split_colors_3d", f"{sname} {tag}", (R, B), compact.split_colors_3d_plain(u))
            halves("split_colors_3d", f"{sname} {tag} u+cor", compact.split_colors_3d(u, cor),
                   compact.split_colors_3d_plain(u, cor))
            back = compact.merge_colors_3d(R, B, nx)
            stats.note("merge_colors_3d", *compare(
                f"merge_colors_3d {sname} {tag}", back, compact.merge_colors_3d_plain(R, B, nx)))
            stats.note("merge_colors_3d", *compare(f"split + merge round trip {sname}", back, u))
            rR, rB = compact.split_colors_3d(rhs)
            for ns in SWEEPS:
                lab = f"{sname} {tag} ns={ns}"
                got = compact.compact_smooth_3d(R, B, rR, rB, dq, bcs, ns, nx)
                want = compact.compact_smooth_3d_plain(R, B, rR, rB, dq, bcs, ns, nx)
                halves("compact_smooth_3d", lab, got, want)
                # merged, the compact sweeps are the dense kernel's, bit for bit
                stats.note("compact_smooth_3d", *compare(
                    f"compact_smooth_3d merged vs zc_smooth_3d {lab}",
                    compact.merge_colors_3d(*got, nx), zc.zc_smooth_3d(u, rhs, dq, bcs, ns)))
                stats.note("compact_smooth_3d", *compare(
                    f"smooth_dense(u + cor) vs zc_smooth_cor_3d {lab}",
                    compact.smooth_dense(u, rhs, dq, bcs, ns, cor),
                    zc.zc_smooth_cor_3d(u, cor, rhs, dq, bcs, ns)))
                for part, g, w in zip(("u", "r"),
                                      compact.smooth_residual_dense(u, rhs, dq, bcs, ns),
                                      zc.zc_smooth_residual_3d(u, rhs, dq, bcs, ns)):
                    stats.note("compact_smooth_3d", *compare(
                        f"smooth_residual_dense({part}) vs zc_smooth_residual_3d {lab}", g, w))
            if shape[0] in (220, 110):
                lab = f"{sname} {tag} ns={MS}"
                stats.timed("compact_smooth_3d",
                            lambda: compact.compact_smooth_3d(R, B, rR, rB, dq, bcs, MS, nx),
                            lambda: compact.compact_smooth_3d_plain(R, B, rR, rB, dq, bcs, MS, nx),
                            pts, MS, lab, shape[0] == 220 and tag == "Ax", busy=tag == "Ax")
                cms, zms = time_pair(lambda: compact.smooth_dense(u, rhs, dq, bcs, MS),
                                     lambda: zc.zc_smooth_3d(u, rhs, dq, bcs, MS))
                log(f"[time] dense-interface call {lab}: split u, split rhs, "
                    f"{len(compact.compact_plan(shape, MS))} passes, merge {cms:.4f} ms; "
                    f"zc_smooth_3d {zms:.4f} ms")
        log(f"[kernels] {sname}: compact_smooth_3d halves bitwise equal to the plain version "
            f"(ghosts included) and, merged, to zc_smooth_3d / _residual / _cor; split and "
            f"merge bitwise and an exact round trip (three BC sets, ns in {SWEEPS})")
        del u, rhs, cor, R, B, rR, rB, back, got

    # -- the lane form on the three component lanes of the batched solve
    lanes = tuple(BC_SETS.values())
    frozen = (True, True, False)  # Az stops first on the main path
    for level in (0, 1):
        shape, dq = h.shapes[level], h.dq[level]
        n, nx = shape[0], shape[-1]
        pts = 3 * int(np.prod(shape))
        u, rhs, cor = f32((3,) + shape), f32((3,) + shape), f32((3,) + shape)
        R, B = compact.split_colors_3d(u)
        halves("split_colors_3d", f"{n}^3 x3", (R, B), compact.split_colors_3d_plain(u))
        halves("split_colors_3d", f"{n}^3 x3 u+cor, Az frozen",
               compact.split_colors_3d(u, cor, frozen),
               compact.split_colors_3d_plain(u, cor, frozen))
        stats.note("merge_colors_3d", *compare(
            f"split + merge round trip {n}^3 x3", compact.merge_colors_3d(R, B, nx), u))
        rR, rB = compact.split_colors_3d(rhs)
        for ns in SWEEPS:
            lab = f"{n}^3 x3 ns={ns}"
            key = "compact_smooth_3d_batched"
            got = compact.compact_smooth_3d_batched(R, B, rR, rB, dq, lanes, ns, nx)
            halves(key, lab, got,
                   compact.compact_smooth_3d_batched_plain(R, B, rR, rB, dq, lanes, ns, nx))
            part = compact.compact_smooth_3d_batched(R, B, rR, rB, dq, lanes, ns, nx, frozen)
            for b, bc in enumerate(lanes):
                one = compact.compact_smooth_3d(R[b], B[b], rR[b], rB[b], dq, bc, ns, nx)
                halves(key, f"{lab} lane {b} vs the one-lane call", (got[0][b], got[1][b]), one)
                want = one if frozen[b] else (R[b], B[b])  # a frozen lane: unchanged
                halves(key, f"{lab} Az frozen, lane {b}", (part[0][b], part[1][b]), want)
            stats.note(key, *compare(
                f"smooth_dense lanes vs fused_smooth_cor_3d_batched {lab} Az frozen",
                compact.smooth_dense(u, rhs, dq, lanes, ns, cor, frozen),
                fused.fused_smooth_cor_3d_batched(u, cor, rhs, dq, lanes, ns, frozen)))
            del got, part, one, want
        log(f"[kernels] {n}^3 x3 lanes: compact lane form bitwise equal to its plain version "
            f"and to one-lane calls, all lanes active and Az frozen (ns in {SWEEPS})")
        head = n == 220
        lab = f"{n}^3 x3 ns={MS}"
        stats.timed("compact_smooth_3d_batched",
                    lambda: compact.compact_smooth_3d_batched(R, B, rR, rB, dq, lanes, MS, nx),
                    lambda: compact.compact_smooth_3d_batched_plain(R, B, rR, rB, dq, lanes,
                                                                    MS, nx),
                    pts, MS, lab, head)
        stats.timed("split_colors_3d", lambda: compact.split_colors_3d(u),
                    lambda: compact.split_colors_3d_plain(u), pts, 1, f"{n}^3 x3", head)
        stats.timed("merge_colors_3d", lambda: compact.merge_colors_3d(R, B, nx),
                    lambda: compact.merge_colors_3d_plain(R, B, nx), pts, 1, f"{n}^3 x3", head)
        cms, fms = time_pair(lambda: compact.smooth_dense(u, rhs, dq, lanes, MS),
                             lambda: fused.fused_smooth_3d_batched(u, rhs, dq, lanes, MS))
        zms = time_ms(lambda: compact.smooth_dense(u, rhs, dq, lanes, MS, None, frozen))
        log(f"[time] dense-interface lane call {lab}: split u, split rhs, "
            f"{len(compact.compact_plan(shape, MS, 3))} passes, merge {cms:.4f} ms (Az frozen "
            f"{zms:.4f} ms); fused_smooth_3d_batched {fms:.4f} ms")
        del u, rhs, cor, R, B, rR, rB


def phase_pass_widths():
    """The measurements behind ``zc.pass_plan``'s rule: at every level of
    the 220^3 hierarchy, three component lanes, ns = MS, smoothing form,
    the device busy time of the plan as fixed and of marching passes of
    width 1, 2 and 3 (and the resident pass where a lane fits whole); every
    result bitwise against the plain lane form."""
    import numpy as np
    import torch

    from ndsm_tpu_torch.ops import fused, zc

    h = hierarchy_of(220)
    lanes = tuple(BC_SETS.values())
    rng = np.random.default_rng(2027)
    act = (True,) * 3
    for level, shape in enumerate(h.shapes):
        dq = h.dq[level]
        u, rhs = (torch.as_tensor(rng.standard_normal((3,) + shape), dtype=torch.float32,
                                  device="cuda") for _ in range(2))
        want = fused.fused_smooth_3d_batched_plain(u, rhs, dq, lanes, MS)
        plans = {"plan": zc.pass_plan(shape, MS, 3)}
        for w in (1, 2, 3):  # marching, whatever the lane's size
            widths = [w] * (MS // w) + ([MS % w] if MS % w else [])
            plan = tuple(zc.pass_tile(shape, x, False, 3) for x in widths)
            if plan[0].resident:  # a whole-lane tile would run resident: halve it in z
                plan = tuple(zc.pass_tile(shape, x, False, 3, (max(1, shape[0] // 2),) + shape[1:])
                             for x in widths)
            plans[f"w={w}"] = plan
        whole = zc.pass_tile(shape, MS, False, 3, shape)
        if whole.resident and not plans["plan"][0].resident:  # the size rule's other side
            plans["resident"] = (whole,)
        cells = []
        for tag, plan in plans.items():
            if any(p.smem_bytes > zc.MAX_SMEM for p in plan):
                continue
            run = lambda plan=plan: zc.run_passes(u, None, rhs, dq, lanes, act, tag, plan)[0]  # noqa: E731
            compare(f"pass {tag} {shape}", run(), want)
            kb, kev = device_ms(run)
            kind = "resident" if plan[0].resident else "marching"
            cells.append(f"{tag} ({kind}, {len(plan)} launches) {kb:.4f} ms in {kev:.1f} events")
        log(f"[width] {'x'.join(map(str, shape))} x3 ns={MS} smoothing, device busy: "
            + "; ".join(cells))
        del u, rhs, want


def check_counts(what: str, launches: dict, plain: dict, need, never=()) -> None:
    log(f"[{what}] launches {launches}; plain versions on the card {plain}")
    missing = [k for k in need if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{what}: kernels never launched: {missing}")
    if any(plain.values()):
        raise AssertionError(f"{what}: plain versions ran on CUDA tensors: {plain}")
    extra = [k for k in never if launches[k] > 0]
    if extra:
        raise AssertionError(f"{what}: kernels of another route launched: {extra}")


PATH1 = ("fused_smooth_3d_batched", "fused_smooth_residual_3d_batched",
         "fused_smooth_cor_3d_batched", "df_residual_3d",
         "v2d_smooth", "v2d_smooth_residual", "v2d_smooth_cor")
PATH1B = ("zc_smooth_3d", "zc_smooth_residual_3d", "zc_smooth_cor_3d", "df_residual_3d",
          "fused_smooth_3d", "v2d_smooth", "v2d_smooth_residual", "v2d_smooth_cor")
PATH2 = ("zc_smooth_mean_3d",)
_COMMON = ("df_residual_3d", "v2d_smooth", "v2d_smooth_residual", "v2d_smooth_cor")
PATH3 = ("compact_smooth_3d_batched", "split_colors_3d", "merge_colors_3d") + _COMMON
PATH3B = ("compact_smooth_3d", "split_colors_3d", "merge_colors_3d") + _COMMON
# The dense 3D smoothers: never launched where every level smooths colour-split.
DENSE_3D = ("zc_smooth_3d", "zc_smooth_residual_3d", "zc_smooth_cor_3d",
            "fused_smooth_3d_batched", "fused_smooth_residual_3d_batched",
            "fused_smooth_cor_3d_batched")


def check_v2d_routes(what, launches, routes, info):
    """The chi faces' v2d calls of a warm call: one launch a call, each
    form once a float32 level (5 at 220^2) and V-cycle of the lane-batched
    solve, on the one-block and cluster routes, never the global one."""
    cycles = max(s.cycles for s in info.chi)
    forms = {k: launches[k] for k in ("v2d_smooth", "v2d_smooth_residual", "v2d_smooth_cor")}
    log(f"[{what}] v2d launches {forms} (5 float32 levels x {cycles} V-cycles = "
        f"{5 * cycles}); by route {routes}")
    if any(v != 5 * cycles for v in forms.values()) or sum(routes.values()) != sum(
            forms.values()):
        raise AssertionError(f"{what}: v2d launches {forms} / routes {routes}, expected "
                             f"{5 * cycles} of each form, one launch a call")
    if routes["global"] or not routes["cluster"] or not routes["block"]:
        raise AssertionError(f"{what}: v2d routes {routes}: expected the one-block and the "
                             "cluster route only")


def log_passes(what, launches, passes, keys):
    """The 3D red-black kernel launches of a warm call: the wrapper calls
    and the pass launches behind them."""
    calls = sum(launches[k] for k in keys)
    log(f"[{what}] 3D red-black smoothing: {calls} wrapper calls, {passes} pass launches "
        f"({passes / max(calls, 1):.2f} a call)")
    if calls and not passes:
        raise AssertionError(f"{what}: the pass kernel never launched")


def log_compact_passes(what, launches, passes, dense_passes, key):
    """The colour-split smoother's launches of a warm call: the wrapper
    calls and the pass launches behind them (its own counter); the compact
    passes must be there, the dense pass's must not."""
    calls = launches[key]
    log(f"[{what}] colour-split smoothing: {calls} {key} calls, {passes} compact pass "
        f"launches ({passes / max(calls, 1):.2f} a call); dense pass launches {dense_passes}")
    if not passes or dense_passes:
        raise AssertionError(f"{what}: {passes} compact pass launches, {dense_passes} dense "
                             "pass launches")


_CASES = {}


def run(n, batch="auto", smoother="auto", dist=None, gate=True, **extra):
    """One ``vector_potential`` call on the analytic case at n^3 (mixed
    precision; ``extra`` holds further ``Options`` fields), held to the
    golden row unless ``gate`` is False; returns (wall s, info, A, B)."""
    import numpy as np

    from ndsm_tpu_torch import Options, vector_potential
    from ndsm_tpu_torch.utils.testing import build_test_mesh, potential_field_case

    if n not in _CASES:  # the analytic case, built once per size on the host
        x, y, z = build_test_mesh(n)
        Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
        _CASES[n] = (x, y, z) + potential_field_case(X, Y, Z)
        del Z, Y, X
    x, y, z, A1, b1 = _CASES[n]
    t0 = time.perf_counter()
    ierr, A2, B2, info = vector_potential(
        x, y, z, b1, device="cuda", full_output=True, dist=dist,
        options=Options(precision="mixed", batch_components=batch, smoother=smoother, **extra))
    wall = time.perf_counter() - t0
    if ierr != 0:
        raise AssertionError(f"vector_potential {n}^3: ierr={ierr}")
    if not (np.isfinite(A2).all() and np.isfinite(B2).all()):
        raise AssertionError(f"vector_potential {n}^3: non-finite output")
    if A2.shape != (3, n, n, n) or A2.dtype != np.dtype(extra.get("output_dtype", "float64")):
        raise AssertionError(f"vector_potential {n}^3: got {A2.shape} {A2.dtype}")
    ea = float(np.linalg.norm(A1 - A2, axis=0).max())
    eb = float(np.linalg.norm(b1 - B2, axis=0).max())
    g_ea, g_eb = GOLDEN[n]
    ok = abs(ea - g_ea) < GATE * g_ea and abs(eb - g_eb) < GATE * g_eb
    cyc = " ".join(f"{s.name}={s.cycles}" for s in info.chi + info.components)
    phases = " ".join(f"{k}={v:.4f}" for k, v in info.phases.items())
    route = (f"batch_components={batch}, smoother={smoother}, lanes "
             f"{info.components[0].batch_size}"
             + "".join(f", {k}={v}" for k, v in extra.items())
             + ("" if dist is None else f", dist over a {'x'.join(map(str, dist.mesh.shape))} "
                f"{dist.axis_names} mesh"))
    digits = f"{ea:.5e} {eb:.5e}" == f"{g_ea:.5e} {g_eb:.5e}"
    log(f"[main] {n}^3 mixed ({route}): Ea_max {ea:.5e} (golden {g_ea:.5e})  Eb_max "
        f"{eb:.5e} (golden {g_eb:.5e})  gate {'pass' if ok else 'FAIL'}, golden digits "
        f"exact: {digits}")
    log(f"[main] {n}^3 wall {wall:.4f} s; phases (s) {phases}; cycles {cyc}; component "
        "du " + " ".join(f"{s.name}={s.du_last:.6e}" for s in info.components))
    if gate and (not ok or (dist is not None and not digits)):
        raise AssertionError(f"vector_potential {n}^3 outside the golden gate"
                             + ("" if dist is None else " or its digits"))
    want = 3 if batch == "auto" and dist is None and not extra.get("per_face") else 1
    if any(s.batch_size != want for s in info.components):
        raise AssertionError(f"{n}^3 {route}: expected {want} lane(s) per component solve")
    return wall, info, A2, B2


def phase_main_path():
    import numpy as np
    import torch

    from ndsm_tpu_torch import ops
    from ndsm_tpu_torch.potential.vector_potential import CHI_RANGE, SOLVE3D_RANGE

    run(22)
    run(220)  # cold: first use of the 220^3 engines
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    wall, info, A_on, B_on = run(220)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_counts("main 220^3 warm", launches, ops.plain_cuda_counts(), PATH1)
    log_passes("path 1", launches, ops.pass_launches(), PATH1[:3])
    check_v2d_routes("path 1", launches, ops.v2d_route_launches(), info)
    log(f"[main] 220^3 warm: chi phase {info.phases['chi']:.4f} s; solve3d "
        f"{info.phases['solve3d']:.4f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # Path 1b: the components one after the other, held to path 1.
    run(220, "off")  # cold: first use of the sequential engines
    ops.reset_launch_counts()
    wall_b, info_b, A_off, B_off = run(220, "off")
    torch.cuda.synchronize()
    launches_b = ops.launch_counts()
    check_counts("main 220^3 warm, batch_components=off", launches_b, ops.plain_cuda_counts(),
                 PATH1B)
    log_passes("path 1b", launches_b, ops.pass_launches(), PATH1B[:3])
    da = float(np.abs(A_on - A_off).max())
    db = float(np.abs(B_on - B_off).max())
    del B_on, B_off
    log(f"[main] 220^3 batched vs one after the other: wall {wall:.4f} / {wall_b:.4f} s, "
        f"solve3d {info.phases['solve3d']:.4f} / {info_b.phases['solve3d']:.4f} s; "
        f"max|A_on - A_off| {da:.3e}, max|B_on - B_off| {db:.3e}")
    for s_on, s_off in zip(info.components, info_b.components):
        log(f"[main]   {s_on.name}: cycles {s_on.cycles} / {s_off.cycles}, du "
            f"{s_on.du_last:.6e} / {s_off.du_last:.6e}")
        if abs(s_on.cycles - s_off.cycles) > 1:
            raise AssertionError(f"{s_on.name}: cycles differ by more than 1 between routes")
    if not da <= 5e-9:
        raise AssertionError(f"max|A_on - A_off| = {da} > 5e-9")

    # Paths 3 and 3b: the colour-split smoother on every 3D level, components
    # batched and one after the other; each held to path 1.
    counted, walls = {}, {"1": wall, "1b": wall_b}
    for tag, batch, need in (("3", "auto", PATH3), ("3b", "off", PATH3B)):
        run(220, batch, "compact")  # cold: first use of the compact engines
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        wall_c, info_c, A_c, _ = run(220, batch, "compact")
        torch.cuda.synchronize()
        counted[tag] = ops.launch_counts()
        walls[tag] = wall_c
        check_counts(f"main 220^3 warm, smoother=compact, batch_components={batch}",
                     counted[tag], ops.plain_cuda_counts(), need, never=DENSE_3D)
        log_compact_passes(f"path {tag}", counted[tag], ops.compact_pass_launches(),
                           ops.pass_launches(), need[0])
        dc = float(np.abs(A_c - A_on).max())
        # the dense route with the same batching: predicted to be the same bits
        same = dc if batch == "auto" else float(np.abs(A_c - A_off).max())
        del A_c
        log(f"[main] 220^3 path {tag} (compact) vs path 1 (dense, batched): wall {wall_c:.4f} "
            f"/ {wall:.4f} s, solve3d {info_c.phases['solve3d']:.4f} / "
            f"{info.phases['solve3d']:.4f} s, chi {info_c.phases['chi']:.4f} s; peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
            f"max|A_compact - A_dense| {dc:.3e}; against the dense route with "
            f"batch_components={batch} {same:.3e} (exactly 0.0: {same == 0.0})")
        for s_c, s_d in zip(info_c.components, info.components):
            log(f"[main]   {s_c.name}: cycles {s_c.cycles} / {s_d.cycles}, du "
                f"{s_c.du_last:.6e} / {s_d.du_last:.6e}")
            if abs(s_c.cycles - s_d.cycles) > 1:
                raise AssertionError(f"{s_c.name}: cycles differ by more than 1 from path 1")
        if not dc <= 5e-9:
            raise AssertionError(f"path {tag}: max|A_compact - A_dense| = {dc} > 5e-9")
    del A_on

    # The four routes in turns (warm; host clock, so repeated): solve3d, wall.
    routes = {"1": ("auto", "auto"), "1b": ("off", "auto"), "3": ("auto", "compact"),
              "3b": ("off", "compact")}
    turns = {tag: [] for tag in routes}
    for tag in ("1", "3", "3b", "1b", "1b", "3b", "3", "1"):
        w, inf, _, _ = run(220, *routes[tag])
        turns[tag].append((inf.phases["solve3d"], w))
    for tag, tv in turns.items():
        log(f"[main] 220^3 path {tag} (batch_components={routes[tag][0]}, smoother="
            f"{routes[tag][1]}) in turns: solve3d " + " ".join(f"{t[0]:.4f}" for t in tv)
            + " s; wall " + " ".join(f"{t[1]:.4f}" for t in tv) + " s")

    # Where the time goes: one more warm 220^3 run of each route under
    # torch.profiler.  Device busy time = the summed durations of device-side
    # events (kernels and copies); CPU ops are left out, they would count
    # their kernels twice.  A phase is the events inside its named range.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for tag in ("1", "1b", "3"):
        batch, smoother = routes[tag]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pwall, pinfo, _, _ = run(220, batch, smoother)
        # (the ranges also appear as device-side annotations: not kernels)
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key not in (CHI_RANGE, SOLVE3D_RANGE)]
        if not dev:
            raise AssertionError("the profiler recorded no device events")
        busy = sum(e.self_device_time_total for e in dev) / 1e6
        launched = sum(e.count for e in dev)
        uwall = walls[tag]
        batch = f"{batch}, smoother={smoother}"
        log(f"[profile] 220^3 batch_components={batch}: device busy {busy:.4f} s, {launched} "
            f"device events; wall {pwall:.4f} s under the profiler (idle share "
            f"{1.0 - busy / pwall:.3f}), {uwall:.4f} s without it (idle share "
            f"{1.0 - busy / uwall:.3f}); top device time:")
        for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:12]:
            log(f"[profile]   {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<6d} "
                f"{e.key[:100]}")
        events = prof.events()
        for name, cyc in ((CHI_RANGE, pinfo.chi), (SOLVE3D_RANGE, pinfo.components)):
            rng = [e for e in events if e.name == name and e.device_type == DeviceType.CPU]
            if len(rng) != 1:
                raise AssertionError(f"expected one {name} range in the trace, got {len(rng)}")
            lo, hi = rng[0].time_range.start, rng[0].time_range.end
            in_rng = [e for e in events if e.device_type == DeviceType.CUDA
                      and e.name not in (CHI_RANGE, SOLVE3D_RANGE)
                      and lo <= e.time_range.start <= hi]
            r_busy = sum(e.time_range.elapsed_us() for e in in_rng) / 1e6
            r_wall = (hi - lo) / 1e6
            by_name = {}
            for e in in_rng:
                by_name[e.name] = by_name.get(e.name, 0) + 1
            top = ", ".join(f"{k[:40]} x{v}" for k, v in
                            sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
            log(f"[profile] {name} ({batch}): {len(in_rng)} device events, device busy "
                f"{r_busy:.4f} s of {r_wall:.4f} s (idle share {1.0 - r_busy / r_wall:.3f}); "
                "cycles " + " ".join(f"{s.name}={s.cycles}" for s in cyc)
                + f"; most launched: {top}")
    return launches, launches_b, counted["3"], counted["3b"], (A_off, info_b)


def profile_solve(label, solve, calls, name):
    """One more warm solve under torch.profiler: its device events, device
    busy time against the wall, and the launches of the kernels whose name
    holds ``name`` against the wrapper's ``calls`` of the counted run.  It
    records the device's activity alone: the host's events are not read,
    and processing them took 60-83 s for one 256^3 sharded operator solve
    on the H100 (22-29 s without them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_prof = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    events = sum(e.count for e in dev)
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    mine = {e.key: e.count for e in dev if name in e.key}
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:4]
    log(f"{label} profiled warm solve: {events} device events, busy {busy:.4f} s of "
        f"{wall:.4f} s (idle share {1 - busy / wall:.3f}); {sum(mine.values())} launches of "
        f"the '{name}' kernels for {calls} wrapper calls ({mine}); most device time: "
        + ", ".join(f"{e.key[:40]} {e.count}x {e.self_device_time_total / 1e3:.2f} ms"
                    for e in top)
        + f"; the profiled pass took {time.perf_counter() - t_prof:.1f} s")


def phase_neumann_3d():
    """Path 2: the 3D all-Neumann mixed solve on an analytic case."""
    import numpy as np
    import torch

    from ndsm_tpu_torch import GridHierarchy, Options, PoissonBVP, ops

    errs = {}
    launches = None
    for n in (128, 256):
        x = np.linspace(0.0, 1.0, n)
        c = np.cos(np.pi * x)
        ue = c[:, None, None] * c[None, :, None] * c[None, None, :]
        rhs = -3.0 * np.pi**2 * ue
        rhs -= rhs.mean()
        bvp = PoissonBVP(GridHierarchy.from_mesh((x, x, x)), ALL_N_3D,
                         Options(precision="mixed"), device="cuda")
        bvp.solve(np.zeros_like(rhs), rhs)  # cold: first use of the engines
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        u, info = bvp.solve(np.zeros_like(rhs), rhs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, plain = ops.launch_counts(), ops.plain_cuda_counts()
        if info.ierr != 0:
            raise AssertionError(f"all-Neumann {n}^3: ierr={info.ierr}")
        un = u.cpu().numpy()
        if un.shape != (n, n, n) or not np.isfinite(un).all():
            raise AssertionError(f"all-Neumann {n}^3: bad solution {un.shape}")
        errs[n] = float(np.abs((un - un.mean()) - (ue - ue.mean())).max())
        log(f"[neumann3d] {n}^3 mixed: cycles {info.cycles}, warm wall {wall:.4f} s, "
            f"max|u - exact| {errs[n]:.5e} (both mean-free)")
        check_counts(f"neumann3d {n}^3", counts, plain, PATH2)
        launches = counts
        profile_solve(f"[neumann3d] {n}^3 mixed", lambda: bvp.solve(np.zeros_like(rhs), rhs),
                      counts["zc_smooth_mean_3d"], "mean_")
    ratio = errs[128] / errs[256]
    log(f"[neumann3d] error ratio 128^3 / 256^3 = {ratio:.3f} (h^2 predicts "
        f"{(255 / 127) ** 2:.3f}; required 3.5-4.5)")
    if not 3.5 <= ratio <= 4.5:
        raise AssertionError(f"all-Neumann 3D solve does not converge as h^2: ratio {ratio}")
    return launches


# -- the sharded engine's per-shard kernels and paths 4 and 5

# (n, mesh shape): blocks of 110, 55 (odd offsets) and 64 planes on a z mesh;
# 110 x 110, 55 x 110 and 64 x 128 on a (z, y) mesh
SHARD_CONFIGS = ((220, (2,)), (220, (4,)), (256, (4,)), (220, (2, 2)), (220, (4, 2)),
                 (256, (4, 2)))
# Dirichlet z faces, and Neumann ones (the mirror planes); on a (z, y) mesh
# also Neumann y faces (Ay)
SHARD_BCS = {1: ("Ax", "Az"), 2: ("Ax", "Az", "Ay")}
PATH4 = ("zc_smooth_sharded_3d", "zc_smooth_residual_sharded_3d", "df_residual_sharded_3d",
         "df_update_residual_sharded_3d", "zc_smooth_3d", "zc_smooth_residual_3d",
         "zc_smooth_cor_3d", "v2d_smooth", "v2d_smooth_residual", "v2d_smooth_cor")
PATH5 = PATH4[:7]
ZY = tuple(k + "_zy" for k in PATH4[:4])  # B10y and B11y, the (z, y) mesh's forms
PATH4B = ZY + PATH4[4:]
PATH5B = ZY + PATH4[4:7]


def hierarchy_of(n: int):
    """The n^3 hierarchy: the main path's mesh at 220, linspace(0, 1) else."""
    import numpy as np

    from ndsm_tpu_torch.grids import GridHierarchy
    from ndsm_tpu_torch.utils.testing import build_test_mesh

    x = np.linspace(0.0, 1.0, n)
    return GridHierarchy.from_mesh(build_test_mesh(n)[::-1] if n == 220 else (x, x, x))


class Cut:
    """A level of n^3 cut over a z mesh or a (z, y) mesh on one device:
    blocks, their halo extension (z, then y on the z-extended blocks), the
    per-shard kernels' names and position arguments, and the join."""

    def __init__(self, n, grid, dev):
        from ndsm_tpu_torch.parallel.shard import make_mesh_nd

        self.n, self.grid = n, tuple(grid)
        self.zy = len(self.grid) == 2
        self.mesh = make_mesh_nd(self.grid, ("z", "y")[: len(self.grid)],
                                 devices=[dev] * math.prod(self.grid))
        self.devs = self.mesh.devices
        self.local = tuple(n // g for g in self.grid)
        corner, last = (0,) * len(self.grid), tuple(g - 1 for g in self.grid)
        inner = (self.grid[0] // 2,) + (0,) * (len(self.grid) - 1)
        self.picks = sorted({self.mesh.index(c) for c in (corner, inner, last)})
        shape = "x".join(map(str, self.local))
        self.where = (f"{n}^3 over {' x '.join(map(str, self.grid))} shards of {shape}"
                      + (" planes" if not self.zy else ""))

    def key(self, base):
        return base + ("_zy" if self.zy else "")

    def shard(self, v):
        from ndsm_tpu_torch.parallel import collectives as C

        return C.shard(v, self.devs, 0, self.grid)

    def join(self, blocks):
        from ndsm_tpu_torch.parallel import collectives as C

        return C.unshard(blocks, self.devs, 0, self.grid)

    def extend(self, blocks, H):
        from ndsm_tpu_torch.parallel import collectives as C

        for ax, nm in enumerate(self.mesh.axis_names):
            blocks = C.extend_block(blocks, self.devs, ax, H, self.mesh.lines(nm))
        return blocks

    def unextend(self, blocks, H):
        from ndsm_tpu_torch.parallel import collectives as C

        for ax in range(len(self.grid)):
            blocks = C.unextend_block(blocks, ax, H)
        return blocks

    def where_args(self, i, H=None):
        """The position arguments of block i: (z0, nz_global[, H]) on a z
        mesh, ((z0, y0), (n, n)[, (H, H)]) on a (z, y) mesh."""
        off = tuple(c * l for c, l in zip(self.mesh.coords(i), self.local))
        args = (off, (self.n,) * len(off)) if self.zy else (off[0], self.n)
        return args + (() if H is None else ((H, H) if self.zy else H,))


def phase_sharded_kernels(stats: Stats, configs=SHARD_CONFIGS, dev="cuda"):
    """B10/B11 (z mesh) and B10y/B11y ((z, y) mesh) on the blocks of a
    sharded level, halo-extended by the port's own collectives: each
    shard's kernel call against its plain version (a corner, an inner and
    the last shard), the stitched shards against the unsharded kernel of
    the whole level, and the engine's width passes with their exchanges
    against the unsharded ms-sweep kernels; all bitwise."""
    import numpy as np
    import torch

    from ndsm_tpu_torch import Options
    from ndsm_tpu_torch.ops import df, df_sharded, zc, zc_sharded
    from ndsm_tpu_torch.parallel.sm_engine import ShardedPoissonBVP

    rng = np.random.default_rng(2026)
    dev = torch.device(dev)

    def rand(shape, dtype=torch.float32):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)

    def parts(x):
        return x if isinstance(x, tuple) else (x,)

    for n, grid in configs:
        h = hierarchy_of(n)
        cut = Cut(n, grid, dev)
        shape, dq = h.shapes[0], h.dq[0]
        where = cut.where
        for ns, res in ((2, False), (1, True)):  # the engine's passes at level 0
            H = 2 * ns + res
            halos = (H, H if cut.zy else 0)
            ext = tuple(l + 2 * hh for l, hh in zip(cut.local, halos)) + shape[len(grid):]
            p = zc.shard_pass_plan(ext[:3], halos, ns, res)
            log(f"[shard plan] {where}, block {'x'.join(map(str, ext[:3]))} (+{H} halo), ns={ns}"
                f"{' + residual' if res else ''}: one pass, tile {p.tile}, window {p.window}, "
                f"ring {p.ring}, smem {p.smem_bytes} B, grid {p.grid}")
        for tag in SHARD_BCS[len(grid)]:
            bcs = BC_SETS[tag]
            u, rhs = rand(shape), rand(shape)
            ub, rb = cut.shard(u), cut.shard(rhs)
            for ns in SWEEPS:
                for res in (False, True):
                    base = "zc_smooth_residual_sharded_3d" if res else "zc_smooth_sharded_3d"
                    key = cut.key(base)
                    fn, plain = getattr(zc_sharded, key), getattr(zc_sharded, key + "_plain")
                    H = 2 * ns + res
                    ue, re = cut.extend(ub, H), cut.extend(rb, H)
                    outs = [fn(ue[i], re[i], dq, bcs, ns, *cut.where_args(i, H=H))
                            for i in range(len(ue))]
                    for i in range(len(ue)):  # every shard
                        want = plain(ue[i], re[i], dq, bcs, ns, *cut.where_args(i, H=H))
                        for part, g, w in zip("ur", parts(outs[i]), parts(want)):
                            stats.note(key, *compare(
                                f"{key}({part}) {where} {tag} ns={ns} shard {i}", g, w))
                    whole = (zc.zc_smooth_residual_3d if res else zc.zc_smooth_3d)(
                        u, rhs, dq, bcs, ns)
                    stitched = [cut.join(list(p)) for p in zip(*[parts(o) for o in outs])]
                    for part, g, w in zip("ur", stitched, parts(whole)):
                        stats.note(key, *compare(
                            f"stitched {key}({part}) {where} {tag} ns={ns} vs the unsharded "
                            "kernel", g, w))
                    del ue, re, outs, whole, stitched
            # the engine's passes (width 2, or 1 on blocks of < 6 points along
            # a partitioned axis) with their exchanges, MS sweeps, against the
            # unsharded kernels
            sb = ShardedPoissonBVP(h, bcs, Options(precision="mixed"), mesh=cut.mesh,
                                   axis_names=cut.mesh.axis_names)
            for level in sorted({0, sb.seam - 1}):
                lshape, ldq = h.shapes[level], h.dq[level]
                lu, lr = (u, rhs) if level == 0 else (rand(lshape), rand(lshape))
                lub, lrb = cut.shard(lu), cut.shard(lr)
                lab = (f"{lshape[0]}^3 over {' x '.join(map(str, grid))} shards of "
                       f"{'x'.join(str(e) for e in sb._local(level)[:len(grid)])} {tag} "
                       f"ms={MS}, passes of width {sb._pass_width(level, lu)}")
                stats.note(cut.key("zc_smooth_sharded_3d"), *compare(
                    f"engine smoothing {lab} vs zc_smooth_3d",
                    cut.join(sb._sh_smooth(lub, lrb, level, MS)),
                    zc.zc_smooth_3d(lu, lr, ldq, bcs, MS)))
                got = sb._sh_smooth_residual(lub, lrb, level, MS)
                want = zc.zc_smooth_residual_3d(lu, lr, ldq, bcs, MS)
                for part, g, w in zip("ur", got, want):
                    stats.note(cut.key("zc_smooth_residual_sharded_3d"), *compare(
                        f"engine smoothing + residual({part}) {lab} vs zc_smooth_residual_3d",
                        cut.join(g), w))
            # B11 in the regime it runs in: a smooth O(1) iterate, small noise
            zz, yy, xx = np.meshgrid(*h.meshes[0], indexing="ij")
            u64 = torch.as_tensor(
                np.sin(2.1 * zz + 0.3) * np.cos(1.7 * yy) * np.sin(2.9 * xx + 1.1)
                + 1e-6 * rng.standard_normal(shape), dtype=torch.float64, device=dev)
            del zz, yy, xx
            rhs64, e32 = rand(shape, torch.float64), 1e-4 * rand(shape)
            ue64, rb64, ee = cut.extend(cut.shard(u64), 1), cut.shard(rhs64), \
                cut.extend(cut.shard(e32), 1)
            for form, with_rhs, upd in (("zero-rhs", False, False), ("rhs", True, False),
                                        ("zero-rhs+update", False, True),
                                        ("rhs+update", True, True)):
                key = cut.key("df_update_residual_sharded_3d" if upd
                              else "df_residual_sharded_3d")
                outs = []
                for i in range(len(ue64)):
                    args = ((ue64[i], rb64[i] if with_rhs else None)
                            + ((ee[i],) if upd else ()) + (dq, bcs) + cut.where_args(i))
                    outs.append(getattr(df_sharded, key)(*args))
                    want = getattr(df_sharded, key + "_plain")(*args)
                    for part, g, w in zip(("r32", "max", "u"), outs[i], want):
                        stats.note(key, *compare(
                            f"{key} {form} ({part}) {where} {tag} shard {i}", g, w))
                whole = df.df_residual_3d(u64, rhs64 if with_rhs else None,
                                          e32 if upd else None, dq, bcs)
                got = (cut.join([o[0] for o in outs]), torch.stack([o[1] for o in outs]).max())
                if upd:
                    got += (cut.join(cut.unextend([o[2] for o in outs], 1)),)
                for part, g, w in zip(("r32", "max", "u"), got, whole):
                    stats.note(key, *compare(
                        f"stitched {key} {form} ({part}) {where} {tag} vs df_residual_3d", g, w))
            b10, b11 = ("B10y", "B11y") if cut.zy else ("B10", "B11")
            log(f"[sharded] {where} {tag}: {b10} (ns in {SWEEPS}, both forms; one launch a "
                f"call) and {b11} (four forms; r32 and the whole extended v) bitwise equal to "
                "their plain versions on every shard; stitched, and as the engine's passes, "
                "bitwise equal to the unsharded kernels")
            if n == 220 and grid in ((2,), (2, 2)) and tag == "Ax":
                _time_sharded(stats, cut, ub, rb, ue64, ee, dq, bcs)  # paths 4 / 4b level 0
            del u, rhs, ub, rb, u64, rhs64, e32, ue64, rb64, ee, outs, whole, got


def _time_sharded(stats, cut, ub, rb, ue64, ee, dq, bcs):
    """Times of the per-shard kernels on shard 0 of level 0 of path 4 (z
    mesh of 2) or path 4b ((z, y) mesh of 2 x 2), as the path calls them
    (2-sweep passes over a 4-point halo; the 1-sweep residual pass over 3;
    the zero-rhs defect with and without the update).  Work is counted
    from the extended block: its halo points are read and swept too."""
    from ndsm_tpu_torch.ops import df_sharded, zc_sharded

    real = ub[0].numel()
    lab = f"{cut.where}, shard 0"
    for base, ns in (("zc_smooth_sharded_3d", 2), ("zc_smooth_residual_sharded_3d", 1)):
        key = cut.key(base)
        res = base.startswith("zc_smooth_residual")
        H = 2 * ns + res
        ue, re = cut.extend(ub, H)[0], cut.extend(rb, H)[0]
        ext = ue.numel()
        fn, plain = getattr(zc_sharded, key), getattr(zc_sharded, key + "_plain")
        work = (4 * (2 * ext + (2 if res else 1) * real), 10 * ns * ext + (13 * real if res else 0),
                PEAK_F32)
        args = (dq, bcs, ns) + cut.where_args(0, H=H)
        nev = stats.timed(key, lambda: fn(ue, re, *args), lambda: plain(ue, re, *args), real, ns,
                          f"{lab} (+{H} halo) ns={ns}", True, work=work)
        if nev > 1:
            raise AssertionError(f"{key}: {nev} device events a call, not 1")
    ext = ue64[0].numel()
    pos = cut.where_args(0)
    for base, e, work in (
            ("df_residual_sharded_3d", None, (8 * ext + 4 * real, 14 * real, PEAK_F64)),
            ("df_update_residual_sharded_3d", ee[0],
             (20 * ext + 4 * real, 14 * real + ext, PEAK_F64))):
        key = cut.key(base)
        fn, plain = getattr(df_sharded, key), getattr(df_sharded, key + "_plain")
        args = (ue64[0], None) + (() if e is None else (e,)) + (dq, bcs) + pos
        stats.timed(key, lambda: fn(*args), lambda: plain(*args), real, 1,
                    f"{lab} (+1 halo) zero-rhs", True, work=work)


DIFFUSION = ("diffusion_sweep", "diffusion_residual")


def phase_diffusion_kernels(stats: Stats):
    """``DiffusionOperator``'s kernels (ops/diffusion.py, csrc/diffusion.cu)
    against their plain versions on the card, bitwise: float32 and float64,
    all-Neumann, all-Dirichlet and mixed faces, both colour flips, a
    stratified and a random positive coefficient, at 257^3, 129^3,
    65x64x63 and 2x3x5.  Then timed at 257^3 (all-Neumann, the stratified
    coefficient of ``diffusion3d.strat257``) beside their plain versions:
    the float32 sweep (what the V-cycles run) and the float64 residual (the
    outer defect) as the table's rows, the float64 sweep and the float32
    residual as further lines.  Bytes: u, rhs and a read once and the
    result written once (16 B/point in float32, 32 in float64); operations
    38 a point a sweep, 34 a residual."""
    import math

    import numpy as np
    import torch

    from ndsm_tpu_torch.ops import diffusion, stencils

    rng = np.random.default_rng(21)
    bcs_sets = ((("N", "N"),) * 3, (("D", "D"),) * 3, (("D", "N"), ("N", "D"), ("D", "N")))
    for shape in ((257, 257, 257), (129, 129, 129), (65, 64, 63), (2, 3, 5)):
        for dtype in (torch.float32, torch.float64):
            u, rhs = (torch.as_tensor(rng.standard_normal(shape), device="cuda").to(dtype)
                      for _ in range(2))
            z = torch.linspace(0.0, 1.0, shape[0], dtype=torch.float64, device="cuda")
            coefs = {"stratified": torch.exp(-math.log(20.0) * z).to(dtype).view(-1, 1, 1)
                     .expand(shape).contiguous(),
                     "random": (0.5 + torch.as_tensor(rng.random(shape), device="cuda"))
                     .to(dtype)}
            w, _ = stencils.stencil_weights([1.0 / (n - 1) for n in shape], dtype)
            for bcs in bcs_sets:
                for kind, a in coefs.items():
                    what = f"{'x'.join(map(str, shape))} {str(dtype)[6:]} {bcs} {kind}"
                    for flip in (0, 1):
                        stats.note("diffusion_sweep", *compare(
                            f"diffusion_sweep {what} flip {flip}",
                            diffusion.diffusion_sweep(u, rhs, a, w, bcs, flip),
                            diffusion.diffusion_sweep_plain(u, rhs, a, w, bcs, flip)))
                    stats.note("diffusion_residual", *compare(
                        f"diffusion_residual {what}", diffusion.diffusion_residual(
                            u, rhs, a, w, bcs), diffusion.diffusion_residual_plain(
                            u, rhs, a, w, bcs)))
            del u, rhs, coefs
    log("[diffusion] both kernels bitwise their plain versions at 257^3, 129^3, 65x64x63 and "
        "2x3x5, float32 and float64, three face sets, two coefficients, both flips")

    n = 257
    shape, nnn = (n, n, n), (("N", "N"),) * 3
    points = n ** 3
    for dtype, peak in ((torch.float32, PEAK_F32), (torch.float64, PEAK_F64)):
        u, rhs = (torch.as_tensor(rng.standard_normal(shape), device="cuda").to(dtype)
                  for _ in range(2))
        z = torch.linspace(0.0, 1.0, n, dtype=torch.float64, device="cuda")
        a = torch.exp(-math.log(20.0) * z).to(dtype).view(-1, 1, 1).expand(shape).contiguous()
        w, _ = stencils.stencil_weights([1.0 / (n - 1)] * 3, dtype)
        size = u.element_size()
        for key, kern, plain, ops_pt in (
                ("diffusion_sweep", lambda: diffusion.diffusion_sweep(u, rhs, a, w, nnn, 0),
                 lambda: diffusion.diffusion_sweep_plain(u, rhs, a, w, nnn, 0), 38),
                ("diffusion_residual", lambda: diffusion.diffusion_residual(u, rhs, a, w, nnn),
                 lambda: diffusion.diffusion_residual_plain(u, rhs, a, w, nnn), 34)):
            headline = (key == "diffusion_sweep") == (dtype == torch.float32)
            nev = stats.timed(key, kern, plain, points, 1,
                              f"{n}^3 {str(dtype)[6:]} NNN stratified", headline, busy=True,
                              work=(4 * size * points, ops_pt * points, peak))
            if nev != 1:
                raise AssertionError(f"{key}: {nev} device events a call, not 1")
        del u, rhs, a


def phase_dist_paths(ref):
    """Path 4 (vector_potential with dist over a z mesh of two shards) and
    path 4b (over a (z, y) mesh of 2 x 2 shards) on the card, each held to
    path 1b (the same solves on one device), and timed in turns."""
    import numpy as np
    import torch

    from ndsm_tpu_torch import ops
    from ndsm_tpu_torch.parallel import collectives as C
    from ndsm_tpu_torch.parallel import sm_engine
    from ndsm_tpu_torch.parallel.shard import DistConfig, make_mesh, make_mesh_nd

    A_1b, info_1b = ref
    dists = {"4": DistConfig(make_mesh(2, devices=["cuda:0"] * 2)),
             "4b": DistConfig(make_mesh_nd((2, 2), ("z", "y"), devices=["cuda:0"] * 4),
                              ("z", "y"))}
    # each path launches its mesh's per-shard kernels and not the other's
    routes = {"4": (PATH4, ZY), "4b": (PATH4B, PATH4[:4])}
    launches, A, ref = {}, {}, {}
    for tag, dist in dists.items():
        where = f"path {tag}: 220^3 warm, dist over a {'x'.join(map(str, dist.mesh.shape))} mesh"
        run(22, dist=dist)
        run(220, dist=dist)  # cold: first use of the sharded engines
        ops.reset_launch_counts()
        sm_engine.reset_plain_route_counts()
        C.reset_counts()
        wall, info, A[tag], B = run(220, dist=dist)
        torch.cuda.synchronize()
        ref[tag] = (A[tag], B, info, wall)
        del B
        launches[tag], msgs = ops.launch_counts(), C.counts()
        plain_routes = sm_engine.plain_route_counts()
        check_counts(where, launches[tag], ops.plain_cuda_counts(), *routes[tag])
        log(f"[dist] path {tag} warm call: {msgs['messages']} messages, {msgs['bytes']} bytes "
            f"between the shards; plain sharded routes on the card {plain_routes}")
        if plain_routes["half_sweep_3d"] or plain_routes["residual_3d"]:
            raise AssertionError(f"path {tag} ran a plain sharded 3D route on the card: "
                                 f"{plain_routes}")
        da = float(np.abs(A[tag] - A_1b).max())
        log(f"[dist] 220^3 path {tag} vs path 1b: max|A_dist - A_1b| {da:.3e}")
        for s_d, s_b in zip(info.chi + info.components, info_1b.chi + info_1b.components):
            log(f"[dist]   {s_d.name}: cycles {s_d.cycles} / {s_b.cycles}, du "
                f"{s_d.du_last:.6e} / {s_b.du_last:.6e}")
            if abs(s_d.cycles - s_b.cycles) > 1:
                raise AssertionError(f"path {tag} {s_d.name}: cycles differ by more than 1 "
                                     "from path 1b")
        if not da <= 5e-9:
            raise AssertionError(f"path {tag}: max|A_dist - A_1b| = {da} > 5e-9")
    log(f"[dist] 220^3 path 4b vs path 4: max|A_2d - A_path4| "
        f"{float(np.abs(A['4b'] - A['4']).max()):.3e}")
    del A, A_1b
    turns = {"1b": [], "4": [], "4b": []}
    for tag in ("1b", "4", "4b", "4b", "4", "1b"):
        w, inf, _, _ = run(220, "off", dist=dists.get(tag))
        turns[tag].append((w, inf.phases))
    for tag, tv in turns.items():
        log(f"[dist] 220^3 path {tag} in turns: wall " + " ".join(f"{w:.4f}" for w, _ in tv)
            + " s; phases (s) " + " | ".join(
                " ".join(f"{k}={v:.4f}" for k, v in ph.items()) for _, ph in tv))
    return launches["4"], launches["4b"], ref["4"], ref["4b"]


def phase_sharded_solves():
    """Path 5: ShardedPoissonBVP at 256^3 over a z mesh of four shards on
    the card (blocks of 64, 32, 16, 8 and 4 planes; the last level takes
    width-1 passes); path 5b: the same over a (z, y) mesh of 4 x 2 (blocks
    of 64 x 128 down to 4 x 8); each held to PoissonBVP on the same
    problem."""
    import numpy as np
    import torch

    from ndsm_tpu_torch import Options, PoissonBVP, ops
    from ndsm_tpu_torch.parallel import collectives as C
    from ndsm_tpu_torch.parallel import sm_engine
    from ndsm_tpu_torch.parallel.shard import make_mesh_nd

    n, bcs = 256, BC_SETS["Ax"]
    h = hierarchy_of(n)
    x = np.linspace(0.0, 1.0, n)
    ue = (np.sin(np.pi * x)[:, None, None] * np.sin(np.pi * x)[None, :, None]
          * np.cos(np.pi * x)[None, None, :])
    rhs = -3.0 * np.pi**2 * ue
    u0 = np.zeros_like(rhs)
    bvp = PoissonBVP(h, bcs, Options(precision="mixed"), device="cuda")
    bvp.solve(u0, rhs)  # cold
    t0 = time.perf_counter()
    u, info = bvp.solve(u0, rhs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err = float((u.cpu() - torch.as_tensor(ue)).abs().max())
    launches = {}
    for tag, grid, need in (("5", (4,), PATH5), ("5b", (4, 2), PATH5B)):
        names = ("z", "y")[: len(grid)]
        sb = sm_engine.ShardedPoissonBVP(
            h, bcs, Options(precision="mixed"), axis_names=names,
            mesh=make_mesh_nd(grid, names, devices=["cuda:0"] * math.prod(grid)))
        f32 = torch.zeros((), dtype=torch.float32)
        plan = ", ".join(
            f"{h.shapes[l][0]}^3 " + (f"sharded, blocks of "
                                      f"{'x'.join(map(str, sb._local(l)[:len(grid)]))} "
                                      f"(width {sb._pass_width(l, f32)})"
                                      if l < sb.seam else "replicated")
            for l in range(h.ngrids))
        log(f"[sharded] path {tag} level plan: {plan}")
        sb.solve(u0, rhs)  # cold
        ops.reset_launch_counts()
        sm_engine.reset_plain_route_counts()
        C.reset_counts()
        t0 = time.perf_counter()
        u_sh, info_sh = sb.solve(u0, rhs)
        torch.cuda.synchronize()
        wall_sh = time.perf_counter() - t0
        launches[tag], msgs = ops.launch_counts(), C.counts()
        routes = sm_engine.plain_route_counts()
        check_counts(f"path {tag}: 256^3 over a {'x'.join(map(str, grid))} mesh",
                     launches[tag], ops.plain_cuda_counts(), need)
        if routes["half_sweep_3d"] or routes["residual_3d"]:
            raise AssertionError(f"path {tag} ran a plain sharded 3D route on the card: "
                                 f"{routes}")
        d = float((u_sh - u).abs().max())
        log(f"[sharded] path {tag} 256^3 Ax mixed over {'x'.join(map(str, grid))}: sharded "
            f"{info_sh.cycles} cycles in {wall_sh:.4f} s ({msgs['messages']} messages, "
            f"{msgs['bytes']} bytes), PoissonBVP {info.cycles} cycles in {wall:.4f} s; "
            f"max|u_sh - u| {d:.3e}; max|u - exact| {err:.3e}")
        if info_sh.ierr or abs(info_sh.cycles - info.cycles) > 1 or not d <= 5e-9:
            raise AssertionError(f"path {tag}: ierr {info_sh.ierr}, cycles {info_sh.cycles} / "
                                 f"{info.cycles}, max|u_sh - u| {d}")
        if tag == "5":
            u5 = u_sh
            launches["5c"] = sharded_checkpointed(sb, u0, rhs)
        del u_sh, sb
    return launches["5"], launches["5b"], launches["5c"], u5


def sharded_checkpointed(sb, u0, rhs):
    """Path 5c: ``ShardedPoissonBVP.solve_checkpointed`` on path 5's engine,
    every 4 and every 32 cycles into a temporary directory: the two
    results bitwise equal, within 5e-9 of the strict sibling's ``solve``,
    a second call on the every-4 file running no cycle; B10 and B11
    launched (counted over the two checkpointed calls), no plain sharded
    3D route on the card.  Returns the launches."""
    import tempfile

    import torch

    from ndsm_tpu_torch import ops
    from ndsm_tpu_torch.parallel import sm_engine

    strict = sb._strict_sibling()
    strict.solve(u0, rhs)  # cold: the sibling's first solve
    t0 = time.perf_counter()
    u_s, info_s = strict.solve(u0, rhs)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        outs = {}
        ops.reset_launch_counts()
        sm_engine.reset_plain_route_counts()
        for every in (4, 32):
            t0 = time.perf_counter()
            outs[every] = sb.solve_checkpointed(u0, rhs, checkpoint_every=every,
                                                checkpoint_path=os.path.join(tmp, f"ck{every}.npz"))
            torch.cuda.synchronize()
            log(f"[sharded] path 5c solve_checkpointed every {every}: cycles "
                f"{outs[every][1].cycles}, ierr {outs[every][1].ierr}, du "
                f"{outs[every][1].du_last:.6e}, wall {time.perf_counter() - t0:.4f} s (file "
                "writes included)")
        launches, routes = ops.launch_counts(), sm_engine.plain_route_counts()
        check_counts("path 5c: solve_checkpointed 256^3 over a 4 mesh", launches,
                     ops.plain_cuda_counts(), PATH5)
        if routes["half_sweep_3d"] or routes["residual_3d"]:
            raise AssertionError(f"path 5c ran a plain sharded 3D route on the card: {routes}")
        (u4, i4), (u32, i32) = outs[4], outs[32]
        same = torch.equal(u4, u32)
        d_s = float((u4 - u_s).abs().max())
        log(f"[sharded] path 5c every 4 and 32 bitwise equal: {same}; against the strict "
            f"sibling's solve ({info_s.cycles} cycles, {wall_s:.4f} s warm): max|diff| "
            f"{d_s:.3e} (bitwise: {torch.equal(u4, u_s)})")
        if not (same and i4.ierr == i32.ierr == 0 and i4.cycles == i32.cycles and d_s <= 5e-9):
            raise AssertionError(f"path 5c: checkpointed results differ ({same}, {d_s})")
        u_r, i_r = sb.solve_checkpointed(u0, rhs, checkpoint_every=4,
                                         checkpoint_path=os.path.join(tmp, "ck4.npz"))
        log(f"[sharded] path 5c resumed from the 4-cycle file: cycles {i_r.cycles} (was "
            f"{i4.cycles}), u unchanged: {torch.equal(u_r, u4)}")
        if i_r.cycles != i4.cycles or not torch.equal(u_r, u4):
            raise AssertionError("path 5c: a resume from a converged file ran cycles")
    return launches


# -- paths 6, 7 and 7b: solve_poisson_bvp, its drivers and injected operators

PATH6 = ("zc_smooth_3d", "zc_smooth_residual_3d", "zc_smooth_cor_3d", "df_residual_3d")
OP_SIZES = (129, 257)  # 2^k + 1; 257^3 is 17.0 M points
OP_WALLS = {}  # (path, n) -> the warm wall of paths 7 and 7b (path 13 prints them)


def _warm_solve(what, solve):
    """One counted warm call of ``solve()``: (u, info, wall s, launches,
    plain versions on the card), the counters zeroed just before it."""
    import numpy as np
    import torch

    from ndsm_tpu_torch import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    u, info = solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = ops.launch_counts(), ops.plain_cuda_counts()
    if info.ierr != 0:
        raise AssertionError(f"{what}: ierr={info.ierr}")
    if not np.isfinite(u.cpu().numpy()).all():
        raise AssertionError(f"{what}: non-finite solution")
    return u, info, wall, launches, plain


def _order_check(what, errs, sizes=OP_SIZES):
    ratio = errs[sizes[0]] / errs[sizes[1]]
    log(f"{what} error ratio {sizes[0]}^3 / {sizes[1]}^3 = {ratio:.3f} (h^2 predicts "
        f"{((sizes[1] - 1) / (sizes[0] - 1)) ** 2:.3f}; required 3.5-4.5)")
    if not 3.5 <= ratio <= 4.5:
        raise AssertionError(f"{what}: error does not fall as h^2: ratio {ratio}")


def coef_xyz(a, b, c):
    """Path 7b's diffusion coefficient, 1 + x y z (one function object: it
    keys the engine caches)."""
    return 1.0 + a * b * c


def op_case(diffusion: bool, n: int):
    """The manufactured case of path 7 (``HelmholtzOperator(1.9)``,
    examples/helmholtz_operator.py) or 7b (``DiffusionOperator(coef_xyz)``,
    examples/diffusion_operator.py) at n^3 on a Dirichlet box: u* = sin(pi
    x) sin(pi y) sin(pi z).  Returns (x, u*, rhs, mixed Options)."""
    import numpy as np

    from ndsm_tpu_torch import Options

    x = np.linspace(0.0, 1.0, n)
    s, c = np.sin(np.pi * x), np.cos(np.pi * x)
    sz, sy, sx = s[:, None, None], s[None, :, None], s[None, None, :]
    ue = sz * sy * sx
    if not diffusion:
        return x, ue, -(3.0 * np.pi**2 + 1.9) * ue, Options(precision="mixed", vc_tol=1e-10)
    cz, cy, cx = c[:, None, None], c[None, :, None], c[None, None, :]
    Z, Y, X = x[:, None, None], x[None, :, None], x[None, None, :]
    rhs = (1.0 + Z * Y * X) * (-3.0 * np.pi**2) * ue + np.pi * (
        Y * X * cz * sy * sx + Z * X * sz * cy * sx + Z * Y * sz * sy * cx)
    return x, ue, rhs, Options(precision="mixed")


def phase_operator_paths():
    """Path 6: ``solve_poisson_bvp`` (no operator) on the card, mixed, Ax
    BCs, u* = sin(pi z) sin(pi y) cos(pi x) at 129^3 and 257^3, with
    ``solve(history=True)``, ``solve_checkpointed`` and the reduced drivers
    (33^3, fp32, against the port's own CPU run).  Paths 7 and 7b: the
    same entry with ``HelmholtzOperator(1.9)`` and ``DiffusionOperator(1 +
    x y z)`` on Dirichlet boxes (examples/helmholtz_operator.py and
    diffusion_operator.py): h^2 convergence and no kernel launched.
    Returns path 6's launches of its warm 257^3 call."""
    import contextlib
    import tempfile

    import numpy as np
    import torch

    from ndsm_tpu_torch import (DiffusionOperator, GridHierarchy, HelmholtzOperator,
                                Options, PoissonBVP, ops, solve_poisson_bvp)
    from ndsm_tpu_torch.mg import coarse
    from ndsm_tpu_torch.mg.poisson import get_poisson_bvp

    DDD = (("D", "D"),) * 3
    n_big = OP_SIZES[1]

    def grid(n):
        x = np.linspace(0.0, 1.0, n)
        s, c = np.sin(np.pi * x), np.cos(np.pi * x)
        return x, s, c

    # Path 6: the kernel route through the public entry.
    errs, launches6 = {}, None
    for n in OP_SIZES:
        x, s, c = grid(n)
        ue = s[:, None, None] * s[None, :, None] * c[None, None, :]
        rhs = -3.0 * np.pi**2 * ue
        u0 = np.zeros_like(rhs)
        opts = Options(precision="mixed")

        def solve():
            return solve_poisson_bvp(u0, rhs, (x, x, x), BC_SETS["Ax"], options=opts,
                                     device="cuda")

        solve()  # cold: first use of the engines
        u, info, wall, counts, plain = _warm_solve(f"path 6 {n}^3", solve)
        errs[n] = float((u.cpu() - torch.as_tensor(ue)).abs().max())
        log(f"[path 6] solve_poisson_bvp {n}^3 Ax mixed: cycles {info.cycles}, du "
            f"{info.du_last:.6e}, warm wall {wall:.4f} s, max|u - exact| {errs[n]:.5e}")
        if n != n_big:
            continue
        check_counts(f"path 6 {n}^3", counts, plain, PATH6)
        launches6 = counts
        log(f"[path 6] launches of a warm {n}^3 call: "
            + ", ".join(f"{k} {counts[k]}" for k in PATH6)
            + f"; pass launches {ops.pass_launches()}")
        profile_solve(f"[path 6] {n}^3", solve, sum(counts[k] for k in PATH6[:3]),
                      "lane_pass")
        bvp = get_poisson_bvp(GridHierarchy.from_mesh((x, x, x)), BC_SETS["Ax"], opts,
                              device="cuda")
        u_h, info_h = bvp.solve(u0, rhs, history=True)
        hist = info_h.du_history
        log(f"[path 6] history=True: {len(hist)} entries for {info_h.cycles} cycles, last "
            f"{hist[-1]:.6e} (du_last {info_h.du_last:.6e}); u bitwise solve's: "
            f"{torch.equal(u_h, u)}")
        if not (torch.equal(u_h, u) and len(hist) == info_h.cycles == info.cycles
                and hist[-1] == info_h.du_last):
            raise AssertionError("path 6: history=True changed the solve or its record")
        del u_h
        strict = PoissonBVP(bvp.h, BC_SETS["Ax"], Options(precision="mixed",
                                                          mixed_inner_max=1), device="cuda")
        u_s, info_s = strict.solve(u0, rhs)
        with tempfile.TemporaryDirectory() as tmp:
            outs = {}
            for every in (4, 32):
                path = os.path.join(tmp, f"ck{every}.npz")
                t0 = time.perf_counter()
                outs[every] = bvp.solve_checkpointed(u0, rhs, checkpoint_path=path,
                                                     checkpoint_every=every)
                log(f"[path 6] solve_checkpointed every {every}: cycles "
                    f"{outs[every][1].cycles}, ierr {outs[every][1].ierr}, wall "
                    f"{time.perf_counter() - t0:.4f} s (file writes included)")
            (u4, i4), (u32, i32) = outs[4], outs[32]
            same = torch.equal(u4, u32)
            d_s = float((u4 - u_s).abs().max())
            log(f"[path 6] checkpointed every 4 and 32 bitwise equal: {same}; against solve "
                f"with mixed_inner_max=1 ({info_s.cycles} cycles): max|diff| {d_s:.3e} "
                f"(bitwise: {torch.equal(u4, u_s)})")
            if not (same and i4.ierr == i32.ierr == 0 and i4.cycles == i32.cycles
                    and d_s <= 5e-9):
                raise AssertionError(f"path 6: checkpointed results differ ({same}, {d_s})")
            u_r, i_r = bvp.solve_checkpointed(u0, rhs, checkpoint_every=4,
                                              checkpoint_path=os.path.join(tmp, "ck4.npz"))
            log(f"[path 6] resumed from the 4-cycle file: cycles {i_r.cycles} (was "
                f"{i4.cycles}), u unchanged: {torch.equal(u_r, u4)}")
            if i_r.cycles != i4.cycles or not torch.equal(u_r, u4):
                raise AssertionError("path 6: a resume from a converged file ran cycles")
        del u, u_s, u4, u32, u_r, bvp, strict
    _order_check("[path 6]", errs)

    # The reduced drivers at 33^3 in fp32, against the port's CPU run.
    x, s, c = grid(33)
    ue = s[:, None, None] * s[None, :, None] * c[None, None, :]
    rhs = (-3.0 * np.pi**2 * ue).astype(np.float32)
    u0 = np.zeros_like(rhs)
    opts = Options(precision="fp32", niterex_max=4)
    for name, ngrids, kw in (("vcycle", None, {}), ("two_grid", 2, {}),
                             ("one_grid", None, {"niterex_max": 200})):
        h = GridHierarchy.from_mesh((x, x, x), ngrids=ngrids)
        cpu = getattr(PoissonBVP(h, BC_SETS["Ax"], opts, device="cpu"), name)(u0, rhs, **kw)
        gpu_bvp = PoissonBVP(h, BC_SETS["Ax"], opts, device="cuda")
        getattr(gpu_bvp, name)(u0, rhs, **kw)  # cold
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        got = getattr(gpu_bvp, name)(u0, rhs, **kw)
        torch.cuda.synchronize()
        counts, plain = ops.launch_counts(), ops.plain_cuda_counts()
        d = float((got.cpu() - cpu).abs().max())
        scale = float(cpu.abs().max())
        need = PATH6[:1] if name == "one_grid" else PATH6[:3]
        log(f"[path 6] {name} 33^3 fp32: max|cuda - cpu| {d:.3e} (bound 1e-5 * "
            f"{scale:.4e}); launches " + ", ".join(f"{k} {counts[k]}" for k in PATH6[:3]))
        if got.dtype != torch.float32 or not d <= 1e-5 * scale:
            raise AssertionError(f"path 6 {name}: {got.dtype}, max|cuda - cpu| {d}")
        check_counts(f"path 6 {name}", counts, plain, need)

    # Paths 7 and 7b: injected operators; Helmholtz launches no kernel, the
    # diffusion operator its own two and no other.
    launches7b = None
    for tag, op in (("7", HelmholtzOperator(1.9)), ("7b", DiffusionOperator(coef_xyz))):
        own = DIFFUSION if tag == "7b" else ()
        errs = {}
        for n in OP_SIZES:
            x, ue, rhs, opts = op_case(tag == "7b", n)
            u0 = np.zeros_like(rhs)

            def solve():
                return solve_poisson_bvp(u0, rhs, (x, x, x), DDD, options=opts, operator=op,
                                         device="cuda")

            solve()  # cold: engines, coarse matrix, face coefficients
            u, info, wall, counts, plain = _warm_solve(f"path {tag} {n}^3", solve)
            OP_WALLS[(tag, n)] = wall
            errs[n] = float((u.cpu() - torch.as_tensor(ue)).abs().max())
            log(f"[path {tag}] solve_poisson_bvp {n}^3 DDD mixed, {type(op).__name__}: "
                f"cycles {info.cycles}, du {info.du_last:.6e}, warm wall {wall:.4f} s, "
                f"max|u - exact| {errs[n]:.5e}")
            if (any(v for k, v in counts.items() if k not in own) or any(plain.values())
                    or not all(counts[k] > 0 for k in own)):
                raise AssertionError(f"path {tag}: other kernels, plain versions or not the "
                                     f"operator's own ran under the operator: {counts} {plain}")
            if n == n_big:
                log(f"[path {tag}] launches of a warm {n}^3 call: "
                    + (", ".join(f"{k} {counts[k]}" for k in own) + ", none of the other "
                       f"{len(counts) - len(own)} kernels" if own else
                       f"none of the {len(counts)} kernels (all counts 0)")
                    + ", no plain version on the card")
                profile_solve(f"[path {tag}] {n}^3", solve, counts["diffusion_sweep"] if own
                              else 0, "diffusion" if own else "lane_pass")
                if tag == "7b":
                    launches7b = counts
                    # The face terms the operator keeps while a solve runs: a
                    # warm call with them and one forming them in every call,
                    # each with its peak of device memory above its start.
                    def peak_run(what):
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                        base = torch.cuda.memory_allocated()
                        w = _warm_solve(what, solve)[2]
                        return w, (torch.cuda.max_memory_allocated() - base) / 2**20

                    held = peak_run(f"path 7b {n}^3 held")
                    object.__setattr__(op, "held", contextlib.nullcontext)
                    fresh = peak_run(f"path 7b {n}^3 fresh")
                    object.__delattr__(op, "held")
                    log(f"[path 7b] face terms: a warm {n}^3 call {held[0]:.4f} s, peak "
                        f"{held[1]:.1f} MiB above its start, holding them for the solve; "
                        f"{fresh[0]:.4f} s, {fresh[1]:.1f} MiB, forming them in every call; "
                        f"entries left in the operator after the solves: {len(op._terms)}")
                    if len(op._terms):
                        raise AssertionError("path 7b: the operator kept its terms after a solve")
                    h = GridHierarchy.from_mesh((x, x, x))
                    for shape, dq in ((h.shapes[-1], h.dq[-1]), ((16, 16, 16), (1 / 15,) * 3)):
                        t0 = time.perf_counter()
                        S, _ = coarse.build_coarse_matrix_from_operator(op, shape, dq, DDD)
                        log(f"[path 7b] generic coarse assembly at {'x'.join(map(str, shape))}"
                            f" ({int(np.prod(shape))} points, S {S.shape[0]}^2): "
                            f"{time.perf_counter() - t0:.4f} s on the host")
            del u
        _order_check(f"[path {tag}]", errs)
    return launches6, launches7b


# -- paths 8 and 8b: the golden tables and the 2D study through the port's examples

# The reference's power-law indices of the max table (RESULTS.md:39-45).
REF_INDICES = {"Ea_max": 1.999, "Ea_avg": 2.024, "Eb_max": 1.954, "Eb_avg": 2.120}
PATH8B = ("v2d_smooth", "v2d_smooth_residual", "v2d_smooth_cor")


def _compare_golden(ours: str, ref: str):
    """scripts/compare_golden.py on two table files: (its lines, the cells
    that differ as (dx, column))."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                          "compare_golden.py")
    proc = subprocess.run([sys.executable, script, ours, ref], capture_output=True, text=True,
                          timeout=60)
    lines = proc.stdout.strip().splitlines()
    if not lines or "rows matched" not in lines[-1]:
        raise AssertionError(f"compare_golden.py: {proc.stdout} {proc.stderr}")
    # "dx=4.76190e-02 Ea_max: ours=... ref=... DIFF"
    diffs = [(ln.split()[0][3:], ln.split()[1].rstrip(":")) for ln in lines
             if ln.endswith("DIFF")]
    return lines, diffs


def phase_golden_tables():
    """Path 8: both golden tables through
    ``ndsm_tpu_torch.examples.integration_scaling`` on the card (--warm,
    mixed, components batched): the max-metric table with default options,
    the mean-metric one with --mean --strict.  Each is written with --out
    and digit-compared with scripts/compare_golden.py against
    examples/golden.py's table; ierr 0 and bench.py's gate in every cell,
    the 22^3 and 220^3 max rows digit-exact.  A row with a differing digit
    is run again with the other ``mixed_inner_max`` and its digits printed.
    Returns the launches of the two tables."""
    import tempfile

    import numpy as np
    import torch

    from ndsm_tpu_torch import ops
    from ndsm_tpu_torch.examples import golden
    from ndsm_tpu_torch.examples import integration_scaling as IS

    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        for tag, mean, strict in (("max", False, False), ("mean", True, True)):
            opts = IS.options_for(mean=mean, precision="mixed", strict=strict)
            ours, ref = os.path.join(tmp, f"{tag}.txt"), os.path.join(tmp, f"{tag}_ref.txt")
            t0 = time.perf_counter()
            rows, infos = IS.run_table(IS.SCALE_FACTORS, opts, warm=True, device="cuda",
                                       out=ours, echo=False)
            took = time.perf_counter() - t0
            table = golden.TABLES[tag]
            golden.write_table(ref, table, mean=mean, source="reference golden table")
            lines, diffs = _compare_golden(ours, ref)
            for ln in lines:
                log(f"[path 8] {tag}: {ln}")
            exact = 4 * len(table) - len(diffs)
            log(f"[path 8] {tag}-metric table ({'--mean --strict' if mean else 'defaults'}, "
                f"{took:.1f} s with the cold calls): {exact} of {4 * len(table)} cells "
                f"digit-exact")
            bad = []
            for scale, row, info, g in zip(IS.SCALE_FACTORS, rows, infos, table):
                n = int(scale * 22)
                errs = [abs(a - b) / b for a, b in zip(row[1:5], g[1:5])]
                cyc = " ".join(f"{s.name}={s.cycles}" for s in info.chi + info.components)
                log(f"[path 8] {tag} {n}^3: {golden.format_row(row)}; warm wall {row[5]:.4f} s; "
                    f"ierr {info.ierr}; largest |err - golden| / golden {max(errs):.2e}; "
                    f"cycles {cyc}")
                if info.ierr != 0 or max(errs) >= GATE:
                    bad.append(n)
            indices = IS.power_law_indices(rows)
            log(f"[path 8] {tag} power-law indices: " + ", ".join(
                f"{k} {v:.4f} (reference {REF_INDICES[k]})" for k, v in zip(IS.NAMES, indices)
                if k in REF_INDICES))
            if bad:
                raise AssertionError(f"path 8 {tag}: ierr or the gate failed at {bad}")
            if tag == "max":
                ends = {f"{table[0][0]:.5e}", f"{table[-1][0]:.5e}"}
                if any(dx in ends for dx, _ in diffs):
                    raise AssertionError(f"path 8: a 22^3 or 220^3 max row is not digit-exact: "
                                         f"{diffs}")
            for dx in sorted({dx for dx, _ in diffs}):
                k = next(i for i, g in enumerate(table) if f"{g[0]:.5e}" == dx)
                scale = IS.SCALE_FACTORS[k]
                info = infos[k]
                log(f"[path 8] {tag} {int(scale * 22)}^3 differs in "
                    + ", ".join(c for d, c in diffs if d == dx) + "; du_last "
                    + " ".join(f"{s.name}={s.du_last:.6e}" for s in info.chi + info.components))
                other = IS.options_for(mean=mean, precision="mixed", strict=not strict)
                row2, info2 = IS.run_row(scale, other, device="cuda")
                log(f"[path 8] {tag} {int(scale * 22)}^3 again with mixed_inner_max="
                    f"{other.mixed_inner_max}: {golden.format_row(row2)} (golden "
                    f"{golden.format_row(table[k])}); cycles "
                    + " ".join(f"{s.name}={s.cycles}" for s in info2.chi + info2.components))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_counts("path 8: both golden tables", launches, ops.plain_cuda_counts(), PATH1)
    return launches


def phase_2d_study():
    """Path 8b: ``ndsm_tpu_torch.examples.unit_test_2d_solve`` on the card,
    all nine sizes (27 x 36 to 675 x 900, all-Neumann, mixed): ierr 0, the
    power-law index 1.9-2.1, each row within 1e-4 relative of the recorded
    TPU run (docs/unit_test_2d_solve_r04.txt); the v2d forms launched, the
    global route among them (675 x 900), no plain version on the card.
    Returns the launches."""
    import tempfile

    import numpy as np
    import torch

    from ndsm_tpu_torch import ops
    from ndsm_tpu_torch.examples import unit_test_2d_solve as U
    from ndsm_tpu_torch.ops import v2d

    for nx, ny in U.shapes():
        p = v2d.v2d_plan(1, nx, ny)
        log(f"[v2d plan] 2D study {nx}x{ny}, one lane: route {p.route}, C {p.cluster}, "
            f"rows {p.rows}, shared {p.smem_bytes} B")
    recorded = np.loadtxt(os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs",
                                       "unit_test_2d_solve_r04.txt"))
    with tempfile.TemporaryDirectory() as tmp:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        data, infos, gamma = U.main(["--data", os.path.join(tmp, "res.txt"), "--device", "cuda"])
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        launches, routes = ops.launch_counts(), ops.v2d_route_launches()
    rel = np.abs(data[:, 1:] - recorded[:, 1:]) / recorded[:, 1:]
    for (nx, ny), row, r, info in zip(U.shapes(), data, rel, infos):
        log(f"[path 8b] {nx}x{ny}: Emax {row[1]:.6e} Eavg {row[2]:.6e}, cycles {info.cycles}, "
            f"ierr {info.ierr}; relative difference from the recorded run {r[0]:.2e} / "
            f"{r[1]:.2e}")
    log(f"[path 8b] 2D study: power-law index {gamma:.6f}, largest relative difference "
        f"{rel.max():.3e}, {took:.1f} s (cold calls); v2d launches by route {routes}")
    check_counts("path 8b: unit_test_2d_solve", launches, ops.plain_cuda_counts(), PATH8B)
    if any(i.ierr for i in infos) or not 1.9 <= gamma <= 2.1 or not rel.max() <= 1e-4:
        raise AssertionError(f"path 8b: ierr {[i.ierr for i in infos]}, index {gamma}, "
                             f"relative difference {rel.max()}")
    if not routes["global"]:
        raise AssertionError(f"path 8b: the global v2d route never launched: {routes}")
    return launches


# -- path 9: host_curl and split16; path 10: per_face; profiling

HOST_CURL = {"device curl": {}, "host_curl": {"host_curl": True},
             "host_curl+split16": {"host_curl": True, "fetch_encoding": "split16"}}


def phase_host_curl():
    """Path 9: ``vector_potential`` at 220^3, mixed, components batched,
    three ways in turns, three times each: the default (B = curl(A) on the
    card, A and B copied), ``host_curl=True`` (A alone copied, in slabs
    into pinned buffers, B its curl on the host) and ``host_curl`` with
    ``fetch_encoding="split16"``.  A of host_curl bitwise the default's, B
    within 1e-13 max|B|; split16's A within max|A - f32(A)| / 32767 with
    the golden digits exact; one call with ``output_dtype="float32"``.
    Returns the launches of a counted host_curl call."""
    import numpy as np
    import torch

    from ndsm_tpu_torch import ops

    for kw in HOST_CURL.values():
        run(220, **kw)  # cold: the engines are warm, the host buffers not
    ops.reset_launch_counts()
    run(220, **HOST_CURL["host_curl"])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_counts("path 9: 220^3 warm, host_curl", launches, ops.plain_cuda_counts(), PATH1)
    _, _, A_d, B_d = run(220)
    bmax = float(np.abs(B_d).max())
    split_bound = float(np.abs(A_d - A_d.astype(np.float32).astype(np.float64)).max()) / 32767
    turns = {k: [] for k in HOST_CURL}
    for rep in range(3):
        for tag, kw in HOST_CURL.items():
            wall, info, A, B = run(220, **kw)
            da, db = float(np.abs(A - A_d).max()), float(np.abs(B - B_d).max())
            turns[tag].append((wall, info.phases))
            log(f"[path 9] {tag} call {rep + 1}: wall {wall:.4f} s; " + " ".join(
                f"{k}={v:.4f}" for k, v in info.phases.items()) + f"; max|A - A_dev| {da:.3e} "
                f"(bitwise {np.array_equal(A, A_d)}), max|B - B_dev| {db:.3e} (bitwise "
                f"{np.array_equal(B, B_d)})")
            if tag == "host_curl" and (not np.array_equal(A, A_d) or not db <= 1e-13 * bmax):
                raise AssertionError(f"path 9 host_curl: A differs or max|dB| {db} > 1e-13 "
                                     f"* {bmax}")
            if tag == "host_curl+split16":
                ea = float(np.linalg.norm(_CASES[220][3] - A, axis=0).max())
                digits = f"{ea:.5e}" == f"{GOLDEN[220][0]:.5e}"
                if not da <= split_bound or not digits:
                    raise AssertionError(f"path 9 split16: max|dA| {da} > {split_bound} or "
                                         f"Ea_max {ea:.5e} not the golden digits")
            del A, B
    for tag, tv in turns.items():
        keys = [k for k in ("post", "host_alloc", "slab_split", "fetch", "curl")
                if k in tv[0][1]]
        log(f"[path 9] {tag} in turns: wall " + " ".join(f"{w:.4f}" for w, _ in tv) + " s; "
            + "; ".join(f"{k} " + " ".join(f"{ph[k]:.4f}" for _, ph in tv) for k in keys))
    log(f"[path 9] split16 bound max|A - f32(A)| / 32767 = {split_bound:.3e}")
    # float32 outputs: B is the curl of the float32 A, whose rounding the
    # differences carry (eps32 |A| / h): outside the golden gate at 220^3
    _, info32, A32, B32 = run(220, gate=False, host_curl=True, output_dtype="float32")
    d32 = float(np.abs(A32 - A_d).max())
    log(f"[path 9] host_curl, output_dtype=float32: {A32.dtype}, max|A32 - A_dev| {d32:.3e}, "
        f"max|B32 - B_dev| {float(np.abs(B32 - B_d).max()):.3e}; phases " + " ".join(
            f"{k}={v:.4f}" for k, v in info32.phases.items()))
    if A32.dtype != np.float32 or B32.dtype != np.float32 or not d32 <= 1e-6 * float(
            np.abs(A_d).max()):
        raise AssertionError(f"path 9 float32: {A32.dtype} {B32.dtype}, max|dA| {d32}")
    return launches


def phase_per_face():
    """Path 10: ``per_face=True`` at 22^3 and 220^3, mixed: 18 component
    solves one after the other on the one-lane kernels and the defect, no
    lane form; both sizes in bench.py's gate; at 220^3 A within 1e-6 and B
    within 1e-4 of path 1b's, the warm wall beside path 1b's.  Returns the
    launches of the warm 220^3 call."""
    import numpy as np
    import torch

    from ndsm_tpu_torch import ops

    run(22, per_face=True)
    run(220, per_face=True)  # cold: first use of the one-face solves
    ops.reset_launch_counts()
    wall, info, A_pf, B_pf = run(220, per_face=True)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    lanes = ("fused_smooth_3d_batched", "fused_smooth_residual_3d_batched",
             "fused_smooth_cor_3d_batched")
    check_counts("path 10: 220^3 warm, per_face", launches, ops.plain_cuda_counts(), PATH1B,
                 never=lanes)
    wall_b, _, A_b, B_b = run(220, "off")
    da, db = float(np.abs(A_pf - A_b).max()), float(np.abs(B_pf - B_b).max())
    log(f"[path 10] per_face 220^3: {len(info.components)} component solves, warm wall "
        f"{wall:.4f} s (path 1b {wall_b:.4f} s), solve3d {info.phases['solve3d']:.4f} s; "
        f"max|A_pf - A_1b| {da:.3e}, max|B_pf - B_1b| {db:.3e}; cycles "
        + " ".join(f"{s.name}={s.cycles}" for s in info.components))
    if len(info.components) != 18 or not da <= 1e-6 or not db <= 1e-4:
        raise AssertionError(f"path 10: {len(info.components)} solves, max|dA| {da}, "
                             f"max|dB| {db}")
    return launches


def phase_profiling():
    """``utils.profiling``: one warm path-1 220^3 call inside
    ``profiling.trace``, whose trace file must name the chi and solve3d
    ranges and the lane pass; a ``Timer`` with ``sync`` around three calls
    of ``compute_vector_potential``."""
    import glob
    import tempfile

    import numpy as np

    from ndsm_tpu_torch import Options, compute_vector_potential
    from ndsm_tpu_torch.potential.vector_potential import CHI_RANGE, SOLVE3D_RANGE
    from ndsm_tpu_torch.utils import profiling

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with profiling.trace(tmp):
            run(220)
        took = time.perf_counter() - t0
        files = glob.glob(os.path.join(tmp, "*.json"))
        text = open(files[0]).read() if len(files) == 1 else ""
        found = {k: k in text for k in (CHI_RANGE, SOLVE3D_RANGE, "lane_pass")}
        log(f"[profiling] trace of a warm 220^3 call ({took:.2f} s with the export): "
            f"{[os.path.basename(f) for f in files]}, {len(text) / 2**20:.1f} MiB; names "
            f"{found}")
        if not all(found.values()):
            raise AssertionError(f"profiling.trace: {files} lacks a name: {found}")
    x, y, z, _, b1 = _CASES[220]
    timer = profiling.Timer()
    for _ in range(3):
        out = []
        with timer.phase("compute_vector_potential 220^3", sync=out):
            out.extend(compute_vector_potential((x, y, z), b1, Options(precision="mixed"),
                                                device="cuda")[1:3])
        if not np.isfinite(out[0][0, 1, 1, 1].item()):
            raise AssertionError("profiling: non-finite A")
    log("[profiling] Timer, sync=[A, B]: " + timer.report())


# -- paths 11, 11b and 12: several processes, and PoissonBVP(shard_spec=...)

MH_TIMEOUT = 300.0  # seconds for each group of worker processes
# path 11's engine: 256^3 .. 16^3 sharded over 2 x 2, the 8^3 seam level and
# the 4^3 coarse level on the root's rank (B1-B3 there)
MH_MINROWS = 8
B1_B3 = ("zc_smooth_3d", "zc_smooth_residual_3d", "zc_smooth_cor_3d")


def _mp_sine(n, backend, tmp, dev, ckpt_every=None, solves=2):
    """The workers of path 11 (or its NCCL form): ``multihost.sine_problem``
    at n^3 on a (2, 2) (z, y) mesh of 2 ranks; returns their reports and
    results (u after ``solves`` solves, and the checkpointed u when
    ``ckpt_every``)."""
    import numpy as np

    from ndsm_tpu_torch.parallel import multihost

    env = {"NDSM_MH_PROBLEM": "sine", "NDSM_MH_N": str(n), "NDSM_MH_MINROWS": str(MH_MINROWS),
           "NDSM_MH_REPS": str(solves), "NDSM_MH_OUT": tmp}
    if ckpt_every:
        env.update(NDSM_MH_CKPT=os.path.join(tmp, "ck.npz"), NDSM_MH_CKPT_EVERY=str(ckpt_every))
    reports = multihost.run_workers(2, 2, dev, backend, MH_TIMEOUT, env, workdir=tmp)
    us = [np.load(os.path.join(tmp, f"u{r}.npy")) if solves else None for r in range(2)]
    cks = [np.load(os.path.join(tmp, f"ck{r}.npy")) if ckpt_every else None for r in range(2)]
    return reports, us, cks


def _walls(reports, key="wall"):
    return " ".join(f"{rep[key]:.4f}" for rep in reports)


def _sum(reports, key):
    return {k: sum(rep[key][k] for rep in reports) for k in reports[0][key]}


def _check_ranks(what, reps, need_root, need_every):
    """Every rank launched ``need_every``; the root's rank ``need_root``
    too, the others none of B1-B3 (the replicated levels are the root's);
    no plain version on the card anywhere."""
    for r, rep in enumerate(reps):
        check_counts(f"{what}, rank {r}", rep["launches"], rep["plain"],
                     need_root if r == 0 else need_every, () if r == 0 else B1_B3)


def phase_multiprocess(path4, u5, dev="cuda", n=256, n_vp=220):
    """Paths 11 (with its dry run, its checkpoint and, on two cards or
    more, its NCCL form), 11b and 12; see the module docstring.  ``dev``
    "cpu" and smaller sizes rehearse the phase without a card.  Returns
    the launches of each rank (paths 11 and 11b) and of path 12."""
    import tempfile

    import numpy as np
    import torch

    from ndsm_tpu_torch import PoissonBVP, ops
    from ndsm_tpu_torch.parallel import collectives as C
    from ndsm_tpu_torch.parallel import multihost
    from ndsm_tpu_torch.parallel.shard import ShardSpec, make_mesh, make_mesh_nd
    from ndsm_tpu_torch.parallel.sm_engine import ShardedPoissonBVP

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    one_dev = "cuda:0" if dev == "cuda" else "cpu"

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    multihost.dryrun(2, 2, device=dev, timeout=MH_TIMEOUT, log=lambda m: log(f"[path 11] {m}"))
    log(f"[path 11] dryrun (2 ranks x 2 positions on {one_dev}, gloo) took "
        f"{time.perf_counter() - t0:.1f} s with its one-process reference")

    h, bcs, opts, u0, rhs, exact = multihost.sine_problem(n)
    sb = ShardedPoissonBVP(h, bcs, opts, mesh=make_mesh_nd((2, 2), ("z", "y"),
                                                           devices=[one_dev] * 4),
                           axis_names=("z", "y"), min_rows_per_shard=MH_MINROWS)
    sb.solve(u0, rhs)  # cold
    ops.reset_launch_counts()
    C.reset_counts()
    t0 = time.perf_counter()
    u1, i1 = sb.solve(u0, rhs)
    sync()
    wall1 = time.perf_counter() - t0
    one = C.counts()
    u1 = u1.cpu().numpy()
    strict, _ = sb._strict_sibling().solve(u0, rhs)
    strict = strict.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        reps, us, cks = _mp_sine(n, "gloo", tmp, dev, ckpt_every=4)
        t_spawn = time.perf_counter() - t0
        resumed, _, cks_r = _mp_sine(n, "gloo", tmp, dev, ckpt_every=4, solves=0)
    where = f"path 11: {n}^3 Ax mixed over a (2, 2) mesh of 2 gloo ranks"
    if dev == "cuda":  # (a CPU rehearsal runs the plain versions)
        _check_ranks(where, reps, PATH5B, ZY)
    summed, remote = _sum(reps, "counts"), _sum(reps, "traffic")
    same = [bool(np.array_equal(u, u1)) for u in us]
    err = float(np.abs(u1 - exact).max())
    log(f"[path 11] {where}: u bitwise the one-process (2, 2) mesh on ranks 0, 1: {same}; "
        f"cycles {[rep['cycles'] for rep in reps]} / {i1.cycles}; max|u - exact| {err:.3e}")
    log(f"[path 11] messages, bytes summed over the ranks {summed}, one process {one}; across "
        f"processes {remote}; seam {reps[0]['seam']} (the root's rank holds the levels below)")
    log(f"[path 11] warm wall: ranks {_walls(reps)} s, one "
        f"process {wall1:.4f} s (two ranks on one card: host staging and process overlap, "
        f"not a multi-card cost); workers' call {t_spawn:.1f} s with start-up, build load, "
        "a cold and a warm solve and the checkpointed solve")
    if not all(same) or any(rep["cycles"] != i1.cycles for rep in reps) or summed != one:
        raise AssertionError(f"{where}: differs from the one-process run ({same}, "
                             f"{summed} / {one})")
    ck_same = [bool(np.array_equal(c, strict)) for c in cks]
    rs_same = [bool(np.array_equal(c, strict)) for c in cks_r]
    log(f"[path 11] solve_checkpointed every 4 across the ranks (rank 0 writes): cycles "
        f"{[rep['ck_cycles'] for rep in reps]}, wall {_walls(reps, 'ck_wall')} "
        f"s, bitwise the strict sibling's solve: {ck_same}; resumed by 2 new ranks: cycles "
        f"{[rep['ck_cycles'] for rep in resumed]}, launches "
        f"{[sum(rep['launches'].values()) for rep in resumed]}, bitwise: {rs_same}")
    if not (all(ck_same) and all(rs_same)) or any(
            sum(rep["launches"].values()) or rep["ck_cycles"] != reps[0]["ck_cycles"]
            for rep in resumed):
        raise AssertionError("path 11: the checkpointed run or its resume differs")
    if dev == "cuda" and torch.cuda.device_count() >= 2:
        multihost.dryrun(2, 2, device="cuda", backend="nccl", timeout=MH_TIMEOUT,
                         log=lambda m: log(f"[path 11 nccl] {m}"))
        with tempfile.TemporaryDirectory() as tmp:
            nreps, nus, _ = _mp_sine(n, "nccl", tmp, dev)
        _check_ranks("path 11 nccl", nreps, PATH5B, ZY)
        if not all(np.array_equal(u, u1) for u in nus):
            raise AssertionError("path 11 nccl: u differs from the one-process run")
        log(f"[path 11 nccl] {n}^3 over 2 NCCL ranks, one a card: u bitwise; warm wall "
            f"{_walls(nreps)} s")
    else:
        log(f"[path 11 nccl] not run: torch.cuda.device_count() = "
            f"{torch.cuda.device_count() if dev == 'cuda' else 0}; the NCCL form needs one "
            "card a rank (NCCL refuses two ranks on one card)")
    del u1, us, cks, cks_r, strict

    A4, B4, info4, wall4 = path4
    x, y, z, A_ex, b_ex = _CASES[n_vp]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        vreps = multihost.run_workers(2, 1, dev, "gloo", MH_TIMEOUT, {
            "NDSM_MH_PROBLEM": "vp", "NDSM_MH_N": str(n_vp), "NDSM_MH_REPS": "2",
            "NDSM_MH_OUT": tmp}, workdir=tmp)
        t_spawn = time.perf_counter() - t0
        where = f"path 11b: vector_potential {n_vp}^3 mixed, dist over a z mesh of 2 gloo ranks"
        cyc4 = [s.cycles for s in info4.chi + info4.components]
        for r, rep in enumerate(vreps):
            with np.load(os.path.join(tmp, f"vp{r}.npz")) as f:
                A, B = f["A"], f["B"]
            ea = float(np.linalg.norm(A_ex - A, axis=0).max())
            eb = float(np.linalg.norm(b_ex - B, axis=0).max())
            digits = f"{ea:.5e} {eb:.5e}" == " ".join(f"{g:.5e}" for g in GOLDEN[n_vp])
            da, db = float(np.abs(A - A4).max()), float(np.abs(B - B4).max())
            log(f"[path 11b] rank {r}: Ea_max {ea:.5e} Eb_max {eb:.5e} (golden digits exact: "
                f"{digits}); max|A_mp - A_4| {da}, max|B_mp - B_4| {db}; cycles {rep['cycles']} "
                f"(path 4: {cyc4}); warm wall {rep['wall']:.4f} s (path 4: {wall4:.4f} s, one "
                "process, two positions)")
            if rep["ierr"] or not digits or da != 0.0 or db != 0.0 or rep["cycles"] != cyc4:
                raise AssertionError(f"{where}, rank {r}: not path 4's result")
            del A, B
    if dev == "cuda":
        _check_ranks(where, vreps, PATH4, PATH4[:4])
    log(f"[path 11b] messages, bytes summed over the ranks {_sum(vreps, 'counts')}; across "
        f"processes {_sum(vreps, 'traffic')}; workers' call {t_spawn:.1f} s")

    spec = ShardSpec(make_mesh(4, devices=[one_dev] * 4), min_rows_per_shard=4)
    bvp = PoissonBVP(h, bcs, opts, device=one_dev, shard_spec=spec)
    bvp.solve(u0, rhs)  # cold
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    u12, i12 = bvp.solve(u0, rhs)
    sync()
    wall12 = time.perf_counter() - t0
    path12 = ops.launch_counts()
    if dev == "cuda":
        check_counts(f"path 12: PoissonBVP(shard_spec=ShardSpec(4 shards)) {n}^3 Ax mixed",
                     path12, ops.plain_cuda_counts(), PATH5)
    same = torch.equal(u12, u5)
    log(f"[path 12] PoissonBVP(shard_spec=...) {n}^3 Ax mixed over 4 shards: {i12.cycles} "
        f"cycles in {wall12:.4f} s; u bitwise path 5's: {same}")
    if not same:
        raise AssertionError("path 12: u differs from path 5's")
    log(f"[multi] paths 11, 11b and 12 took {time.perf_counter() - t_phase:.1f} s")
    return [rep["launches"] for rep in reps], [rep["launches"] for rep in vreps], path12


# -- paths 13, 13b, 13c and 11c: injected operators and the reduced drivers
# under a spec, and ranks that hold no position of the engine's mesh

SH_OP_SIZES = (128, 256)  # 256 rows over 4 z shards (257 does not divide)
SH_DRIVERS = (("vcycle", 256, {}), ("two_grid", 256, {"niterex_max": 4}),
              ("one_grid", 64, {"niterex_max": 200}))
B10 = ("zc_smooth_sharded_3d", "zc_smooth_residual_sharded_3d")


def sweep_on_blocks_bitwise(tag, op, specs, dev="cuda", shapes=((256, 256, 256),
                                                                  (260, 258, 256))):
    """One fp64 sweep (the operator's relax on the halo-extended blocks)
    and one residual of the sharded operator engine on random u and rhs,
    gathered, bitwise the operator's unsharded relax and residual on the
    card, over each mesh of ``specs``: at 256^3 (even block offsets) and
    at 260 x 258 x 256 (65 rows a z shard: offsets 65 and 195; 129 a y
    shard: an odd sum of offsets on the 2 x 2 mesh), where red and black
    swapped on a block would show."""
    import numpy as np
    import torch

    from ndsm_tpu_torch import GridHierarchy, Options
    from ndsm_tpu_torch.parallel import collectives as C
    from ndsm_tpu_torch.parallel.sm_engine import _OperatorBVP

    DDD = (("D", "D"),) * 3
    rng = np.random.default_rng(14)
    for shape in shapes:
        h = GridHierarchy.from_mesh(tuple(np.linspace(0.0, 1.0, k) for k in shape))
        u = torch.as_tensor(rng.standard_normal(shape), device=dev)
        r = torch.as_tensor(rng.standard_normal(shape), device=dev)
        dq = h.dq[0]
        with op.held():
            want_u, want_r = op.relax(u, r, dq, DDD), op.residual(u, r, dq, DDD)
        for where, spec in specs.items():
            sb = _OperatorBVP(h, DDD, Options(precision="fp64"), operator=op, mesh=spec.mesh,
                              axis_names=tuple(nm for _, nm in spec.partitioned_axes()),
                              min_rows_per_shard=spec.min_rows_per_shard)
            ub, rb = C.shard(u, sb.sub, 0, sb.grid), C.shard(r, sb.sub, 0, sb.grid)
            with op.held():
                got_u = C.unshard(sb._sh_smooth(ub, rb, 0, 1), sb.sub, 0, sb.grid)
                got_r = C.unshard(sb._sh_residual(ub, rb, 0), sb.sub, 0, sb.grid)
            offs = sorted({sb._offsets(0, p) for p in sb.local})
            same = torch.equal(got_u, want_u), torch.equal(got_r, want_r)
            log(f"[path {tag}] one fp64 sweep and one residual on the blocks, "
                f"{'x'.join(map(str, shape))} over {where} (block offsets {offs}): bitwise "
                f"the unsharded {type(op).__name__}: sweep {same[0]}, residual {same[1]} "
                f"(max|diff| {float((got_u - want_u).abs().max()):.3e} / "
                f"{float((got_r - want_r).abs().max()):.3e})")
            if not all(same):
                raise AssertionError(f"path {tag}: the sharded sweep or residual differs on "
                                     f"{shape} over {where}")
            del got_u, got_r, ub, rb, sb
        del u, r, want_u, want_r


def phase_sharded_operators(dev="cuda", sizes=SH_OP_SIZES):
    """Paths 13 (``HelmholtzOperator(1.9)``) and 13b
    (``DiffusionOperator(coef_xyz)``): paths 7/7b's cases through
    ``solve_poisson_bvp(..., shard_spec=ShardSpec(make_mesh(4,
    devices=["cuda"] * 4)))`` at 128^3 and 256^3 (mixed), and at 256^3
    over a 2 x 2 (z, y) mesh: h^2 convergence, the same operator's
    unsharded 256^3 solve on the card (cycles within 1, max|u_sh - u| <=
    5e-9 max|u|), no plain version and no Poisson kernel launched (13b: the
    diffusion kernels are), no plain sharded route run, the messages and bytes; the warm 256^3 z-mesh solve once
    more under torch.profiler; first one sweep and one residual on the
    blocks bitwise the unsharded ones (``sweep_on_blocks_bitwise``).  ``dev`` "cpu" and smaller ``sizes``
    rehearse the phase without a card."""
    import numpy as np
    import torch

    from ndsm_tpu_torch import DiffusionOperator, HelmholtzOperator, solve_poisson_bvp
    from ndsm_tpu_torch.parallel import collectives as C
    from ndsm_tpu_torch.parallel import sm_engine
    from ndsm_tpu_torch.parallel.shard import ShardSpec, make_mesh, make_mesh_nd

    DDD = (("D", "D"),) * 3
    specs = {"4 z shards": ShardSpec(make_mesh(4, devices=[dev] * 4)),
             "a 2 x 2 (z, y) mesh": ShardSpec(make_mesh_nd((2, 2), ("z", "y"),
                                                           devices=[dev] * 4),
                                              extra_axes=((1, "y"),))}
    for tag, op in (("13", HelmholtzOperator(1.9)), ("13b", DiffusionOperator(coef_xyz))):
        t_path = time.perf_counter()
        sweep_on_blocks_bitwise(tag, op, specs, dev)
        errs, name = {}, type(op).__name__
        for n in sizes:
            x, ue, rhs, opts = op_case(tag == "13b", n)
            u0 = np.zeros_like(rhs)
            scale = float(np.abs(ue).max())
            walls, us = {}, {}
            for where, spec in specs.items() if n == sizes[1] else list(specs.items())[:1]:
                def solve(spec=spec):
                    return solve_poisson_bvp(u0, rhs, (x, x, x), DDD, options=opts, operator=op,
                                             device=dev, shard_spec=spec)

                solve()  # cold: the engines, the windows' face terms
                sm_engine.reset_plain_route_counts()
                C.reset_counts()
                u, info, walls[where], counts, plain = _warm_solve(f"path {tag} {n}^3", solve)
                msgs, routes = C.counts(), sm_engine.plain_route_counts()
                err = float((u.cpu() - torch.as_tensor(ue)).abs().max())
                log(f"[path {tag}] solve_poisson_bvp {n}^3 DDD mixed, {name}, shard_spec over "
                    f"{where}: cycles {info.cycles}, du {info.du_last:.6e}, warm wall "
                    f"{walls[where]:.4f} s, max|u - exact| {err:.5e}; {msgs['messages']} "
                    f"messages, {msgs['bytes']} bytes between the shards; kernel launches "
                    f"{sum(counts.values())} (of {len(counts)} kernels; "
                    f"{', '.join(f'{k} {counts[k]}' for k in DIFFUSION)}), plain versions on the "
                    f"card {sum(plain.values())}, plain sharded routes {sum(routes.values())}")
                own = DIFFUSION if tag == "13b" else ()
                if (any(v for k, v in counts.items() if k not in own) or any(plain.values())
                        or any(routes.values()) or not all(counts[k] > 0 for k in own)):
                    raise AssertionError(f"path {tag}: a Poisson kernel or route, or not the "
                                         f"operator's own kernels, ran under the operator: "
                                         f"{counts} {plain} {routes}")
                us[where] = (u, info)
                if where == "4 z shards":
                    errs[n], sweeps4 = err, counts["diffusion_sweep"]
            if n != sizes[1]:
                continue
            profile_solve(f"[path {tag}] {n}^3 over 4 z shards", lambda: solve_poisson_bvp(
                u0, rhs, (x, x, x), DDD, options=opts, operator=op, device=dev,
                shard_spec=specs["4 z shards"]), sweeps4, "diffusion" if own else "lane_pass")

            def one():
                return solve_poisson_bvp(u0, rhs, (x, x, x), DDD, options=opts, operator=op,
                                         device=dev)

            one()  # cold
            u1, i1, wall1, _, _ = _warm_solve(f"path {tag} {n}^3 unsharded", one)
            for where, (u, info) in us.items():
                d = float((u - u1).abs().max())
                log(f"[path {tag}] {n}^3 over {where} against the unsharded operator solve on "
                    f"the card: max|u_sh - u| {d:.3e} (bound 5e-9 * {scale:.4f}), cycles "
                    f"{info.cycles} / {i1.cycles}")
                if not d <= 5e-9 * scale or abs(info.cycles - i1.cycles) > 1:
                    raise AssertionError(f"path {tag} over {where}: max|u_sh - u| {d}, cycles "
                                         f"{info.cycles} / {i1.cycles}")
            path7 = OP_WALLS.get(("7" if tag == "13" else "7b", OP_SIZES[1]))
            log(f"[path {tag}] warm walls at {n}^3: over 4 z shards {walls['4 z shards']:.4f} "
                f"s, over a 2 x 2 (z, y) mesh {walls['a 2 x 2 (z, y) mesh']:.4f} s, unsharded "
                f"{wall1:.4f} s; path {'7' if tag == '13' else '7b'} (unsharded, "
                f"{OP_SIZES[1]}^3, this run) "
                + ("not run" if path7 is None else f"{path7:.4f} s"))
            del u1, us
        _order_check(f"[path {tag}]", errs, sizes)
        log(f"[path {tag}] took {time.perf_counter() - t_path:.1f} s")


def phase_sharded_drivers(dev="cuda", cases=SH_DRIVERS):
    """Path 13c: the reduced drivers under a spec
    (``PoissonBVP(shard_spec=ShardSpec(make_mesh(4, devices=["cuda"] *
    4)))``, Poisson, fp32, Ax, the sine case of path 6): ``vcycle`` and
    ``two_grid`` (``niterex_max=4``, level 1 sharded: the relax-to-ex_tol
    loop on the blocks) at 256^3, ``one_grid`` (``niterex_max=200``) at
    64^3 (16 rows a shard), each held to the same driver without a spec on
    the card (within 1e-5 max|u|, as path 6 holds its drivers) and its
    launches counted.  Returns {driver: (kernels it needs, launches)}.
    ``dev`` "cpu" and smaller ``cases`` rehearse the phase without a
    card."""
    import numpy as np
    import torch

    from ndsm_tpu_torch import GridHierarchy, Options, PoissonBVP, ops
    from ndsm_tpu_torch.parallel import collectives as C
    from ndsm_tpu_torch.parallel.shard import ShardSpec, make_mesh

    t_path = time.perf_counter()
    spec = ShardSpec(make_mesh(4, devices=[dev] * 4))
    opts = Options(precision="fp32")
    out = {}
    for name, n, kw in cases:
        x = np.linspace(0.0, 1.0, n)
        ue = (np.sin(np.pi * x)[:, None, None] * np.sin(np.pi * x)[None, :, None]
              * np.cos(np.pi * x)[None, None, :])
        rhs = (-3.0 * np.pi**2 * ue).astype(np.float32)
        u0 = np.zeros_like(rhs)
        h = GridHierarchy.from_mesh((x, x, x))
        sharded = PoissonBVP(h, BC_SETS["Ax"], opts, device=dev, shard_spec=spec)
        want = getattr(PoissonBVP(h, BC_SETS["Ax"], opts, device=dev), name)(u0, rhs, **kw)
        getattr(sharded, name)(u0, rhs, **kw)  # cold
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        C.reset_counts()
        t0 = time.perf_counter()
        got = getattr(sharded, name)(u0, rhs, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, plain, msgs = ops.launch_counts(), ops.plain_cuda_counts(), C.counts()
        d = float((got - want).abs().max())
        scale = float(want.abs().max())
        seam = sharded._sharded.seam
        need = B10 + B1_B3 if name == "vcycle" else B10 if name == "two_grid" else B10[:1]
        log(f"[path 13c] {name} {n}^3 fp32 over 4 z shards (levels 0-{seam - 1} sharded): "
            f"max|u_sh - u| {d:.3e} (bound 1e-5 * {scale:.4e}; bitwise: "
            f"{torch.equal(got, want)}), warm wall {wall:.4f} s, {msgs['messages']} messages, "
            f"{msgs['bytes']} bytes; launches " + ", ".join(f"{k} {counts[k]}" for k in need))
        check_counts(f"path 13c {name}", counts, plain, need,
                     ZY + PATH4[2:4] + (() if name == "vcycle" else B1_B3))
        if got.dtype != torch.float32 or not d <= 1e-5 * scale:
            raise AssertionError(f"path 13c {name}: {got.dtype}, max|u_sh - u| {d}")
        out[name] = (need, counts)
    log(f"[path 13c] took {time.perf_counter() - t_path:.1f} s")
    return out


def phase_ranks_along_y(ref4b, dev="cuda", n=256, n_vp=220):
    """Path 11c: 2 gloo ranks laid out along y of a (2, 2) mesh (2
    positions each on ``cuda:0``; ``multihost.make_multihost_mesh(...,
    process_axis=1)``).  ``ShardedPoissonBVP(axis_names=("z",))`` at 256^3
    (path 11's problem): each rank runs the engine on its own z line, u
    bitwise the one-process (2, 2) mesh's on both ranks, no message across
    processes.  ``vector_potential(dist=DistConfig(mesh, ("z", "y")))`` at
    220^3: the 3D solves across both ranks, the chi faces on each rank's z
    line; golden digits, A and B exactly path 4b's, path 4b's cycles.
    Returns each group's launches by rank.  ``dev`` "cpu" and smaller sizes
    rehearse the phase without a card (path 4b's reference at ``n_vp``
    on a CPU mesh, ``_CASES[n_vp]`` filled first)."""
    import tempfile

    import numpy as np
    import torch

    from ndsm_tpu_torch.parallel import multihost
    from ndsm_tpu_torch.parallel.shard import make_mesh_nd
    from ndsm_tpu_torch.parallel.sm_engine import ShardedPoissonBVP

    t_path = time.perf_counter()
    A4b, B4b, info4b, wall4b = ref4b
    one_dev = "cuda:0" if dev == "cuda" else "cpu"
    h, bcs, opts, u0, rhs, exact = multihost.sine_problem(n)
    sb = ShardedPoissonBVP(h, bcs, opts, axis_names=("z",), min_rows_per_shard=MH_MINROWS,
                           mesh=make_mesh_nd((2, 2), ("z", "y"), devices=[one_dev] * 4))
    sb.solve(u0, rhs)  # cold
    t0 = time.perf_counter()
    u1, i1 = sb.solve(u0, rhs)
    sb._sync()
    wall1 = time.perf_counter() - t0
    u1 = u1.cpu().numpy()
    along_y = {"NDSM_MH_LAYOUT": "y", "NDSM_MH_REPS": "2"}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        reps = multihost.run_workers(2, 2, dev, "gloo", MH_TIMEOUT, dict(
            along_y, NDSM_MH_PROBLEM="sine", NDSM_MH_N=str(n), NDSM_MH_AXES="z",
            NDSM_MH_MINROWS=str(MH_MINROWS), NDSM_MH_OUT=tmp), workdir=tmp)
        t_spawn = time.perf_counter() - t0
        same = [bool(np.array_equal(np.load(os.path.join(tmp, f"u{r}.npy")), u1))
                for r in range(2)]
    where = f"path 11c: ShardedPoissonBVP(axis_names=('z',)) {n}^3 Ax mixed, 2 ranks along y"
    for r, rep in enumerate(reps):
        check_counts(f"{where}, rank {r}", rep["launches"], rep["plain"], PATH5, ZY)
    log(f"[path 11c] {where}: u bitwise the one-process (2, 2) mesh on ranks 0, 1: {same}; "
        f"cycles {[rep['cycles'] for rep in reps]} / {i1.cycles}; max|u - exact| "
        f"{float(np.abs(u1 - exact).max()):.3e}; across processes {_sum(reps, 'traffic')}; "
        f"messages, bytes a rank {[rep['counts'] for rep in reps]}; warm wall: ranks "
        f"{_walls(reps)} s, one process {wall1:.4f} s; workers' call {t_spawn:.1f} s")
    if not all(same) or any(rep["cycles"] != i1.cycles for rep in reps) or any(
            rep["traffic"]["remote_messages"] for rep in reps):
        raise AssertionError(f"{where}: differs from the one-process run or crossed processes")
    del u1

    x, y, z, A_ex, b_ex = _CASES[n_vp]
    cyc4b = [s.cycles for s in info4b.chi + info4b.components]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        vreps = multihost.run_workers(2, 2, dev, "gloo", MH_TIMEOUT, dict(
            along_y, NDSM_MH_PROBLEM="vp", NDSM_MH_N=str(n_vp), NDSM_MH_AXES="z,y",
            NDSM_MH_OUT=tmp), workdir=tmp)
        t_spawn = time.perf_counter() - t0
        where = (f"path 11c: vector_potential {n_vp}^3 mixed, dist over a (2, 2) (z, y) mesh "
                 "of 2 gloo ranks along y")
        for r, rep in enumerate(vreps):
            with np.load(os.path.join(tmp, f"vp{r}.npz")) as f:
                A, B = f["A"], f["B"]
            ea = float(np.linalg.norm(A_ex - A, axis=0).max())
            eb = float(np.linalg.norm(b_ex - B, axis=0).max())
            digits = f"{ea:.5e} {eb:.5e}" == " ".join(f"{g:.5e}" for g in GOLDEN[n_vp])
            da, db = float(np.abs(A - A4b).max()), float(np.abs(B - B4b).max())
            log(f"[path 11c] rank {r}: Ea_max {ea:.5e} Eb_max {eb:.5e} (golden digits exact: "
                f"{digits}); max|A_mp - A_4b| {da}, max|B_mp - B_4b| {db}; cycles "
                f"{rep['cycles']} (path 4b: {cyc4b}); warm wall {rep['wall']:.4f} s (path 4b: "
                f"{wall4b:.4f} s, one process, 2 x 2 positions)")
            if rep["ierr"] or not digits or da != 0.0 or db != 0.0 or rep["cycles"] != cyc4b:
                raise AssertionError(f"{where}, rank {r}: not path 4b's result")
            del A, B
    check_counts(f"{where}, rank 0", vreps[0]["launches"], vreps[0]["plain"], PATH4B,
                 PATH4[:4])
    check_counts(f"{where}, rank 1", vreps[1]["launches"], vreps[1]["plain"], ZY + PATH8B,
                 PATH4[:4] + B1_B3)
    log(f"[path 11c] across processes {_sum(vreps, 'traffic')}; messages, bytes a rank "
        f"{[rep['counts'] for rep in vreps]}; workers' call {t_spawn:.1f} s")
    log(f"[path 11c] took {time.perf_counter() - t_path:.1f} s")
    return [rep["launches"] for rep in reps], [rep["launches"] for rep in vreps]


NATIVE_SOLVE_SIZES = (129, 257)  # 2^k + 1: the h^2 ratio's sizes
NATIVE_VP_SIZES = (22, 110)
# max|X_card - X_native| / max|X| for A and B of the mixed pipeline: the
# most measured on an H100 was 5.2e-12 (B at 110^3; PERF.md §6), from a
# starting bound of 1e-7.
NATIVE_REL = 1e-11
# bench.py's gate off the golden rows: errors = prefactor * dx^2 within 20%.
_EA_PREFAC = 1.86048e-03 / 4.76190e-02**2
_EB_PREFAC = 7.65805e-02 / 4.76190e-02**2


def _bench_gate(n, ea, eb):
    """bench.py's accuracy gate at n^3: (ok, Ea target, Eb target)."""
    if n in GOLDEN:
        g_ea, g_eb = GOLDEN[n]
        return abs(ea - g_ea) < GATE * g_ea and abs(eb - g_eb) < GATE * g_eb, g_ea, g_eb
    dx = 1.0 / (n - 1)
    g_ea, g_eb = _EA_PREFAC * dx**2, _EB_PREFAC * dx**2
    return abs(ea - g_ea) < 0.2 * g_ea and abs(eb - g_eb) < 0.2 * g_eb, g_ea, g_eb


def _host_cpu() -> str:
    """The host CPU as ``lscpu`` names it (and /proc/cpuinfo's model name,
    where lscpu has none)."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=60).stdout
    keys = ("Vendor ID", "Model name", "BIOS Model name", "CPU family", "Model", "CPU(s)")
    keep = [f"{k.strip()} {v.strip()}" for k, v in
            (ln.split(":", 1) for ln in out.splitlines() if ":" in ln) if k.strip() in keys]
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name")),
                         None)
        if model:
            keep.append(f"/proc/cpuinfo model name {model}")
    return "; ".join(keep) or "lscpu gave nothing"


def phase_native(smi, dev="cuda", solve_sizes=NATIVE_SOLVE_SIZES, vp_sizes=NATIVE_VP_SIZES):
    """[native]: the fp64 route and the mixed kernel path on the card held
    to the native C++/OpenMP core on the host (module docstring, 9).
    ``dev="cpu"`` and smaller sizes rehearse it on the CPU (no launch
    check there)."""
    import numpy as np
    import torch

    from ndsm_tpu_torch import Options, ops, solve_poisson_bvp, vector_potential
    from ndsm_tpu_torch.native import lib as nlib
    from ndsm_tpu_torch.native.potential import vector_potential_native
    from ndsm_tpu_torch.native.solver import solve_poisson_bvp_native
    from ndsm_tpu_torch.utils.testing import build_test_mesh, potential_field_case

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    so = nlib.build()
    t_build = time.perf_counter() - t0
    log(f"[native] core {os.path.relpath(so)} built and loaded in {t_build:.2f} s (g++ "
        f"{' '.join(nlib.CXX_FLAGS)}); OpenMP threads {nlib.nthreads()} (OMP_NUM_THREADS="
        f"{os.environ.get('OMP_NUM_THREADS', 'unset')}); host CPU {_host_cpu()}; card {smi}")
    walls = {}

    # (a) the fp64 route against the native solver.
    errs = {"card": {}, "native": {}}
    bcs = (("D", "D"),) * 3
    opts = Options(precision="fp64", smoother="masked", coarse_solver="relax")
    for n in solve_sizes:
        x = np.linspace(0.0, 1.0, n)
        s = np.sin(np.pi * x)
        ue = s[:, None, None] * s[None, :, None] * s[None, None, :]
        rhs = -3.0 * np.pi**2 * ue
        u0 = np.zeros_like(rhs)
        uc, ic, wall_c, launches, plain = _warm_solve(
            f"fp64 {n}^3", lambda: solve_poisson_bvp(u0, rhs, (x, x, x), bcs, options=opts,
                                                     device=dev))
        uc = uc.cpu().numpy()
        t0 = time.perf_counter()
        un, inn = solve_poisson_bvp_native(u0, rhs, (x, x, x), bcs, options=opts)
        walls[f"solve {n}^3"] = wall_n = time.perf_counter() - t0
        rel = float(np.abs(uc - un).max() / np.abs(un).max())
        errs["card"][n], errs["native"][n] = (float(np.abs(uc - ue).max()),
                                               float(np.abs(un - ue).max()))
        log(f"[native] (a) fp64 {n}^3 masked/relax: cycles card {ic.cycles} native {inn.cycles}; "
            f"max|u_card - u_native| / max|u| {rel:.3e} (bound 1e-11); max|u - u*| card "
            f"{errs['card'][n]:.6e} native {errs['native'][n]:.6e}; walls card {wall_c:.3f} s, "
            f"native {wall_n:.3f} s; kernel launches {sum(launches.values())}, plain versions "
            f"on the card {sum(plain.values())}")
        if inn.ierr or ic.cycles != inn.cycles or not rel <= 1e-11:
            raise AssertionError(f"[native] fp64 {n}^3: the card's solve is not the native "
                                 f"solve's (cycles {ic.cycles}/{inn.cycles}, rel {rel})")
        del uc, un, ue, rhs, u0
    for who in ("card", "native"):
        _order_check(f"[native] (a) fp64 {who}", errs[who], solve_sizes)

    # (b) the mixed kernel path against the native pipeline.
    for n in vp_sizes:
        x, y, z = build_test_mesh(n)
        Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
        A1, b1 = potential_field_case(X, Y, Z)
        del Z, Y, X
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        ierr_c, Ac, Bc, info_c = vector_potential(x, y, z, b1, device=dev, full_output=True)
        torch.cuda.synchronize()
        wall_c = time.perf_counter() - t0
        if dev != "cpu":
            check_counts(f"native (b) {n}^3 card", ops.launch_counts(), ops.plain_cuda_counts(),
                         PATH1)
        t0 = time.perf_counter()
        ierr_n, An, Bn, info_n = vector_potential_native(x, y, z, b1)
        walls[f"vector_potential {n}^3"] = wall_n = time.perf_counter() - t0
        gates = []
        for who, ierr, A, B in (("card", ierr_c, Ac, Bc), ("native", ierr_n, An, Bn)):
            ea = float(np.linalg.norm(A1 - A, axis=0).max())
            eb = float(np.linalg.norm(b1 - B, axis=0).max())
            ok, g_ea, g_eb = _bench_gate(n, ea, eb)
            gates.append(ok and ierr == 0)
            log(f"[native] (b) {n}^3 {who}: ierr {ierr} Ea_max {ea:.5e} (target {g_ea:.5e}) "
                f"Eb_max {eb:.5e} (target {g_eb:.5e}) bench gate {'pass' if ok else 'FAIL'}")
            if who == "native" and n == 22:
                golden = (abs(ea / 1.86048e-03 - 1) <= 1e-4 and abs(eb / 7.65805e-02 - 1) <= 1e-4)
                log(f"[native] (b) native 22^3 errors the golden values at rtol 1e-4: {golden}")
                gates.append(golden)
        rel_a = float(np.abs(Ac - An).max() / np.abs(An).max())
        rel_b = float(np.abs(Bc - Bn).max() / np.abs(Bn).max())
        names = [s.name for s in info_c.chi + info_c.components]
        cyc = ", ".join(f"{nm} {a.cycles}/{b.cycles}" for nm, a, b in
                        zip(names, info_c.chi + info_c.components, info_n.chi + info_n.components))
        log(f"[native] (b) {n}^3 mixed (default Options, lanes "
            f"{info_c.components[0].batch_size}): cycles card/native {cyc}")
        log(f"[native] (b) {n}^3 max|A_card - A_native| / max|A| {rel_a:.3e}, max|B_card - "
            f"B_native| / max|B| {rel_b:.3e} (bound {NATIVE_REL:.0e}); walls card {wall_c:.3f} s "
            f"(first call at this size), native {wall_n:.3f} s")
        if not all(gates) or not (rel_a <= NATIVE_REL and rel_b <= NATIVE_REL):
            raise AssertionError(f"[native] vector_potential {n}^3: gate {gates}, rel A {rel_a}, "
                                 f"rel B {rel_b}")
        del A1, b1, Ac, Bc, An, Bn
    log("[native] native walls (s, host CPU): "
        + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))
    log(f"[native] phase took {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import ndsm_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from ndsm_tpu_torch import ops

    t0 = time.perf_counter()
    seconds = {}

    def timed(phase, *args):
        """Run a phase and keep its seconds (printed at the end)."""
        t = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__] = round(time.perf_counter() - t, 1)
        return out

    name, smi = timed(phase_device)
    stats = Stats()
    timed(phase_kernels, stats)
    timed(phase_pass_widths)
    timed(phase_compact_kernels, stats)
    timed(phase_sharded_kernels, stats)
    timed(phase_diffusion_kernels, stats)
    path1, path1b, path3, path3b, ref1b = timed(phase_main_path)
    path2 = timed(phase_neumann_3d)
    path4, path4b, ref4, ref4b = timed(phase_dist_paths, ref1b)
    path5, path5b, path5c, u5 = timed(phase_sharded_solves)
    path11, path11b, path12 = timed(phase_multiprocess, ref4, u5)
    del ref4, u5
    path6, path7b = timed(phase_operator_paths)
    t_new = time.perf_counter()
    timed(phase_sharded_operators)
    path13c = timed(phase_sharded_drivers)
    path11c = timed(phase_ranks_along_y, ref4b)
    del ref4b
    log(f"[new] paths 13, 13b, 13c and 11c took {time.perf_counter() - t_new:.1f} s")
    path8 = timed(phase_golden_tables)
    path8b = timed(phase_2d_study)
    path9 = timed(phase_host_curl)
    path10 = timed(phase_per_face)
    timed(phase_profiling)
    timed(phase_native, smi)
    log("[seconds] by phase: " + json.dumps(seconds))
    paths = (
        (PATH1, path1, "vector_potential 220^3 mixed (components batched)"),
        (PATH1B, path1b, "vector_potential 220^3 mixed, batch_components=off"),
        (PATH2, path2, "all-Neumann 3D solve 256^3"),
        (PATH3, path3, "vector_potential 220^3 mixed, smoother=compact (components batched)"),
        (PATH3B, path3b, "vector_potential 220^3 mixed, smoother=compact, "
                         "batch_components=off"),
        (PATH4, path4, "vector_potential 220^3 mixed, dist over 2 shards on one card"),
        (PATH5, path5, "ShardedPoissonBVP 256^3 Ax mixed over 4 shards on one card"),
        (PATH4B, path4b, "vector_potential 220^3 mixed, dist over a 2 x 2 (z, y) mesh on one "
                         "card"),
        (PATH5B, path5b, "ShardedPoissonBVP 256^3 Ax mixed over a 4 x 2 (z, y) mesh on one "
                         "card"),
        (PATH6, path6, "solve_poisson_bvp 257^3 Ax mixed"),
        (DIFFUSION, path7b, "solve_poisson_bvp 257^3 DDD mixed, DiffusionOperator(1 + x y z)"),
        (PATH1, path8, "both golden tables, integration_scaling --warm, 22^3-220^3"),
        (PATH8B, path8b, "unit_test_2d_solve, 27x36-675x900 mixed"),
        (PATH1, path9, "vector_potential 220^3 mixed, host_curl"),
        (PATH1B, path10, "vector_potential 220^3 mixed, per_face"),
        (PATH5, path5c, "ShardedPoissonBVP.solve_checkpointed 256^3 Ax mixed over 4 shards, "
                        "every 4 and 32"),
        (PATH5B, path11[0], "ShardedPoissonBVP 256^3 Ax mixed over a (2, 2) mesh of 2 gloo "
                            "ranks on one card, rank 0 (the root's)"),
        (ZY, path11[1], "ShardedPoissonBVP 256^3 Ax mixed over a (2, 2) mesh of 2 gloo ranks "
                        "on one card, rank 1"),
        (PATH4, path11b[0], "vector_potential 220^3 mixed, dist over a z mesh of 2 gloo ranks "
                            "on one card, rank 0 (the root's)"),
        (PATH4[:4], path11b[1], "vector_potential 220^3 mixed, dist over a z mesh of 2 gloo "
                                "ranks on one card, rank 1"),
        (PATH5, path12, "PoissonBVP(shard_spec=ShardSpec(4 shards)) 256^3 Ax mixed"),
    ) + tuple((need, counts, f"PoissonBVP(shard_spec=ShardSpec(4 shards)).{name}, Ax fp32")
              for name, (need, counts) in path13c.items()) + (
        (PATH5, path11c[0][0], "ShardedPoissonBVP(axis_names=('z',)) 256^3 Ax mixed on a "
                               "(2, 2) mesh of 2 gloo ranks along y, rank 0 (its own z line)"),
        (PATH5, path11c[0][1], "ShardedPoissonBVP(axis_names=('z',)) 256^3 Ax mixed on a "
                               "(2, 2) mesh of 2 gloo ranks along y, rank 1 (its own z line)"),
        (PATH4B, path11c[1][0], "vector_potential 220^3 mixed, dist over a (2, 2) (z, y) mesh "
                                "of 2 gloo ranks along y, rank 0 (the root's)"),
        (ZY + PATH8B, path11c[1][1], "vector_potential 220^3 mixed, dist over a (2, 2) (z, y) "
                                     "mesh of 2 gloo ranks along y, rank 1"),
    )
    kernels = []
    for key, _, _, replaces, source in ops.KERNELS:
        st = stats.s[key]
        _, counts, path = next(p for p in paths if key in p[0])
        kernels.append({
            "name": key,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": counts[key],
            "max_abs_err": st["err"],
            "ms": st["ms"],
            "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"],
            "library_ms": None,
            "path": path,
            "launches_by_path": {p[2]: p[1][key] for p in paths if key in p[0]},
        })
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
