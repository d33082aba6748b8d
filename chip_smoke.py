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
         2x3x5; at 220^3 timed against the previous design (2*ns
         half-sweep launches + a residual launch) in turns, with device
         busy times and the share of the bound ("[design]");
       - the lane forms (the three forms on the three component lanes
         stacked) at every level of path 1 (220^3 down to 6^3) and 2x3x5,
         also against three per-lane zc kernel calls and with the Az lane
         frozen; at 220^3 and 110^3 timed, and against the previous design
         in turns;
       - the pass plan's measurements ("[width]"): at every level, three
         lanes, the half-sweeps, the plan as fixed and marching passes of
         width 1, 2 and 3 (device busy time, each bitwise);
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
       - the defect's z-marching tile against the previous design (one
         thread a point) in turns at 220^3, zero-rhs + update ("[design]");
       - the all-Neumann 3D smoother (one launch a call: a cooperative
         grid, or one block for a level that fits its shared memory), each
         shape's plan printed ("[mean plan]"), bitwise at every level of
         the 128^3 and 256^3 hierarchies, 220^3, 33^3 and 65x64x63, ns 1, 2
         and 5, on the plan's route and on the grid route where the plan
         takes the block route; timed at 220^3, 128^3, 256^3 and 16^3 with
         each call's host enqueue and device events (more than one device
         event a call fails the phase), and against the previous
         design (4 ns + 1 launches) in turns at 256^3, 128^3, 32^3 and 16^3
         ("[design]");
       - the colour-split smoother (compact_smooth_3d: ceil(ns / w)
         launches of the halves form of the pass, "[compact plan]" lines
         for every level of path 3) with its split and merge passes at
         220^3, 110^3, 55^3 and 221x220x221 (odd nx), three component BC
         sets: halves against the plain version (ghosts included), merged
         against the dense kernel zc_smooth_3d, the split and merge as an exact round
         trip; the lane form on the three stacked lanes at 220^3 and 110^3
         against three one-lane calls and with the Az lane frozen; the
         whole dense-interface call (split, sweeps, merge) timed beside
         zc_smooth_3d; at 220^3 (one lane, three lanes) the pass against
         the previous design (2 ns half-sweep launches) in turns
         ("[design]").
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
     of paths 4 and 4b (shard 0 with its halo), and against the previous
     design (2 ns half-sweep launches + 1 residual launch, also held
     bitwise to the pass) in turns ("[design]").  B11/B11y are one launch
     of the shard form of the defect's z-marching tile, timed there too
     and against the previous design (one thread a point of the extended
     block, also held bitwise to the tile) in turns ("[design]").
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
     within 1, max|u_sh - u| <= 5e-9).
  5. the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

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


def device_ms_split(first, second, name, reps: int = 5, first_name=None):
    """Device busy ms and events of one ``first()`` and one ``second()``,
    as ``device_ms``, from one profile over ``reps`` calls of
    each: the events whose kernel name holds ``name`` are ``second``'s,
    the rest ``first``'s (with ``first_name``: only those whose name holds
    it; the calls' other kernels, such as a reduction both launch, are
    then left out)."""
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
        parts = [[e for e in dev if (name in e.key) == mine
                  and (mine or first_name is None or first_name in e.key)]
                 for mine in (False, True)]
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


def previous_sweeps(u, cor, rhs, dq, bcs_list, ns, residual=False):
    """The 3D red-black lane kernels' previous design (PRs 1-6), for
    timing beside the pass: 2*ns half-sweep launches over the (B, nz, ny,
    nx) stack, the first out of place (reading u + cor), then one residual
    launch.  Returns u' (and r)."""
    import torch

    from ndsm_tpu_torch.ops import stencils, zc
    from ndsm_tpu_torch.utils import cuda_build

    lib = cuda_build.kernels()
    nb, nz, ny, nx = (int(s) for s in u.shape)
    (wz, wy, wx), w0 = stencils.stencil_weights(dq, torch.float32)
    color, dmask, act = zc._lane_args(bcs_list, (True,) * nb)
    out = torch.empty_like(u)
    stream = torch.cuda.current_stream().cuda_stream
    rcs = [lib.ndsm_lane_half_oop_f32(
        u.data_ptr(), None if cor is None else cor.data_ptr(), None, rhs.data_ptr(),
        out.data_ptr(), nb, nz, ny, nx, color, dmask, act, wz, wy, wx, w0, stream)]
    for k in range(1, 2 * ns):
        rcs.append(lib.ndsm_lane_half_inplace_f32(
            out.data_ptr(), rhs.data_ptr(), nb, nz, ny, nx, color, dmask, act, k % 2,
            wz, wy, wx, w0, stream))
    if not residual:
        cuda_build.check(max(rcs), "previous design")
        return out
    r = torch.empty_like(u)
    rcs.append(lib.ndsm_lane_residual_f32(out.data_ptr(), rhs.data_ptr(), r.data_ptr(), nb, nz,
                                          ny, nx, dmask, act, wz, wy, wx, stream))
    cuda_build.check(max(rcs), "previous design")
    return out, r


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


def compare_kernel_designs(key, label, pts, plain, previous, kern, name, first_name=None,
                           ns=MS, work=None):
    """A kernel beside its previous design on the same inputs, timed in
    turns (plain, previous, new, new, previous, plain; CUDA events, min of
    two medians), then each design's device busy time under torch.profiler
    (the events whose name holds ``name`` are the new kernel's, those
    holding ``first_name`` the previous one's), the host's enqueue time of
    a call of each, and the share of the bound (``work`` as in ``bound``)."""
    t = [time_ms(f) for f in (plain, previous, kern, kern, previous, plain)]
    pms, oms, kms = min(t[0], t[5]), min(t[1], t[4]), min(t[2], t[3])
    (obusy, oev), (kbusy, kev) = device_ms_split(previous, kern, name, first_name=first_name)
    bms, by = bound(key, pts, ns, work)
    ohost, khost = enqueue_ms(previous), enqueue_ms(kern)
    log(f"[design] {key:32s} {label}: previous {oms:.4f} ms, busy {obusy:.4f} ms ({oev:.0f} "
        f"events, host enqueue {ohost:.4f} ms a call); new {kms:.4f} ms, busy {kbusy:.4f} ms "
        f"({kev:.0f} events, host enqueue {khost:.4f} ms); busy "
        f"{obusy / kbusy:.2f}x, events {oms / kms:.2f}x faster; plain {pms:.4f} ms; bound "
        f"{bms:.4f} ms ({by}) = {100 * bms / kbusy:.1f}% of the new busy time, "
        f"{100 * bms / obusy:.1f}% of the previous; new faster: {kbusy < obusy}")


def compare_designs(key, label, shape, nb, plain, previous, kern):
    """The pass beside the previous design on the same inputs, timed in
    turns (plain, previous, pass, pass, previous, plain; CUDA events, min
    of two medians), then each design's device busy time under
    torch.profiler, and the share of the bound."""
    from ndsm_tpu_torch.ops import zc

    pts = nb * math.prod(shape)
    t = [time_ms(f) for f in (plain, previous, kern, kern, previous, plain)]
    pms, oms, kms = min(t[0], t[5]), min(t[1], t[4]), min(t[2], t[3])
    (obusy, oev), (kbusy, kev) = device_ms_split(previous, kern, "lane_pass")
    bms, by = bound(key, pts, MS)
    res = "residual" in key
    plan = zc.pass_plan(shape, MS, nb, res)
    log(f"[design] {key:32s} {label}: previous ({2 * MS}{' + 1' if res else ''} launches) "
        f"{oms:.4f} ms, busy {obusy:.4f} ms ({oev:.0f} events); pass ({len(plan)} launches, "
        f"widths {[p.width for p in plan]}) {kms:.4f} ms, busy {kbusy:.4f} ms ({kev:.0f} "
        f"events); busy {obusy / kbusy:.2f}x, events {oms / kms:.2f}x faster; plain "
        f"{pms:.4f} ms; bound {bms:.4f} ms ({by}) = {100 * bms / kbusy:.1f}% of the pass's busy "
        f"time, {100 * bms / obusy:.1f}% of the previous design's; pass faster: "
        f"{kbusy < obusy}")


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
            for form, r_, e_ in (("zero-rhs", None, None), ("rhs", rhs64, None),
                                 ("zero-rhs+update", None, e32), ("rhs+update", rhs64, e32)):
                got = df.df_residual_3d(u64, r_, e_, dq, bcs)
                want = df.df_residual_3d_plain(u64, r_, e_, dq, bcs)
                for part, g, w in zip(("r32", "max", "u"), got, want):
                    stats.note("df_residual_3d", *compare(
                        f"df_residual_3d {form} ({part}) {n}^3 {tag}", g, w))
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
            for form, r_, e_ in (("zero-rhs", None, None), ("rhs", rhs64, None),
                                 ("zero-rhs+update", None, e32), ("rhs+update", rhs64, e32)):
                got = df.df_residual_3d(u64, r_, e_, dq, bcs)
                want = df.df_residual_3d_plain(u64, r_, e_, dq, bcs)
                for part, g, w in zip(("r32", "max", "u"), got, want):
                    stats.note("df_residual_3d", *compare(
                        f"df_residual_3d {form} ({part}) {shape} {tag}", g, w))
        log(f"[kernels] {shape}: defect bitwise equal to its plain version (three BC sets, "
            f"zero-rhs/rhs/update)")
        del u64, rhs64, e32

    # -- the one-lane calls at odd nz and on the small levels: path 1b's
    # 55^3, 27^3, 13^3 and 6^3 levels, the shape class the JAX package sends
    # to fused_smooth_3d (221 x 220 x 220), and the smallest extents (2, 3, 5)
    small = [(h.shapes[l], h.dq[l]) for l in range(2, h.ngrids)] + [((2, 3, 5), h.dq[0])]
    for shape, dq in small[:1] + [((221, 220, 220), h.dq[0])] + small[1:]:
        for tag, bcs in BC_SETS.items():
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
        log(f"[kernels] {shape}: one-lane calls (zc_smooth_3d = fused_smooth_3d, residual, "
            f"correction) bitwise equal to their plain versions (three BC sets, ns in {SWEEPS})")
        del u, rhs, cor

    # -- the one-lane calls against the previous design, in turns (220^3)
    shape, dq = h.shapes[0], h.dq[0]
    u, rhs, cor = f32(shape), f32(shape), f32(shape)
    bcs = BC_SETS["Ax"]
    one = ((bcs,), u[None], rhs[None], cor[None])
    compare_designs(
        "zc_smooth_3d", "220^3 Ax", shape, 1,
        lambda: zc.zc_smooth_3d_plain(u, rhs, dq, bcs, MS),
        lambda: previous_sweeps(one[1], None, one[2], dq, one[0], MS),
        lambda: zc.zc_smooth_3d(u, rhs, dq, bcs, MS))
    compare_designs(
        "zc_smooth_residual_3d", "220^3 Ax", shape, 1,
        lambda: zc.zc_smooth_residual_3d_plain(u, rhs, dq, bcs, MS),
        lambda: previous_sweeps(one[1], None, one[2], dq, one[0], MS, residual=True),
        lambda: zc.zc_smooth_residual_3d(u, rhs, dq, bcs, MS))
    compare_designs(
        "zc_smooth_cor_3d", "220^3 Ax", shape, 1,
        lambda: zc.zc_smooth_cor_3d_plain(u, cor, rhs, dq, bcs, MS),
        lambda: previous_sweeps(one[1], one[3], one[2], dq, one[0], MS),
        lambda: zc.zc_smooth_cor_3d(u, cor, rhs, dq, bcs, MS))
    del u, rhs, cor, one

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
        # the pass beside the previous design's half-sweep launches
        compare_designs(
            "fused_smooth_3d_batched", lab, shape, 3,
            lambda: fused.fused_smooth_3d_batched_plain(u, rhs, dq, lanes, MS),
            lambda: previous_sweeps(u, None, rhs, dq, lanes, MS),
            lambda: fused.fused_smooth_3d_batched(u, rhs, dq, lanes, MS))
        compare_designs(
            "fused_smooth_residual_3d_batched", lab, shape, 3,
            lambda: fused.fused_smooth_residual_3d_batched_plain(u, rhs, dq, lanes, MS),
            lambda: previous_sweeps(u, None, rhs, dq, lanes, MS, residual=True),
            lambda: fused.fused_smooth_residual_3d_batched(u, rhs, dq, lanes, MS))
        compare_designs(
            "fused_smooth_cor_3d_batched", lab, shape, 3,
            lambda: fused.fused_smooth_cor_3d_batched_plain(u, cor, rhs, dq, lanes, MS),
            lambda: previous_sweeps(u, cor, rhs, dq, lanes, MS),
            lambda: fused.fused_smooth_cor_3d_batched(u, cor, rhs, dq, lanes, MS))
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
    # 220^2 and 512^2, all-Neumann, in turns; and the defect's tile beside
    # one thread a point at 220^3 (zero-rhs + update, the path's form)
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

    shape, dq, bcs = h.shapes[0], h.dq[0], BC_SETS["Ax"]
    zz, yy, xx = np.meshgrid(*h.meshes[0], indexing="ij")
    u64 = torch.as_tensor(np.sin(2.1 * zz + 0.3) * np.cos(1.7 * yy) * np.sin(2.9 * xx + 1.1),
                          dtype=torch.float64, device=dev)
    del zz, yy, xx
    e32 = 1e-4 * f32(shape)
    compare_kernel_designs(
        "df_residual_3d", "220^3 Ax zero-rhs+update (the kernels alone, not the wrapper's max)",
        int(np.prod(shape)), lambda: df.df_residual_3d_plain(u64, None, e32, dq, bcs),
        lambda: df._defect_cuda(u64, None, e32, dq, bcs, previous=True),
        lambda: df._defect_cuda(u64, None, e32, dq, bcs), "defect_tile",
        first_name="defect_point", ns=1)
    del u64, e32

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
    call's host enqueue and device events (more than one a call fails);
    against the previous design (4 ns + 1
    launches a call) in turns at 256^3, 128^3, 32^3 and 16^3
    ("[design]")."""
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
    for n in (256, 128, 32, 16):
        u, rhs, dq = data[(n, n, n)]
        compare_kernel_designs(
            "zc_smooth_mean_3d", f"{n}^3 ns={MS} ({zc.mean_plan(u.shape).route} route)", n**3,
            lambda: zc.zc_smooth_mean_3d_plain(u, rhs, dq, ALL_N_3D, MS),
            lambda: zc._mean_sweeps_cuda(u, rhs, dq, ALL_N_3D, MS, previous=True),
            lambda: zc.zc_smooth_mean_3d(u, rhs, dq, ALL_N_3D, MS), "mean_")
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
                if shape[0] == 220 and tag == "Ax":
                    compare_compact(stats, "compact_smooth_3d", lab, (R[None], B[None]),
                                    (rR[None], rB[None]), dq, (bcs,), nx)
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
        if head:
            compare_compact(stats, "compact_smooth_3d_batched", lab, (R, B), (rR, rB), dq, lanes,
                            nx)
        del u, rhs, cor, R, B, rR, rB


def compare_compact(stats, key, label, halves_, rhs_, dq, bcs_list, nx):
    """At ns = MS on a (B, nz, ny, hx) stack of halves: the pass against
    the previous design (2*MS half-sweep launches, held bitwise to it) in
    turns ("[design]")."""
    from ndsm_tpu_torch.ops import compact

    R, B = halves_
    rR, rB = rhs_
    nb = int(R.shape[0])
    pts = nb * int(R.shape[1] * R.shape[2]) * nx
    act = (True,) * nb
    new = lambda: compact._sweeps_cuda(R, B, rR, rB, dq, bcs_list, MS, nx, act, key)  # noqa: E731
    prev = lambda: compact._sweeps_cuda(R, B, rR, rB, dq, bcs_list, MS, nx, act, key,  # noqa: E731
                                        previous=True)
    plain = lambda: compact.compact_smooth_3d_batched_plain(  # noqa: E731
        R, B, rR, rB, dq, bcs_list, MS, nx)
    for part, g, w in zip("RB", prev(), new()):
        compare(f"{key}({part}) {label}: previous design vs the pass", g, w)
    plan = compact.compact_plan((int(R.shape[1]), int(R.shape[2]), nx), MS, nb)
    compare_kernel_designs(key, f"{label} ({2 * MS} half-sweeps against {len(plan)} passes, "
                           f"widths {[p.width for p in plan]})", pts, plain, prev, new,
                           "lane_pass", first_name="compact_half")


def phase_pass_widths():
    """The measurements behind ``zc.pass_plan``'s rule: at every level of
    the 220^3 hierarchy, three component lanes, ns = MS, smoothing form,
    the device busy time of the previous design's half-sweeps, of the plan
    as fixed, and of marching passes of width 1, 2 and 3 (and the resident
    pass where a lane fits whole); every result bitwise against the
    half-sweeps'."""
    import numpy as np
    import torch

    from ndsm_tpu_torch.ops import zc

    h = hierarchy_of(220)
    lanes = tuple(BC_SETS.values())
    rng = np.random.default_rng(2027)
    act = (True,) * 3
    for level, shape in enumerate(h.shapes):
        dq = h.dq[level]
        u, rhs = (torch.as_tensor(rng.standard_normal((3,) + shape), dtype=torch.float32,
                                  device="cuda") for _ in range(2))
        prev = lambda: previous_sweeps(u, None, rhs, dq, lanes, MS)  # noqa: E731
        want = prev()
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
            (pb, _), (kb, _) = device_ms_split(prev, run, "lane_pass")
            kind = "resident" if plan[0].resident else "marching"
            cells.append(f"{tag} ({kind}, {len(plan)} launches) {kb:.4f} ms")
        log(f"[width] {'x'.join(map(str, shape))} x3 ns={MS} smoothing, device busy: previous "
            f"design ({2 * MS} launches) {pb:.4f} ms; " + "; ".join(cells))
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
    """The 3D red-black kernel launches of a warm call: the wrapper calls,
    the pass launches behind them, and what the previous design launched
    for the same calls at ns = MS (2*MS half-sweeps a call, +1 for a
    residual)."""
    calls = sum(launches[k] for k in keys)
    prev = sum(launches[k] * (2 * MS + ("residual" in k)) for k in keys)
    log(f"[{what}] 3D red-black smoothing: {calls} wrapper calls, {passes} pass launches "
        f"({passes / max(calls, 1):.2f} a call); the previous design: {prev} launches")
    if calls and not passes:
        raise AssertionError(f"{what}: the pass kernel never launched")


def log_compact_passes(what, launches, passes, dense_passes, key):
    """The colour-split smoother's launches of a warm call: the wrapper
    calls, the pass launches behind them (its own counter), what the
    previous design launched for the same calls (2*MS half-sweeps a call);
    the compact passes must be there, the dense pass's must not."""
    calls = launches[key]
    log(f"[{what}] colour-split smoothing: {calls} {key} calls, {passes} compact pass "
        f"launches ({passes / max(calls, 1):.2f} a call); the previous design: "
        f"{2 * MS * calls} half-sweeps; dense pass launches {dense_passes}")
    if not passes or dense_passes:
        raise AssertionError(f"{what}: {passes} compact pass launches, {dense_passes} dense "
                             "pass launches")


_CASES = {}


def run(n, batch="auto", smoother="auto", dist=None):
    """One ``vector_potential`` call on the analytic case at n^3 (mixed
    precision), held to the golden row; returns (wall s, info, A, B)."""
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
        options=Options(precision="mixed", batch_components=batch, smoother=smoother))
    wall = time.perf_counter() - t0
    if ierr != 0:
        raise AssertionError(f"vector_potential {n}^3: ierr={ierr}")
    if not (np.isfinite(A2).all() and np.isfinite(B2).all()):
        raise AssertionError(f"vector_potential {n}^3: non-finite output")
    if A2.shape != (3, n, n, n) or A2.dtype != np.float64:
        raise AssertionError(f"vector_potential {n}^3: got {A2.shape} {A2.dtype}")
    ea = float(np.linalg.norm(A1 - A2, axis=0).max())
    eb = float(np.linalg.norm(b1 - B2, axis=0).max())
    g_ea, g_eb = GOLDEN[n]
    ok = abs(ea - g_ea) < GATE * g_ea and abs(eb - g_eb) < GATE * g_eb
    cyc = " ".join(f"{s.name}={s.cycles}" for s in info.chi + info.components)
    phases = " ".join(f"{k}={v:.4f}" for k, v in info.phases.items())
    route = (f"batch_components={batch}, smoother={smoother}, lanes "
             f"{info.components[0].batch_size}"
             + ("" if dist is None else f", dist over a {'x'.join(map(str, dist.mesh.shape))} "
                f"{dist.axis_names} mesh"))
    digits = f"{ea:.5e} {eb:.5e}" == f"{g_ea:.5e} {g_eb:.5e}"
    log(f"[main] {n}^3 mixed ({route}): Ea_max {ea:.5e} (golden {g_ea:.5e})  Eb_max "
        f"{eb:.5e} (golden {g_eb:.5e})  gate {'pass' if ok else 'FAIL'}, golden digits "
        f"exact: {digits}")
    log(f"[main] {n}^3 wall {wall:.4f} s; phases (s) {phases}; cycles {cyc}; component "
        "du " + " ".join(f"{s.name}={s.du_last:.6e}" for s in info.components))
    if not ok or (dist is not None and not digits):
        raise AssertionError(f"vector_potential {n}^3 outside the golden gate"
                             + ("" if dist is None else " or its digits"))
    want = 3 if batch == "auto" and dist is None else 1
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
    holds ``name`` against the wrapper's ``calls`` of the counted run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
                    for e in top))


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
    from ndsm_tpu_torch.ops import df_sharded, zc, zc_sharded

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
        # the one-launch pass against the previous design (2 ns half-sweep
        # launches over the whole block, + 1 residual launch), in turns
        pos = cut.where_args(0, H=H)
        offsets, extents, halos = pos if cut.zy else ((pos[0],), (pos[1],), (pos[2],))
        prev = lambda: zc_sharded._smooth_cuda(ue, re, dq, bcs, ns, offsets, extents, halos,
                                               res, key, previous=True)  # noqa: E731
        for part, g, w in zip("ur", (prev() if res else (prev(),)),
                              (fn(ue, re, *args) if res else (fn(ue, re, *args),))):
            compare(f"{key}({part}) previous design vs the pass", g, w)
        p = zc.shard_pass_plan(ue.shape, (halos + (0,))[:2], ns, res)
        compare_kernel_designs(
            key, f"{lab} (+{H} halo) ns={ns} (pass tile {p.tile}, window {p.window}, grid "
            f"{p.grid})", real, lambda: plain(ue, re, *args), prev, lambda: fn(ue, re, *args),
            "lane_pass", first_name="shard_", ns=ns, work=work)
    ext = ue64[0].numel()
    pos = cut.where_args(0)
    offsets, extents = (pos if cut.zy else ((pos[0],), (pos[1],)))
    real_shape = tuple(n - 2 for n in ue64[0].shape[:len(offsets)]) + tuple(
        ue64[0].shape[len(offsets):])
    for base, e, work in (
            ("df_residual_sharded_3d", None, (8 * ext + 4 * real, 14 * real, PEAK_F64)),
            ("df_update_residual_sharded_3d", ee[0],
             (20 * ext + 4 * real, 14 * real + ext, PEAK_F64))):
        key = cut.key(base)
        fn, plain = getattr(df_sharded, key), getattr(df_sharded, key + "_plain")
        args = (ue64[0], None) + (() if e is None else (e,)) + (dq, bcs) + pos
        stats.timed(key, lambda: fn(*args), lambda: plain(*args), real, 1,
                    f"{lab} (+1 halo) zero-rhs", True, work=work)
        # the tile against the previous design (one thread a point), in turns
        prev = lambda: df_sharded._defect_cuda(ue64[0], None, e, dq, bcs, offsets,  # noqa: E731
                                               extents, real_shape, key, previous=True)
        for part, g, w in zip(("r32", "max", "u"), prev(), fn(*args)):
            compare(f"{key} ({part}) previous design vs the tile", g, w)
        compare_kernel_designs(key, f"{lab} (+1 halo) zero-rhs", real, lambda: plain(*args),
                               prev, lambda: fn(*args), "defect_tile_f64",
                               first_name="defect_sharded_f64", ns=1, work=work)


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
    launches, A = {}, {}
    for tag, dist in dists.items():
        where = f"path {tag}: 220^3 warm, dist over a {'x'.join(map(str, dist.mesh.shape))} mesh"
        run(22, dist=dist)
        run(220, dist=dist)  # cold: first use of the sharded engines
        ops.reset_launch_counts()
        sm_engine.reset_plain_route_counts()
        C.reset_counts()
        wall, info, A[tag], _ = run(220, dist=dist)
        torch.cuda.synchronize()
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
    return launches["4"], launches["4b"]


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
        del sb, u_sh
    return launches["5"], launches["5b"]


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
    name, _ = phase_device()
    stats = Stats()
    phase_kernels(stats)
    phase_pass_widths()
    phase_compact_kernels(stats)
    phase_sharded_kernels(stats)
    path1, path1b, path3, path3b, ref1b = phase_main_path()
    path2 = phase_neumann_3d()
    path4, path4b = phase_dist_paths(ref1b)
    path5, path5b = phase_sharded_solves()
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
