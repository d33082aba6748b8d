#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ndsm_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):

  1. device: the card's name and ``nvidia-smi`` name/power limit; the
     kernels are built from ``ndsm_tpu_torch/csrc`` and the build timed.
  2. kernels: each CUDA kernel wrapper against its plain PyTorch version
     on the card, at the main path's 220^3 and 110^3 float32 levels
     (float64 for the defect), for the three component BC sets; bitwise
     agreement is required.  Each kernel is timed beside its plain
     version (CUDA events, warm, median of 7).
  3. main path: ``vector_potential`` in mixed precision on the analytic
     potential-field case at 22^3 and 220^3, checked against the golden
     rows (bench.py's gate: |err - golden| < 2e-3 golden); the launch
     counters are zeroed before the warm 220^3 run and every kernel must
     have launched during it, with no plain version run on the card.
     One more 220^3 run under torch.profiler gives the device busy time
     and the kernels that take it.
  4. the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

Imports only the port, torch, numpy and the standard library.
"""

import json
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
SWEEPS = (1, 2, 5)
REPS = 7


def log(msg: str) -> None:
    print(msg, flush=True)


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
        f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)})")
    return name, smi


def phase_kernels():
    """Parity and timing of every kernel wrapper at the main path's shapes."""
    import numpy as np
    import torch

    from ndsm_tpu_torch.grids import GridHierarchy
    from ndsm_tpu_torch.ops import df, zc
    from ndsm_tpu_torch.utils.testing import build_test_mesh

    dev = torch.device("cuda")
    h = GridHierarchy.from_mesh(build_test_mesh(220)[::-1])
    rng = np.random.default_rng(2024)
    stats = {k: {"err": 0.0, "ulp": 0.0, "ms": {}, "plain_ms": {}} for k in
             ("zc_smooth_3d", "zc_smooth_residual_3d", "zc_smooth_cor_3d", "df_residual_3d")}

    def f32(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    def note(key, err, ulp):
        stats[key]["err"] = max(stats[key]["err"], err)
        stats[key]["ulp"] = max(stats[key]["ulp"], ulp)

    for level in (0, 1):
        shape, dq = h.shapes[level], h.dq[level]
        n = shape[0]
        for tag, bcs in BC_SETS.items():
            u, rhs, cor = f32(shape), f32(shape), f32(shape)
            for ns in SWEEPS:
                note("zc_smooth_3d", *compare(
                    f"zc_smooth_3d {n}^3 {tag} ns={ns}",
                    zc.zc_smooth_3d(u, rhs, dq, bcs, ns),
                    zc.zc_smooth_3d_plain(u, rhs, dq, bcs, ns)))
                got_u, got_r = zc.zc_smooth_residual_3d(u, rhs, dq, bcs, ns)
                want_u, want_r = zc.zc_smooth_residual_3d_plain(u, rhs, dq, bcs, ns)
                note("zc_smooth_residual_3d", *compare(
                    f"zc_smooth_residual_3d(u) {n}^3 {tag} ns={ns}", got_u, want_u))
                note("zc_smooth_residual_3d", *compare(
                    f"zc_smooth_residual_3d(r) {n}^3 {tag} ns={ns}", got_r, want_r))
                note("zc_smooth_cor_3d", *compare(
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
                    note("df_residual_3d", *compare(
                        f"df_residual_3d {form} ({part}) {n}^3 {tag}", g, w))
            log(f"[kernels] {n}^3 {tag}: all kernels bitwise equal to their plain "
                f"versions (ns in {SWEEPS}; defect zero-rhs/rhs/update)")

            # Timing at the main path's configuration (ms=5, zero-rhs update).
            ms = 5
            runs = {
                "zc_smooth_3d": (lambda: zc.zc_smooth_3d(u, rhs, dq, bcs, ms),
                                 lambda: zc.zc_smooth_3d_plain(u, rhs, dq, bcs, ms)),
                "zc_smooth_residual_3d": (
                    lambda: zc.zc_smooth_residual_3d(u, rhs, dq, bcs, ms),
                    lambda: zc.zc_smooth_residual_3d_plain(u, rhs, dq, bcs, ms)),
                "zc_smooth_cor_3d": (
                    lambda: zc.zc_smooth_cor_3d(u, cor, rhs, dq, bcs, ms),
                    lambda: zc.zc_smooth_cor_3d_plain(u, cor, rhs, dq, bcs, ms)),
                "df_residual_3d": (
                    lambda: df.df_residual_3d(u64, None, e32, dq, bcs),
                    lambda: df.df_residual_3d_plain(u64, None, e32, dq, bcs)),
            }
            for key, (kern, plain) in runs.items():
                # plain, kernel, kernel, plain: compare within one call
                p1, k1, k2, p2 = time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain)
                kms, pms = min(k1, k2), min(p1, p2)
                stats[key]["ms"].setdefault(n, {})[tag] = kms
                stats[key]["plain_ms"].setdefault(n, {})[tag] = pms
                what = ("zero-rhs+update" if key == "df_residual_3d" else
                        f"ms=5 sweeps, {n**3 * ms / kms / 1e6:.1f} G point-sweeps/s")
                log(f"[time] {key:22s} {n}^3 {tag}: kernel {kms:.4f} ms  plain "
                    f"{pms:.4f} ms  ({what})")
    log("[kernels] max difference from the plain version, in ulps of max|plain|: "
        + ", ".join(f"{k} {v['ulp']:.1f}" for k, v in stats.items()))
    # Device-to-device copy bandwidth: the card's practical memory roof.
    big = torch.empty(2**27, dtype=torch.float32, device=dev)
    dst = torch.empty_like(big)
    cms = time_ms(lambda: dst.copy_(big))
    log(f"[time] device-to-device copy of 512 MiB: {cms:.4f} ms = "
        f"{2 * big.numel() * 4 / cms / 1e6:.1f} GB/s (read + write)")
    del big, dst
    return stats


def phase_main_path():
    import numpy as np
    import torch

    from ndsm_tpu_torch import ops, vector_potential
    from ndsm_tpu_torch.utils.testing import build_test_mesh, potential_field_case

    def run(n):
        x, y, z = build_test_mesh(n)
        Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
        A1, b1 = potential_field_case(X, Y, Z)
        t0 = time.perf_counter()
        ierr, A2, B2, info = vector_potential(
            x, y, z, b1, precision="mixed", device="cuda", full_output=True)
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
        log(f"[main] {n}^3 mixed: Ea_max {ea:.5e} (golden {g_ea:.5e})  Eb_max {eb:.5e} "
            f"(golden {g_eb:.5e})  gate {'pass' if ok else 'FAIL'}")
        log(f"[main] {n}^3 wall {wall:.4f} s; phases (s) {phases}; cycles {cyc}")
        if not ok:
            raise AssertionError(f"vector_potential {n}^3 outside the golden gate")
        return wall, info

    run(22)
    run(220)  # cold: first use of the 220^3 engines
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    wall, info = run(220)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    plain = ops.plain_cuda_counts()
    log(f"[main] 220^3 warm: launches {launches}; plain versions on the card {plain}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on CUDA tensors: {plain}")

    # Where the time goes: one more warm 220^3 run under torch.profiler.
    # Device busy time = the summed durations of device-side events
    # (kernels and copies); CPU ops are left out, they would count their
    # kernels twice.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pwall, _ = run(220)
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not dev:
        raise AssertionError("the profiler recorded no device events")
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    log(f"[profile] 220^3: device busy {busy:.4f} s; wall {pwall:.4f} s under the profiler "
        f"(idle share {1.0 - busy / pwall:.3f}), {wall:.4f} s without it (idle share "
        f"{1.0 - busy / wall:.3f}); top device time:")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<6d} {e.key[:100]}")
    return launches


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import ndsm_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from ndsm_tpu_torch import ops

    name, _ = phase_device()
    stats = phase_kernels()
    launches = phase_main_path()
    kernels = []
    for wrapper, _, replaces in ops.KERNELS:
        key = wrapper.__name__
        src = "csrc/defect.cu" if key == "df_residual_3d" else "csrc/zc_smooth.cu"
        st = stats[key]
        kernels.append({
            "name": key,
            "route": "cuda",
            "source": f"ndsm_tpu_torch/{src}",
            "replaces": replaces,
            "launches": launches[key],
            "max_abs_err": st["err"],
            "ms": st["ms"][220]["Ax"],
            "plain_ms": st["plain_ms"][220]["Ax"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
