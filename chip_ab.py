"""Walls of the compact and sharded paths on one card, and the sharded
engine's collectives, for comparing two checkouts in one call.

    python3 chip_ab.py walls TREE TAG
        With TREE's own ``chip_smoke.py`` helpers and kernels (TREE a
        checkout of this repository, this one or another commit unpacked
        beside it): warms paths 3, 3b, 4 and 4b of chip_smoke.py at 22^3
        and 220^3 and paths 5 and 5b (``ShardedPoissonBVP`` 256^3 Ax
        mixed over a z mesh of 4 / a (z, y) mesh of 4 x 2 on the card),
        then times four warm calls of each in rotation and prints one
        ``AB TAG path P: wall ... | chi ... | solve3d ...`` line a path
        (seconds; paths 5 and 5b have no phases and print the wall
        alone).  Run it in separate processes, alternating the two
        checkouts (P C P C ...), since a process's host moves its walls.
    python3 chip_ab.py layer TREE
        In this checkout: the collectives of paths 5 and 5b's engine
        (256^3 over a z mesh of 4 / a 4 x 2 mesh on the card; its
        level-0 halo exchange, psum, the seam's gather and scatter, the
        gather of the result, the cut of a float64 input) against TREE's
        ``parallel/collectives.py`` (loaded from its file; its input cut
        as TREE's engine did it: the whole array to the root device, then
        cut there), in alternation in one process; one ``AB layer`` line
        an operation with the median host time a call (enqueue) and the
        median time a call to the end of the device's work, in µs.

Needs a CUDA card; imports no JAX.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _dists():
    from ndsm_tpu_torch.parallel.shard import DistConfig, make_mesh, make_mesh_nd

    return (DistConfig(make_mesh(2, devices=["cuda:0"] * 2)),
            DistConfig(make_mesh_nd((2, 2), ("z", "y"), devices=["cuda:0"] * 4), ("z", "y")))


def walls(tree: str, tag: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from ndsm_tpu_torch.utils import cuda_build

    cuda_build.kernels()
    d4, d4b = _dists()
    routes = {"3": dict(batch="auto", smoother="compact"),
              "3b": dict(batch="off", smoother="compact"),
              "4": dict(batch="off", dist=d4), "4b": dict(batch="off", dist=d4b)}
    timers = {}
    for k, r in routes.items():
        cs.run(22, **r)
        cs.run(220, **r)

        def pipeline(r=r):
            w, inf, _, _ = cs.run(220, **r)
            return w, inf.phases.get("chi", 0.0), inf.phases.get("solve3d", 0.0)

        timers[k] = pipeline
    for k, sb, u0, rhs in _sharded_solves(cs):
        sb.solve(u0, rhs)  # cold

        def solve(sb=sb, u0=u0, rhs=rhs):
            t0 = time.perf_counter()
            sb.solve(u0, rhs)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, None, None

        timers[k] = solve
    got = {k: [] for k in timers}
    order = list(timers)
    for rep in range(4):
        for k in order[rep % len(order):] + order[:rep % len(order)]:
            got[k].append(timers[k]())
    for k, v in got.items():
        line = f"AB {tag} path {k}: wall " + " ".join(f"{w:.4f}" for w, _, _ in v)
        if v[0][1] is not None:
            line += (" | chi " + " ".join(f"{c:.4f}" for _, c, _ in v)
                     + " | solve3d " + " ".join(f"{s:.4f}" for _, _, s in v))
        print(line, flush=True)


def _sharded_solves(cs):
    """Paths 5 and 5b of chip_smoke.py: (tag, solver, u0, rhs)."""
    import numpy as np

    from ndsm_tpu_torch import Options
    from ndsm_tpu_torch.parallel.shard import make_mesh_nd
    from ndsm_tpu_torch.parallel.sm_engine import ShardedPoissonBVP

    n = 256
    x = np.linspace(0.0, 1.0, n)
    rhs = -3.0 * np.pi**2 * (np.sin(np.pi * x)[:, None, None] * np.sin(np.pi * x)[None, :, None]
                             * np.cos(np.pi * x)[None, None, :])
    u0 = np.zeros_like(rhs)
    h = cs.hierarchy_of(n)
    for tag, grid in (("5", (4,)), ("5b", (4, 2))):
        names = ("z", "y")[:len(grid)]
        mesh = make_mesh_nd(grid, names, devices=["cuda:0"] * int(np.prod(grid)))
        yield tag, ShardedPoissonBVP(h, cs.BC_SETS["Ax"], Options(precision="mixed"),
                                     axis_names=names, mesh=mesh), u0, rhs


def layer(tree: str) -> None:
    sys.path.insert(0, HERE)
    os.chdir(HERE)
    import importlib.util
    import statistics

    import torch

    import chip_smoke as cs
    from ndsm_tpu_torch.parallel import collectives as C

    spec = importlib.util.spec_from_file_location(
        "parent_collectives",
        os.path.join(os.path.abspath(tree), "ndsm_tpu_torch", "parallel", "collectives.py"))
    P = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(P)
    for tag, sb, _, rhs in _sharded_solves(cs):
        u = sb._split(rhs, "rhs")
        lines = list(enumerate(sb._lines))
        fine = [torch.zeros(sb._local(sb.seam - 1), dtype=torch.float32, device=sb.devices[p])
                for p in sb.local]
        full = torch.zeros(sb.h.shapes[sb.seam - 1], dtype=torch.float32, device=sb.device)
        vals = [torch.ones((), dtype=torch.float64, device=sb.devices[p]) for p in sb.local]

        def extend(mod, where):
            xs = u
            for ax, line in lines:
                xs = mod.extend_block(xs, where, ax, 1, line)

        ops = {
            "input cut": (lambda: sb._split(rhs, "rhs"),
                          lambda: P.shard(torch.as_tensor(rhs, dtype=torch.float64,
                                                          device=sb.device),
                                          sb.devices, 0, sb.grid)),
            "extend_block level 0": (lambda: extend(C, sb.sub), lambda: extend(P, sb.devices)),
            "psum": (lambda: C.psum(vals, sb.sub), lambda: P.psum(vals, sb.devices)),
            "all_gather seam": (lambda: C.all_gather(fine, sb.sub, 0, sb.grid),
                                lambda: P.all_gather(fine, sb.devices, 0, sb.grid)),
            "scatter seam": (lambda: C.scatter(full, sb.sub, 0, sb.grid),
                             lambda: P.scatter(full, sb.devices, 0, sb.grid)),
            "unshard level 0": (lambda: C.unshard(u, sb.sub, 0, sb.grid),
                                lambda: P.unshard(u, sb.devices, 0, sb.grid)),
        }
        for name, (new, old) in ops.items():
            k = 2 if name in ("input cut", "unshard level 0") else 50
            got = {"change": [], "parent": []}
            for rep in range(12):
                for side in (("change", "parent") if rep % 2 == 0 else ("parent", "change")):
                    fn = new if side == "change" else old
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(k):
                        fn()
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    got[side].append(((t1 - t0) / k * 1e6, (time.perf_counter() - t0) / k * 1e6))
            print(f"AB layer path {tag} {name} ({k} calls a sample, 12 samples): " + "; ".join(
                f"{side} host {statistics.median(h for h, _ in v):.1f} us, to the end "
                f"{statistics.median(a for _, a in v):.1f} us" for side, v in got.items()),
                flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "walls":
        walls(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 3 and sys.argv[1] == "layer":
        layer(sys.argv[2])
    else:
        sys.exit(__doc__)
