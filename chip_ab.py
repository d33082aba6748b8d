"""Walls of the compact and sharded paths on one card, for comparing two
checkouts in one call, and the per-shard defect's own share of them.

    python3 chip_ab.py walls TREE TAG
        With TREE's own ``chip_smoke.py`` helpers and kernels (TREE a
        checkout of this repository, this one or another commit unpacked
        beside it): warms paths 3, 3b, 4 and 4b of chip_smoke.py at 22^3
        and 220^3, then times four warm 220^3 calls of each in rotation
        and prints one ``AB TAG path P: wall ... | chi ... | solve3d ...``
        line a path (seconds).  Run it in separate processes, alternating
        the two checkouts (P C P C ...), since a process's host moves its
        walls.
    python3 chip_ab.py defect
        In this checkout: paths 4 and 4b (warm 220^3), with every
        per-shard defect call timed inside the path (host time of its
        wrapper, CUDA events around it), the tile and the previous design
        (``df_sharded._defect_cuda(..., previous=True)``) in alternation,
        three calls each; one ``AB path P tile|previous`` line each.

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
    import chip_smoke as cs
    from ndsm_tpu_torch.utils import cuda_build

    cuda_build.kernels()
    d4, d4b = _dists()
    routes = {"3": dict(batch="auto", smoother="compact"),
              "3b": dict(batch="off", smoother="compact"),
              "4": dict(batch="off", dist=d4), "4b": dict(batch="off", dist=d4b)}
    for r in routes.values():
        cs.run(22, **r)
        cs.run(220, **r)
    got = {k: [] for k in routes}
    order = list(routes)
    for rep in range(4):
        for k in order[rep % 4:] + order[:rep % 4]:
            w, inf, _, _ = cs.run(220, **routes[k])
            got[k].append((w, inf.phases.get("chi", 0.0), inf.phases.get("solve3d", 0.0)))
    for k, v in got.items():
        print(f"AB {tag} path {k}: wall " + " ".join(f"{w:.4f}" for w, _, _ in v)
              + " | chi " + " ".join(f"{c:.4f}" for _, c, _ in v)
              + " | solve3d " + " ".join(f"{s:.4f}" for _, _, s in v), flush=True)


def defect() -> None:
    sys.path.insert(0, HERE)
    os.chdir(HERE)
    import torch

    import chip_smoke as cs
    from ndsm_tpu_torch.ops import df_sharded

    orig = df_sharded._defect_cuda
    state = {"previous": False, "host": 0.0, "n": 0, "ev": []}

    def timed(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        out = orig(*a, previous=state["previous"], **k)
        e1.record()
        state["host"] += time.perf_counter() - t0
        state["n"] += 1
        state["ev"].append((e0, e1))
        return out

    df_sharded._defect_cuda = timed
    d4, d4b = _dists()
    paths = {"4": d4, "4b": d4b}
    for d in paths.values():
        cs.run(22, "off", dist=d)
        cs.run(220, "off", dist=d)
    rows = {}
    for rep in range(3):
        for prev in ((False, True) if rep % 2 == 0 else (True, False)):
            for p, d in paths.items():
                state.update(previous=prev, host=0.0, n=0, ev=[])
                w, _, _, _ = cs.run(220, "off", dist=d)
                torch.cuda.synchronize()
                dev = sum(a.elapsed_time(b) for a, b in state["ev"])
                rows.setdefault((p, prev), []).append((w, state["n"], state["host"] * 1e3, dev))
    for (p, prev), v in rows.items():
        print(f"AB path {p} {'previous' if prev else 'tile'}: calls {v[0][1]}; wall "
              + " ".join(f"{x[0]:.4f}" for x in v) + " s; defect host ms a path call "
              + " ".join(f"{x[2]:.3f}" for x in v) + "; defect event ms "
              + " ".join(f"{x[3]:.3f}" for x in v), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "walls":
        walls(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 2 and sys.argv[1] == "defect":
        defect()
    else:
        sys.exit(__doc__)
