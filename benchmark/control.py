#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from.

    python3 benchmark/control.py --workload <cell> [--seeds 12] [--control-seeds 3]
        [--seed0 N] [--seconds 3] [--control-seconds 1] [--out FILE]

In one process, on the card: the program as the configuration states it on
``--seeds`` seeds (a short window each at the cell's own sizes, its answers
checked as a run checks them), then the lower-precision control (the
program's own ``precision="fp32"`` path) on ``--control-seeds`` seeds.  It
prints each run's numbers, the lower reading (the largest the program
gives) and the upper reading (the smallest the control gives) of each
number, and writes them as JSON to ``--out``.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seeds, seconds, device, overrides=None, mix_overrides=None):
    from benchmark.lib import harness

    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        r = harness.run(cell, seed, seconds, False, device=device, overrides=overrides,
                        mix_overrides=mix_overrides)
        nums = {k: v["value"] for k, v in r["checks"].items()}
        print(f"{'control' if overrides else 'program'} seed {seed}: correct {r['correct']}, "
              f"{r['attempted']} calls, {nums} ({time.perf_counter() - t0:.1f} s)", flush=True)
        out.append({"seed": seed, "correct": r["correct"], "checks": nums})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seed0", type=int, default=2_000_000_000)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "benchmark" / ".cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "benchmark" / ".cache" / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    from benchmark.lib import spec

    limits = spec.load_cell(args.workload).config["limits"]
    prog = readings(args.workload, [args.seed0 + i for i in range(args.seeds)], args.seconds,
                    args.device)
    ctrl = readings(args.workload, [args.seed0 + 1000 + i for i in range(args.control_seeds)],
                    args.control_seconds, args.device, overrides={"precision": "fp32"},
                    mix_overrides={"warm_calls": 0})
    summary = {}
    for k in limits:
        lower = max(r["checks"][k] for r in prog)
        upper = min(r["checks"][k] for r in ctrl)
        summary[k] = {"lower": lower, "upper": upper, "limit": limits[k]}
        print(f"{k}: lower {lower!r} (program, {len(prog)} seeds), upper {upper!r} "
              f"(fp32 control, {len(ctrl)} seeds), limit {limits[k]!r}", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"workload": args.workload, "program": prog, "control": ctrl,
                       "summary": summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
