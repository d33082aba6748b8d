#!/usr/bin/env python3
"""The benchmark of ndsm_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  One process: set up and warm up the cell
(``BENCHMARK.json``'s workload), run a closed loop of calls for ``--seconds``,
check the window's answers against the plain reference, and print one JSON
object as the last line of standard output (with ``--trace 1`` the per-layer
metrics, from a profiled run of whole calls).  Without a CUDA device, or
with fewer than the cell asks for, it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / ".cache"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # Kernel caches at fixed paths inside the checkout (the port's own nvcc
    # builds live in ndsm_tpu_torch/_build/).
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path.insert(0, str(ROOT))

    from benchmark.lib import guard, harness, spec

    guard.check()
    cell = spec.load_cell(args.workload)
    t_torch = time.perf_counter()
    import torch

    print(f"import torch: {time.perf_counter() - t_torch:.3f} s", file=sys.stderr)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found {n}",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         t_start=T_START)
    guard.check()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
