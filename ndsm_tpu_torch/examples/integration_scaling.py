"""The reference's integration-test scaling table on the port (reference
tests/integration_test/integration_test1.py; JAX examples/
integration_scaling.py): the analytic potential-field case at nine sizes,
22^3 x [1, 2, 3, 3.5, 4, 4.5, 7.3, 8, 10], one row a size,
dx | Ea_max | Ea_avg | Eb_max | Eb_avg | time, then the power-law index of
each column (~2 expected).

Usage:
  python -m ndsm_tpu_torch.examples.integration_scaling [--mean]
      [--scales 1 2 3] [--precision auto|fp64|mixed] [--warm] [--out FILE]
      [--strict] [--fast] [--device cuda|cpu]

  --warm    one untimed call a size first, so the timed call is warm
  --out     also write the table in the reference's results_test format;
            compare it with ``python scripts/compare_golden.py FILE REF``
            (REF from ``python -m ndsm_tpu_torch.examples.golden``)
  --strict  mixed_inner_max=1: one V-cycle a defect, the reference's
            iterate sequence (the mean-metric table needs it for every
            digit, RESULTS.md)
  --fast    host_curl with the split16 encoding: A alone crosses to the
            host, B is its curl taken there
  --device  "cuda" (the default; raises without a card) or "cpu"
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..api import vector_potential
from ..options import Options
from ..utils.testing import build_test_mesh, potential_field_case, power_law_fit
from .golden import write_table

__all__ = ["SCALE_FACTORS", "NAMES", "options_for", "case", "run_row", "run_table",
           "power_law_indices", "main"]

SCALE_FACTORS = (1, 2, 3, 3.5, 4, 4.5, 7.3, 8, 10)  # integration_test1.py:107
NAMES = ("Ea_max", "Ea_avg", "Eb_max", "Eb_avg", "Time")


def options_for(mean=False, precision="auto", strict=False, fast=False) -> Options:
    """The options of a table run (JAX examples/integration_scaling.py:
    78-86)."""
    return Options(
        mean=mean, precision=precision, host_curl=fast,
        fetch_encoding="split16" if fast else "f64",
        mixed_inner_max=1 if strict else 6,
    )


def case(scale: float):
    """The analytic case at int(22 * scale) points an axis: ((x, y, z), A1,
    b1)."""
    x, y, z = build_test_mesh(int(scale * 22))
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    A1, b1 = potential_field_case(X, Y, Z)
    return (x, y, z), A1, b1


def run_row(scale: float, options: Options, warm=False, device="cuda"):
    """One row: (row, info) with row = [dx, Ea_max, Ea_avg, Eb_max, Eb_avg,
    time s of the timed call]."""
    (x, y, z), A1, b1 = case(scale)
    if warm:
        vector_potential(x, y, z, b1.copy(), options=options, device=device)
    t1 = time.perf_counter()
    ierr, A2, b2, info = vector_potential(x, y, z, b1.copy(), options=options, device=device,
                                          full_output=True)
    dt = time.perf_counter() - t1
    Eb = np.linalg.norm(b1 - b2, axis=0)
    Ea = np.linalg.norm(A1 - A2, axis=0)
    return [x[1] - x[0], Ea.max(), Ea.mean(), Eb.max(), Eb.mean(), dt], info


def run_table(scales=SCALE_FACTORS, options: Options = Options(), warm=False, device="cuda",
              out=None, echo=True):
    """Every row of ``scales``; prints each row as it comes when ``echo``
    and writes the table to ``out``.  Returns (rows, infos)."""
    rows, infos = [], []
    for scale in scales:
        row, info = run_row(scale, options, warm=warm, device=device)
        rows.append(row)
        infos.append(info)
        if echo:
            print("\t".join(f"{v:.5e}" for v in row), flush=True)
            if info.ierr != 0:
                print(f"  WARNING: ierr={info.ierr}", file=sys.stderr)
    if out:
        write_table(out, rows, mean=options.mean)
    return rows, infos


def power_law_indices(rows):
    """The fitted index of each column of ``NAMES`` over the rows' dx."""
    data = np.asarray(rows)
    return [power_law_fit(data[:, 0], data[:, i + 1])[0] for i in range(len(NAMES))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mean", action="store_true", help="mean-difference metric")
    ap.add_argument("--scales", type=float, nargs="*", default=list(SCALE_FACTORS))
    ap.add_argument("--precision", default="auto")
    ap.add_argument("--warm", action="store_true", help="one untimed call a size first")
    ap.add_argument("--out", default=None, help="write the table to FILE")
    ap.add_argument("--strict", action="store_true", help="mixed_inner_max=1")
    ap.add_argument("--fast", action="store_true", help="host_curl + split16")
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = ap.parse_args(argv)
    opts = options_for(args.mean, args.precision, args.strict, args.fast)
    rows, infos = run_table(args.scales, opts, warm=args.warm, device=args.device,
                            out=args.out)
    if len(rows) >= 2:
        for name, gamma in zip(NAMES, power_law_indices(rows)):
            print("Power-law index {:s}: {:g}".format(name, gamma))
    return rows, infos


if __name__ == "__main__":
    main()
