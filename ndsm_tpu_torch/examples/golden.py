"""The reference's golden tables as data (reference
tests/integration_test/results_test1.txt and results_test2.txt, rows 6-14;
BASELINE.md's copies).

Each row is (dx, Ea_max, Ea_avg, Eb_max, Eb_avg, time s) on the analytic
potential-field case at 22^3 x [1, 2, 3, 3.5, 4, 4.5, 7.3, 8, 10]; the
times are the reference's Fortran runs and are never compared.  Write a
table for ``scripts/compare_golden.py`` with

    python -m ndsm_tpu_torch.examples.golden {max,mean} FILE
"""

from __future__ import annotations

import sys
from typing import Sequence

__all__ = ["results_test1", "results_test2", "TABLES", "format_row", "write_table"]

#: integration_test1.py, the max-difference convergence metric.
results_test1 = (
    (4.76190e-02, 1.86048e-03, 2.67773e-04, 7.65805e-02, 6.53421e-03, 5.468e-01),
    (2.32558e-02, 4.44560e-04, 6.18187e-05, 1.95261e-02, 1.35063e-03, 1.141e+00),
    (1.53846e-02, 1.94618e-04, 2.67419e-05, 8.72558e-03, 5.57752e-04, 4.344e+00),
    (1.31579e-02, 1.42398e-04, 1.95035e-05, 6.42133e-03, 4.00818e-04, 7.923e+00),
    (1.14943e-02, 1.08647e-04, 1.48417e-05, 4.92049e-03, 3.01727e-04, 1.173e+01),
    (1.02041e-02, 8.56395e-05, 1.16779e-05, 3.89144e-03, 2.35234e-04, 1.587e+01),
    (6.28931e-03, 3.25317e-05, 4.41144e-06, 1.49319e-03, 8.63559e-05, 6.701e+01),
    (5.71429e-03, 2.68552e-05, 3.63900e-06, 1.23446e-03, 7.09164e-05, 8.930e+01),
    (4.56621e-03, 1.71483e-05, 2.31968e-06, 7.90579e-04, 4.48076e-05, 1.741e+02),
)

#: integration_test2.py, the mean-difference convergence metric.
results_test2 = (
    (4.76190e-02, 1.86048e-03, 2.67773e-04, 7.65805e-02, 6.53421e-03, 5.835e-01),
    (2.32558e-02, 4.44560e-04, 6.18187e-05, 1.95261e-02, 1.35063e-03, 1.099e+00),
    (1.53846e-02, 1.94618e-04, 2.67419e-05, 8.72558e-03, 5.57752e-04, 2.591e+00),
    (1.31579e-02, 1.42398e-04, 1.95035e-05, 6.42133e-03, 4.00818e-04, 4.052e+00),
    (1.14943e-02, 1.08647e-04, 1.48417e-05, 4.92049e-03, 3.01727e-04, 6.230e+00),
    (1.02041e-02, 8.56396e-05, 1.16779e-05, 3.89144e-03, 2.35234e-04, 1.121e+01),
    (6.28931e-03, 3.25317e-05, 4.41138e-06, 1.49319e-03, 8.63560e-05, 4.488e+01),
    (5.71429e-03, 2.68552e-05, 3.63899e-06, 1.23446e-03, 7.09164e-05, 6.337e+01),
    (4.56621e-03, 1.71485e-05, 2.31965e-06, 7.90579e-04, 4.48076e-05, 1.261e+02),
)

TABLES = {"max": results_test1, "mean": results_test2}


def format_row(row: Sequence[float]) -> str:
    """One table row as the reference prints it: six ``%.5e`` fields."""
    return "\t".join(f"{v:.5e}" for v in row)


def write_table(path: str, rows, mean: bool = False, source: str = "integration_scaling") -> None:
    """Write ``rows`` in the reference's results_test format (the format
    ``scripts/compare_golden.py`` reads: rows matched by dx, the four
    error columns compared digit by digit)."""
    with open(path, "w") as fh:
        fh.write(f"#\n# Results: {source}{' (mean metric)' if mean else ''}\n#\n")
        fh.write('# ["Ea_max","Ea_avg","Eb_max","Eb_avg","Time"]\n#\n')
        for row in rows:
            fh.write(format_row(row) + "\n")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2 or argv[0] not in TABLES:
        print("usage: python -m ndsm_tpu_torch.examples.golden {max,mean} FILE", file=sys.stderr)
        return 2
    write_table(argv[1], TABLES[argv[0]], mean=argv[0] == "mean", source="reference golden table")
    return 0


if __name__ == "__main__":
    sys.exit(main())
