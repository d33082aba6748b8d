"""The 2D Poisson scaling study on the port (reference
tests/unit_tests/unit_test_2D_solve.f90; JAX examples/unit_test_2d_solve.py).

Solves the all-Neumann polynomial case

    Lap(u) = a1*(2x - Lx) + b1*(2y - Ly)     (unit_test_2D_solve.f90:92)

on meshes ceil([27, 36] * s) for the reference's nine scale factors
(27 x 36 to 675 x 900; unit_test_2D_solve.f90:68), writes ``res.txt`` rows
``dx  Emax  Eavg`` (both solutions mean-free, the analytic one being
defined up to a constant) and prints the power-law index of Emax (~2).
The JAX script also draws the log-log figure with matplotlib; this one
draws none, so it runs where matplotlib is not installed.

Usage:
  python -m ndsm_tpu_torch.examples.unit_test_2d_solve [--quick]
      [--data res.txt] [--dump FILE] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..grids import GridHierarchy
from ..mg.poisson import PoissonBVP
from ..options import Options
from ..utils.testing import power_law_fit

__all__ = ["SCALEFAC", "NSHAPE_BASE", "coefficients", "shapes", "solve_case", "main"]

SCALEFAC = (1.0, 1.5, 2.0, 4.0, 5.5, 10.0, 15.0, 20.0, 25.0)
NSHAPE_BASE = np.array([27, 36])
NEUMANN = (("N", "N"), ("N", "N"))


def coefficients():
    """(a1, b1) of the right-hand side, drawn as the reference's seed role
    draws them."""
    rng = np.random.default_rng(2112)
    return rng.random(), rng.random()


def shapes(facs=SCALEFAC):
    """(nx, ny) of each scale factor."""
    return [tuple(int(v) for v in np.ceil(NSHAPE_BASE * s).astype(int)) for s in facs]


def solve_case(nshape, a1, b1, Lx=1.0, dump=None, device="cuda"):
    """([dx, Emax, Eavg], SolveInfo) for one resolution (solve_test_case,
    unit_test_2D_solve.f90:126-230)."""
    nx, ny = int(nshape[0]), int(nshape[1])
    dx = 1.0 / (nx - 1.0)
    x = np.arange(nx) * dx
    y = np.arange(ny) * dx
    Ly = y.max() - y.min()
    X, Y = np.meshgrid(x, y, indexing="ij")
    rhs = a1 * (2 * X - Lx) + b1 * (2 * Y - Ly)
    # the analytic solution up to a constant: integrate twice along each axis
    ue = a1 * (X**3 / 3 - Lx * X**2 / 2) + b1 * (Y**3 / 3 - Ly * Y**2 / 2)
    h = GridHierarchy.from_mesh((x, y))
    bvp = PoissonBVP(h, NEUMANN, Options(ex_tol=1e-12, ncycles_max=256), device=device)
    u, info = bvp.solve(np.zeros_like(rhs), rhs)
    if info.ierr != 0:
        print("ERROR: FAILED TO CONVERGE", file=sys.stderr)
    u = u.cpu().numpy()
    if dump:
        # the reference's optional raw dump (dump.dat: nshape, u, ue) as .npz
        print("Dumping to file:", dump)
        np.savez(dump, nshape=np.asarray(nshape), u=u, ue=ue)
    diff = (u - u.mean()) - (ue - ue.mean())
    return [dx, np.abs(diff).max(), np.abs(diff).mean()], info


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default="res.txt")
    ap.add_argument("--quick", action="store_true", help="first 4 sizes only")
    ap.add_argument("--dump", default=None, metavar="FILE",
                    help="write the finest case's raw u/ue arrays to FILE.npz")
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = ap.parse_args(argv)
    a1, b1 = coefficients()
    facs = SCALEFAC[:4] if args.quick else SCALEFAC
    rows, infos = [], []
    print("Output file:", args.data)
    print("Solving...")
    for s, nshape in zip(facs, shapes(facs)):
        t0 = time.perf_counter()
        res, info = solve_case(nshape, a1, b1, dump=(args.dump if s == facs[-1] else None),
                               device=args.device)
        rows.append(res)
        infos.append(info)
        print(f"  {nshape[0]}x{nshape[1]}: dx={res[0]:.4g} Emax={res[1]:.4g} "
              f"Eavg={res[2]:.4g} cycles={info.cycles} ({time.perf_counter() - t0:.1f}s)")
    data = np.asarray(rows)
    np.savetxt(args.data, data, header="Result dx,Emax,Eavg")
    gamma, _, _ = power_law_fit(data[:, 0], data[:, 1])
    print("Power-law index: {:.12g}".format(gamma))
    return data, infos, gamma


if __name__ == "__main__":
    main()
