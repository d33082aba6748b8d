"""The least time the card could take for a call's stepping work.

The stepping work is keyed on the algorithm's steps, never on a kernel's
name: per lane and V-cycle of a multigrid solve,

  * on every level but the coarsest, ``ms`` sweeps with the residual
    (residual form) going down, and ``ms`` sweeps on ``u + correction``
    (correction form) going up;
  * on every level but the finest, ``ms`` plain sweeps of the coarse
    correction going up;

and per lane, one float64 defect each group of up to ``inner_max``
V-cycles: ``ceil(cycles / inner_max)`` defects, the first reading u (and
the right-hand side) and writing the float32 defect, each later one also
reading the pending correction and writing u.  The coarsest level's direct
solve, the grid transfers, the metrics and the final correction are left
out, so the sum is a lower bound of the stepping work.

Levels come from the mesh by the reference code's rule (``num_grids``,
``coarsen_shape``); cycles come from each solve's ``SolveInfo``; a lane that
converged early counts only its own cycles (what its inputs need).  The
bytes and operations a point of each step come from the frozen per-point
table (``frozen.WORK``; each input read once, each output written once); a
step's least time is the larger of its bytes over the peak bandwidth and
its operations over the peak rate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Tuple

from .frozen import PEAK_BYTES, WORK, coarsen_shape, num_grids


@dataclasses.dataclass(frozen=True)
class Solve:
    """One lane's solve: its finest shape, its V-cycles, whether it has a
    right-hand side and whether every face is Neumann (the sweeps then
    take out the mean)."""

    shape: Tuple[int, ...]
    cycles: int
    has_rhs: bool
    all_neumann: bool


def level_points(shape) -> List[int]:
    out, s = [], tuple(shape)
    for _ in range(num_grids(shape)):
        out.append(math.prod(s))
        s = coarsen_shape(s)
    return out


#: The per-point rows of ``frozen.WORK`` for the smoothing forms (residual,
#: correction, plain) by (dimensions, whether the sweeps take out the mean).
SMOOTH = {
    (3, False): ("zc_smooth_residual_3d", "zc_smooth_cor_3d", "zc_smooth_3d"),
    (3, True): ("zc_smooth_mean_residual_3d", "zc_smooth_mean_cor_3d", "zc_smooth_mean_3d"),
    (2, False): ("smooth_residual_2d", "smooth_cor_2d", "smooth_2d"),
    (2, True): ("v2d_smooth_residual", "v2d_smooth_cor", "v2d_smooth"),
}


def _defect(dims: int, first: bool, rhs: bool) -> str:
    """The ``frozen.WORK`` row of a float64 defect."""
    return f"df_{'first' if first else 'residual'}{'_rhs' if rhs else ''}_{dims}d"


def steps(solve: Solve, ms: int, inner_max: int) -> List[Tuple[float, float, float, int]]:
    """(bytes, operations, peak, repeats) of each step of ``solve``."""
    dims = len(solve.shape)
    resid, cor, plain = (WORK[k](ms) for k in SMOOTH[dims, solve.all_neumann])
    pts = level_points(solve.shape)
    c = solve.cycles
    out = []
    for n in pts[:-1]:
        out += [(b * n, ops * n, peak, c) for b, ops, peak in (resid, cor)]
    out += [(plain[0] * n, plain[1] * n, plain[2], c) for n in pts[1:]]
    groups = math.ceil(c / inner_max) if c else 0
    n = pts[0]
    for first, rep in ((True, min(groups, 1)), (False, groups - 1)):
        if rep > 0:
            b, ops, peak = WORK[_defect(dims, first, solve.has_rhs)](ms)
            out.append((b * n, ops * n, peak, rep))
    return out


def least_seconds(solves: Iterable[Solve], ms: int, inner_max: int) -> float:
    total = 0.0
    for s in solves:
        for b, ops, peak, rep in steps(s, ms, inner_max):
            total += rep * max(b / PEAK_BYTES, ops / peak)
    return total
