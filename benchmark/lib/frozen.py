"""Frozen copies of sound data and arithmetic the repository already had.

Each block names its origin at commit d689bd156a48 of this repository.
They are copied, not imported, so that a later change to the originals
cannot move the yardstick.
"""

from __future__ import annotations

import numpy as np

# -- bench.py:60-78 (GOLDEN and the h^2 prefactors) ---------------------------
# The reference's golden rows (sag2021/ndsm tests/integration_test/
# results_test1.txt): n -> (Ea_max, Eb_max, the reference's own time in s).
GOLDEN = {
    22: (1.86048e-03, 7.65805e-02, 5.468e-01),
    44: (4.44560e-04, 1.95261e-02, 1.141e00),
    66: (1.94618e-04, 8.72558e-03, 4.344e00),
    77: (1.42398e-04, 6.42133e-03, 7.923e00),
    88: (1.08647e-04, 4.92049e-03, 1.173e01),
    99: (8.56395e-05, 3.89144e-03, 1.587e01),
    160: (3.25317e-05, 1.49319e-03, 6.701e01),
    176: (2.68552e-05, 1.23446e-03, 8.930e01),
    220: (1.71483e-05, 7.90579e-04, 1.741e02),
}
# errors = prefactor * dx^2, fitted to the golden table
EA_PREFAC = 1.86048e-03 / 4.76190e-02**2
EB_PREFAC = 7.65805e-02 / 4.76190e-02**2


# -- ndsm_tpu_torch/utils/testing.py:36-70 ------------------------------------
def potential_field_case(X, Y, Z, wn: float = np.pi):
    """The analytic potential field of integration_test1.py:57-99: (A, b),
    each of shape (3,) + X.shape, with B = curl(A), div B = 0."""
    l = np.sqrt(2 * wn**2)
    shape = np.broadcast(X, Y, Z).shape
    b = np.zeros((3,) + shape)
    A = np.zeros((3,) + shape)
    e = np.exp(-l * Z)
    b[0] = +l * np.sin(wn * X) * np.cos(wn * Y) * e
    b[1] = +l * np.cos(wn * X) * np.sin(wn * Y) * e
    b[2] = +2 * wn * np.cos(wn * X) * np.cos(wn * Y) * e
    A[0] = -np.cos(wn * X) * np.sin(wn * Y) * e
    A[1] = +np.sin(wn * X) * np.cos(wn * Y) * e
    return A, b


def build_test_mesh(n: int):
    """integration_test1.py:122-127: x = linspace(0, 1, n); y, z = arange(n) dx."""
    x = np.linspace(0, 1, n)
    dx = x[1] - x[0]
    y = np.arange(n) * dx
    z = np.arange(n) * dx
    return x, y, z


# -- chip_smoke.py:277-313 (peaks and the work of one call per point) ---------
# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# device memory 3.35 TB/s; float32 67 TFLOP/s and float64 34 TFLOP/s outside
# the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12

# Work of one call per point, at ns sweeps: (bytes, operations, peak).  Bytes
# count each input read once and each output written once; the operations
# are the update's adds and multiplies (10 a point-sweep in 3D, 7 in 2D), +2
# a point-sweep for the mean (its sum and subtraction), +13 (3D) / +9 (2D)
# for a residual, +1 for the correction's add.
WORK = {
    "zc_smooth_3d": lambda ns: (12, 10 * ns, PEAK_F32),
    "zc_smooth_residual_3d": lambda ns: (16, 10 * ns + 13, PEAK_F32),
    "zc_smooth_cor_3d": lambda ns: (16, 10 * ns + 1, PEAK_F32),
    "df_residual_3d": lambda ns: (24, 14, PEAK_F64),  # f64 u, f32 e in; f32 r, f64 u out
    "zc_smooth_mean_3d": lambda ns: (12, 12 * ns, PEAK_F32),
    "v2d_smooth": lambda ns: (12, 9 * ns, PEAK_F32),
    "v2d_smooth_residual": lambda ns: (16, 9 * ns + 9, PEAK_F32),
    "v2d_smooth_cor": lambda ns: (16, 9 * ns + 1, PEAK_F32),
}


# -- added here, in the same units: the step forms chip_smoke.py did not time
# alone, which the work model (work.py) also needs.  Their bytes and
# operations follow the rules above: the mean's +2 a point-sweep on the
# residual and correction forms; a 2D sweep without the mean (7 a
# point-sweep); and the float64 defect's other forms (f64 u in, f32 r out:
# 12 B; a float64 right-hand side read: +8 B; the pending f32 correction read
# and u written back, as df_residual_3d: +12 B), 14 operations in 3D (the
# residual's 13 and the update's add), 10 in 2D (9 and 1).
WORK.update({
    "zc_smooth_mean_residual_3d": lambda ns: (16, 12 * ns + 13, PEAK_F32),
    "zc_smooth_mean_cor_3d": lambda ns: (16, 12 * ns + 1, PEAK_F32),
    "smooth_2d": lambda ns: (12, 7 * ns, PEAK_F32),
    "smooth_residual_2d": lambda ns: (16, 7 * ns + 9, PEAK_F32),
    "smooth_cor_2d": lambda ns: (16, 7 * ns + 1, PEAK_F32),
    "df_first_3d": lambda ns: (12, 14, PEAK_F64),
    "df_first_rhs_3d": lambda ns: (20, 14, PEAK_F64),
    "df_residual_rhs_3d": lambda ns: (32, 14, PEAK_F64),
    "df_first_2d": lambda ns: (12, 10, PEAK_F64),
    "df_first_rhs_2d": lambda ns: (20, 10, PEAK_F64),
    "df_residual_2d": lambda ns: (24, 10, PEAK_F64),
    "df_residual_rhs_2d": lambda ns: (32, 10, PEAK_F64),
})


def bound(key: str, points: int, ns: int):
    """(least ms the card could take, "bytes" or "operations") of one call."""
    b, ops, peak = WORK[key](ns)
    tb, to = b * points / PEAK_BYTES * 1e3, ops * points / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# -- ndsm_tpu_torch/grids.py:83-98 (the levels of a hierarchy) -----------------
def coarsen_shape(shape):
    """One level of coarsening: max(floor(n / 2), 1) per axis."""
    return tuple(max(n // 2, 1) for n in shape)


def num_grids(shape) -> int:
    """Default number of levels: floor(log2(min(shape) / 2))."""
    nmin = min(shape)
    if nmin < 4:
        raise ValueError(f"smallest dimension {nmin} < 4")
    return int(np.floor(np.log(nmin / 2.0) / np.log(2.0)))
