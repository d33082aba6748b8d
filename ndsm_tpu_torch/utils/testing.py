"""Test helpers: power-law fitting and the analytic potential-field case.

Ports of the reference's test utilities (utests.py:32-65 and the analytic
case of tests/integration_test/integration_test1.py:57-99).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["power_law_fit", "potential_field_case", "build_test_mesh"]


def power_law_fit(x: np.ndarray, y: np.ndarray, cov: bool = False):
    """Fit y = A * x^gamma in log-log space; returns (gamma, A, evaluator),
    or (gamma, A, C, evaluator) with the fit covariance when ``cov``
    (reference: utests.py:32-65)."""
    Lx = np.log10(np.asarray(x, dtype=np.float64))
    Ly = np.log10(np.asarray(y, dtype=np.float64))
    if cov:
        p, C = np.polyfit(Lx, Ly, 1, cov=True)
    else:
        p = np.polyfit(Lx, Ly, 1)
    A = 10.0 ** p[1]
    ev = lambda q: A * q ** p[0]  # noqa: E731
    if cov:
        return p[0], A, C, ev
    return p[0], A, ev


def potential_field_case(X, Y, Z, wn: float = np.pi):
    """Analytic potential-field test case with B = curl(A), div B = 0
    (reference: integration_test1.py:57-99): wave number wn = pi*N,
    l = sqrt(2) * wn.

    Args:
      X, Y, Z: broadcastable coordinate arrays (typically (nz, ny, nx)).

    Returns:
      (A, b): exact vector potential and field, shape (3,) + X.shape.
    """
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


def build_test_mesh(n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The integration tests' mesh construction (integration_test1.py:
    122-127): x = linspace(0,1,n); y, z = arange(n)*dx."""
    x = np.linspace(0, 1, n)
    dx = x[1] - x[0]
    y = np.arange(n) * dx
    z = np.arange(n) * dx
    return x, y, z
