"""Mesh ``test_mesh``: integration_test1.py:122-127's box (x = linspace(0, 1,
n); y and z step as x does)."""

from benchmark.lib.frozen import build_test_mesh


def mesh(n):
    """(x, y, z) for ``n`` points an axis."""
    return build_test_mesh(n)
