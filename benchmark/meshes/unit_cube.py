"""Mesh ``unit_cube``: ``n`` uniform nodes on [0, 1] along every axis."""

import numpy as np


def mesh(n):
    """(x, y, z) for ``n`` points an axis."""
    return (np.linspace(0.0, 1.0, n),) * 3
