"""Face geometry tables for the 3D box.

Faces are numbered 0..5 = (x0, x1, y0, y1, z0, z1), matching the
reference's S1..S6 (fortran/ndsm_vector_potential.f90:81-116).

Volume arrays are C-ordered (nz, ny, nx); a face slice keeps the C order of
its two in-plane axes, e.g. face x0 -> array[:, :, 0] with axes (z, y).
The reference's Fortran dimension d (1=x fastest) maps to C axis (3 - d).
"""

from __future__ import annotations

import numpy as np

# Component normal to each face: x,x,y,y,z,z (reference imap_cp = [1,1,2,2,3,3])
FACE_COMP = (0, 0, 1, 1, 2, 2)
# Lower (0) or upper (1) face (reference imap_ul = [1,2,1,2,1,2])
FACE_SIDE = (0, 1, 0, 1, 0, 1)
# In-plane dimensions in Fortran order (d1 < d2), 0-based components
# (reference imap_nc: faces 1,2 -> (2,3); 3,4 -> (1,3); 5,6 -> (1,2))
FACE_DIMS = ((1, 2), (1, 2), (0, 2), (0, 2), (0, 1), (0, 1))

# Unit tangent/normal vectors per face (reference tvecs1/tvecs2/nvecs,
# ndsm_vector_potential.f90:94-116).  Note nvec != tvec1 x tvec2 for the
# y-faces — the sign bookkeeping below reproduces the reference exactly.
TVECS1 = np.array(
    [[0, 1, 0], [0, 1, 0], [1, 0, 0], [1, 0, 0], [1, 0, 0], [1, 0, 0]], dtype=np.float64
)
TVECS2 = np.array(
    [[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 0], [0, 1, 0]], dtype=np.float64
)
NVECS = np.array(
    [[1, 0, 0], [1, 0, 0], [0, 1, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1]], dtype=np.float64
)


def _cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.array(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def at_signs(face: int) -> tuple[float, float]:
    """Signs (s1, s2) with ``At1 = s1 * dchi/dq2`` and ``At2 = s2 * dchi/dq1``
    from ``At = -grad(chi) x n`` projected on the tangent vectors
    (reference compute_At_bcs, ndsm_vector_potential.f90:1019-1025):
    grad x n = dchi1*(t1 x n) + dchi2*(t2 x n);
    t1.(t1 x n) = t2.(t2 x n) = 0, so
    At1 = -dchi2 * t1.(t2 x n),  At2 = -dchi1 * t2.(t1 x n).
    """
    t1, t2, n = TVECS1[face], TVECS2[face], NVECS[face]
    s1 = -float(np.dot(t1, _cross(t2, n)))
    s2 = -float(np.dot(t2, _cross(t1, n)))
    return s1, s2


def face_volume_index(face: int, nshape_zyx: tuple[int, int, int]):
    """Index tuple selecting the face layer of a (nz, ny, nx) volume."""
    comp = FACE_COMP[face]
    side = FACE_SIDE[face]
    nz, ny, nx = nshape_zyx
    n = (nx, ny, nz)[comp]
    layer = 0 if side == 0 else n - 1
    idx = [slice(None)] * 3
    idx[2 - comp] = layer  # component c lives on C axis 2-c
    return tuple(idx)


def face_at_component(face: int, comp: int) -> int:
    """Which tangential At slot (1 or 2) carries Cartesian component
    ``comp`` on ``face`` (reference solve(), ndsm_vector_potential.f90:
    647-650, 663-666, 679-682: pick the tangent vector equal to e_comp)."""
    if np.array_equal(TVECS1[face], np.eye(3)[comp]):
        return 1
    if np.array_equal(TVECS2[face], np.eye(3)[comp]):
        return 2
    raise ValueError(f"component {comp} is not tangential on face {face}")
