"""The port's vector-potential pipeline under non-default options, on the
CPU, against ndsm_tpu on the same inputs.

Tolerances: A and B within 1e-11 in fp64 (same algorithm, summation
orders differ); float32 outputs within a few float32 ulps of the JAX
package's (both round the same f64 solution; B differentiates once).
"""

import numpy as np
import pytest
import torch

import ndsm_tpu
import ndsm_tpu_torch
from ndsm_tpu.utils.testing import build_test_mesh, potential_field_case

torch.set_num_threads(1)


def _case(n):
    x, y, z = build_test_mesh(n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    A1, b1 = potential_field_case(X, Y, Z)
    return (x, y, z), A1, b1


@pytest.mark.parametrize("kw", [
    {"flux_correction_order": 1},
    {"honor_ms_for_az": False, "ms": 3},
    {"reference_flux_quirk": True, "mean": True},
])
def test_options_match_reference_fp64(kw):
    """Non-default pipeline options give the JAX package's result (fp64)."""
    n = 12
    (x, y, z), _, b1 = _case(n)
    o = dict(precision="fp64", **kw)
    _, A, B = ndsm_tpu_torch.vector_potential(x, y, z, b1, options=ndsm_tpu_torch.Options(**o),
                                              device="cpu")
    _, A_j, B_j = ndsm_tpu.vector_potential(x, y, z, b1, options=ndsm_tpu.Options(**o))
    assert np.abs(A - np.asarray(A_j)).max() < 1e-11
    assert np.abs(B - np.asarray(B_j)).max() < 1e-11


def test_float32_output_and_anisotropic_mesh():
    x = np.linspace(0, 1, 13)
    y = np.linspace(0, 0.8, 11)
    z = np.linspace(0, 0.6, 10)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    _, b1 = potential_field_case(X, Y, Z)
    o = dict(precision="mixed", output_dtype="float32")
    ierr, A, B = ndsm_tpu_torch.vector_potential(x, y, z, b1, options=ndsm_tpu_torch.Options(**o),
                                                 device="cpu")
    ierr_j, A_j, B_j = ndsm_tpu.vector_potential(x, y, z, b1, options=ndsm_tpu.Options(**o))
    assert ierr == ierr_j == 0
    assert A.dtype == np.float32 and B.dtype == np.float32
    eps = np.finfo(np.float32).eps
    assert np.abs(A - np.asarray(A_j)).max() < 8 * eps * np.abs(A_j).max() + 1e-9
    assert np.abs(B - np.asarray(B_j)).max() < 8 * eps * np.abs(B_j).max() * len(x) + 1e-8


def test_bad_mesh_returns_flag():
    x = np.array([0.0, 0.1, 0.3, 0.4])  # not uniform
    b = np.ones((3, 4, 4, 4))
    ierr, A, B = ndsm_tpu_torch.vector_potential(x, x, x, b, device="cpu")
    assert ierr == ndsm_tpu_torch.IERR_BADMESH
    assert np.array_equal(A, np.zeros_like(b)) and np.array_equal(B, b)
    ierr_j, A_j, B_j = ndsm_tpu.vector_potential(x, x, x, b)
    assert ierr_j == ierr
