"""The port's main path end to end at 22^3 on the CPU: ndsm_tpu_torch's
``vector_potential(..., device="cpu")`` against the golden row and against
ndsm_tpu on the same inputs.

Tolerances:
  * golden digits: ``%.5e`` equal to results_test1.txt row 1 (the
    reference's printed precision);
  * A and B against ndsm_tpu: 1e-11 in fp64 (same algorithm, summation
    orders differ) and 1e-9 in mixed (both solves stop at the vc_tol=1e-10
    contract, B differentiates A once, ~1/h);
  * interior div(B): < 1e-11 (the discrete identity cancels to rounding).
"""

import numpy as np
import pytest
import torch

import ndsm_tpu
import ndsm_tpu_torch
from ndsm_tpu.ops.deriv import deriv_axis
from ndsm_tpu.utils.testing import build_test_mesh, potential_field_case

torch.set_num_threads(1)

GOLDEN_22 = dict(Ea_max=1.86048e-03, Ea_avg=2.67773e-04, Eb_max=7.65805e-02, Eb_avg=6.53421e-03)


def _case(n):
    x, y, z = build_test_mesh(n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    A1, b1 = potential_field_case(X, Y, Z)
    return (x, y, z), A1, b1


@pytest.mark.parametrize("precision", ["fp64", "mixed"])
def test_golden_22_and_reference_parity(precision):
    (x, y, z), A1, b1 = _case(22)
    ierr, A, B, info = ndsm_tpu_torch.vector_potential(
        x, y, z, b1.copy(), precision=precision, device="cpu", full_output=True)
    assert ierr == 0
    assert isinstance(A, np.ndarray) and A.dtype == np.float64 and A.shape == (3, 22, 22, 22)
    Ea = np.linalg.norm(A1 - A, axis=0)
    Eb = np.linalg.norm(b1 - B, axis=0)
    for key, got in (("Ea_max", Ea.max()), ("Ea_avg", Ea.mean()),
                     ("Eb_max", Eb.max()), ("Eb_avg", Eb.mean())):
        assert f"{got:.5e}" == f"{GOLDEN_22[key]:.5e}", key
    assert set(info.phases) == {"faces", "chi", "solve3d", "post", "fetch"}

    ierr_j, A_j, B_j, info_j = ndsm_tpu.vector_potential(
        x, y, z, b1.copy(), precision=precision, full_output=True)
    assert ierr_j == 0
    tol = 1e-11 if precision == "fp64" else 1e-9
    assert np.abs(A - A_j).max() < tol
    assert np.abs(B - B_j).max() < tol
    names = [s.name for s in info.chi + info.components]
    assert names == [s.name for s in info_j.chi + info_j.components]
    for s, sj in zip(info.chi + info.components, info_j.chi + info_j.components):
        if precision == "fp64":
            assert s.cycles == sj.cycles, s.name
        else:
            assert abs(s.cycles - sj.cycles) <= 1, s.name


def test_divergence_free():
    (x, y, z), _, b1 = _case(22)
    ierr, A, B = ndsm_tpu_torch.vector_potential(x, y, z, b1.copy(), precision="fp64",
                                                 device="cpu")
    assert ierr == 0
    dq = np.array([x[1] - x[0]] * 3)
    div = (np.asarray(deriv_axis(B[0], dq[0], -1)) + np.asarray(deriv_axis(B[1], dq[1], -2))
           + np.asarray(deriv_axis(B[2], dq[2], -3)))
    assert np.abs(div[1:-1, 1:-1, 1:-1]).max() < 1e-11
