"""The distributed slice end to end on the CPU: ndsm_tpu_torch's
``vector_potential(..., dist=DistConfig(...))`` against ndsm_tpu's dist
run, against the port without dist, and against the golden row.

Tolerances (tests/test_dist.py's): A to 1e-8 and B to 1e-7 against either
single-device or JAX run at 16^3 fp64 over 4 shards; at 22^3 mixed over 2
shards the golden digits (``%.5e``) are exact, as on one device.
"""

import numpy as np
import pytest
import torch

import ndsm_tpu
import ndsm_tpu_torch
from ndsm_tpu.parallel.shard import DistConfig as JDist, make_mesh as j_make_mesh
from ndsm_tpu.utils.testing import build_test_mesh, potential_field_case
from ndsm_tpu_torch.parallel.shard import DistConfig, make_mesh

torch.set_num_threads(1)


def _case(n, mesh=None):
    x, y, z = mesh or build_test_mesh(n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    A1, b1 = potential_field_case(X, Y, Z)
    return (x, y, z), A1, b1


def test_dist_matches_jax_and_single_device():
    n = 16
    x = np.linspace(0.0, 1.0, n)
    (x, y, z), _, b1 = _case(n, (x, x, x))
    opts = ndsm_tpu_torch.Options(precision="fp64")
    dist = DistConfig(make_mesh(4, devices=["cpu"] * 4), min_rows_per_shard=2)
    i_d, A_d, B_d, info = ndsm_tpu_torch.vector_potential(
        x, y, z, b1.copy(), options=opts, dist=dist, device="cpu", full_output=True)
    i_r, A_r, B_r = ndsm_tpu_torch.vector_potential(x, y, z, b1.copy(), options=opts,
                                                     device="cpu")
    jdist = JDist(mesh=j_make_mesh(4), axis_names=("z",), min_rows_per_shard=2)
    i_j, A_j, B_j = ndsm_tpu.vector_potential(x, y, z, b1.copy(),
                                              options=ndsm_tpu.Options(precision="fp64"),
                                              dist=jdist)
    assert i_d == i_r == i_j == 0
    assert [s.batch_size for s in info.components] == [1, 1, 1]  # no batching under dist
    for A_o, B_o in ((A_r, B_r), (np.asarray(A_j), np.asarray(B_j))):
        np.testing.assert_allclose(A_d, A_o, rtol=0, atol=1e-8)
        np.testing.assert_allclose(B_d, B_o, rtol=0, atol=1e-7)


def test_dist_golden_22_mixed():
    (x, y, z), A1, b1 = _case(22)
    dist = DistConfig(make_mesh(2, devices=["cpu"] * 2))
    ierr, A, B, info = ndsm_tpu_torch.vector_potential(
        x, y, z, b1.copy(), precision="mixed", device="cpu", dist=dist, full_output=True)
    assert ierr == 0
    ea = np.linalg.norm(A1 - A, axis=0).max()
    eb = np.linalg.norm(b1 - B, axis=0).max()
    assert f"{ea:.5e} {eb:.5e}" == "1.86048e-03 7.65805e-02"
    _, A_r, _ = ndsm_tpu_torch.vector_potential(x, y, z, b1.copy(), precision="mixed",
                                                device="cpu")
    np.testing.assert_allclose(A, A_r, rtol=0, atol=1e-9)


def test_dist_mesh_must_match_device():
    x = np.linspace(0.0, 1.0, 8)
    b = np.zeros((3, 8, 8, 8))
    card_mesh = DistConfig(make_mesh(2, devices=["cuda:0"] * 2))  # (a mesh needs no card)
    with pytest.raises(ValueError, match="do not match"):
        ndsm_tpu_torch.vector_potential(x, x, x, b, dist=card_mesh, device="cpu")
