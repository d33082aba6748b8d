"""mg/batched.py (the port's MultiBCSolver) against ndsm_tpu's
MultiBCSolver and against the port's own sequential PoissonBVP solves, on
the CPU, on the component-solve inputs of tests/test_batched.py.

Tolerances:
  * lane masks and the coarse embedding ``S_stack``: bitwise (the same
    numpy/boolean construction);
  * fp64 against JAX: equal cycles, u within 1e-12 (same algorithm in
    f64; the transfers' summation order differs);
  * mixed with the plain f64 defect (``mixed_defect="f64"``) against JAX
    with its kernels off: equal cycles, u within 5e-9 (as JAX's own
    batched-vs-sequential test);
  * mixed with the port's f64 defect kernel semantics against JAX
    ``mixed_defect="df32"`` with its Pallas kernels in interpret mode
    (16^3, ms = 3, to keep the interpreted kernels inside the test's time):
    cycles within +-1, u within 5e-10 (the vc_tol contract);
  * against the port's sequential PoissonBVP: fp64 bitwise (every lane op
    is the sequential op on that lane); mixed equal cycles and u within
    5e-9 (the full-size coarse embedding sums in another order than the
    sequential route's interior-row matrix);
  * the pipeline with ``batch_components`` "on" and "off" in fp64: A within
    1e-11, B within 1e-9 (tests/test_batched.py's bounds).
"""

import numpy as np
import pytest
import torch

import ndsm_tpu
import ndsm_tpu_torch
from ndsm_tpu.mg.batched import MultiBCSolver as JaxMultiBCSolver
from ndsm_tpu_torch.mg.batched import MultiBCSolver

torch.set_num_threads(1)

COMPONENT_BCS = [
    tuple(("N", "N") if (2 - ax) == c else ("D", "D") for ax in range(3)) for c in range(3)
]


def _component_u0s(n, rng):
    """tests/test_batched.py's inputs: random Dirichlet data on each
    component's Dirichlet faces."""
    u0s = []
    for c in range(3):
        u0 = np.zeros((n, n, n))
        if c != 2:
            u0[0, :, :] = rng.standard_normal((n, n))
            u0[-1, :, :] = rng.standard_normal((n, n))
        if c != 1:
            u0[:, 0, :] = rng.standard_normal((n, n))
        if c != 0:
            u0[:, :, 0] = rng.standard_normal((n, n))
        u0s.append(u0)
    return np.stack(u0s)


def _hierarchies(n):
    x = np.linspace(0.0, 1.0, n)
    return (ndsm_tpu.GridHierarchy.from_mesh((x, x, x)),
            ndsm_tpu_torch.GridHierarchy.from_mesh((x, x, x)))


def _pair(n, kw, seed=0):
    hj, ht = _hierarchies(n)
    u0 = _component_u0s(n, np.random.default_rng(seed))
    uj, ij = JaxMultiBCSolver(hj, COMPONENT_BCS, ndsm_tpu.Options(**kw)).solve(
        u0, names=["Ax", "Ay", "Az"])
    mbs = MultiBCSolver(ht, COMPONENT_BCS, ndsm_tpu_torch.Options(**kw), device="cpu")
    ut, it = mbs.solve(u0, names=["Ax", "Ay", "Az"])
    return mbs, u0, np.asarray(uj), ij, ut.numpy(), it


def _sequential(mbs, u0, kw):
    out = []
    for c, bcs in enumerate(COMPONENT_BCS):
        bvp = ndsm_tpu_torch.PoissonBVP(mbs.h, bcs, ndsm_tpu_torch.Options(**kw), device="cpu")
        out.append(bvp.solve(u0[c], None, zero_rhs=True))
    return out


def test_masks_and_coarse_embedding_equal_jax():
    hj, ht = _hierarchies(24)
    kw = {"precision": "fp64", "coarse_solver": "direct"}
    mj = JaxMultiBCSolver(hj, COMPONENT_BCS, ndsm_tpu.Options(**kw))
    mt = MultiBCSolver(ht, COMPONENT_BCS, ndsm_tpu_torch.Options(**kw), device="cpu")
    assert len(mt._masks) == hj.ngrids
    for level, (m1, m2, mint) in enumerate(mt._masks):
        assert np.array_equal(m1.numpy(), mj._m1[level])
        assert np.array_equal(m2.numpy(), mj._m2[level])
        assert np.array_equal(mint.numpy(), mj._mint[level])
    assert mt.coarse_direct and mt._coarse_S.dtype == torch.float64
    assert np.array_equal(mt._coarse_S.numpy(), mj._coarse_S)
    # mixed keeps the same embedding, cast to the float32 V-cycle dtype
    mm = MultiBCSolver(ht, COMPONENT_BCS, ndsm_tpu_torch.Options(precision="mixed"),
                       device="cpu")
    assert np.array_equal(mm._coarse_S.numpy(), mj._coarse_S.astype(np.float32))


def test_fp64_matches_jax_and_sequential():
    kw = {"precision": "fp64"}
    mbs, u0, uj, ij, ut, it = _pair(24, kw)
    assert not mbs.coarse_direct and not mbs.df_defect
    for c in range(3):
        assert ij[c].ierr == it[c].ierr == 0
        assert ij[c].cycles == it[c].cycles and it[c].batch_size == 3
        assert it[c].name == ["Ax", "Ay", "Az"][c]
    assert np.abs(ut - uj).max() < 1e-12
    for c, (us, info) in enumerate(_sequential(mbs, u0, kw)):
        assert info.cycles == it[c].cycles
        assert np.array_equal(us.numpy(), ut[c])


def test_mixed_f64_defect_matches_jax():
    kw = {"precision": "mixed", "mixed_defect": "f64"}
    mbs, u0, uj, ij, ut, it = _pair(24, kw)
    assert mbs.coarse_direct and not mbs.df_defect
    for c in range(3):
        assert ij[c].ierr == it[c].ierr == 0 and ij[c].cycles == it[c].cycles
    assert np.abs(ut - uj).max() <= 5e-9


def test_mixed_df_matches_jax_df32_interpret(monkeypatch):
    monkeypatch.setenv("NDSM_TPU_PALLAS", "interpret")
    monkeypatch.setenv("NDSM_TPU_PALLAS_MIN_POINTS", "0")
    mbs, u0, uj, ij, ut, it = _pair(16, {"precision": "mixed", "mixed_defect": "df32",
                                         "ms": 3})
    assert mbs.df_defect
    for c in range(3):
        assert ij[c].ierr == it[c].ierr == 0
        assert abs(ij[c].cycles - it[c].cycles) <= 1
    np.testing.assert_allclose(ut, uj, rtol=0, atol=5e-10)


def test_mixed_df_matches_sequential():
    """The default mixed 3D route (df defect per lane) against the port's
    PoissonBVP.solve per component: the same cycles, u to 5e-9; and a
    lane's result does not depend on the other lanes (one lane alone)."""
    hj, ht = _hierarchies(24)
    u0 = _component_u0s(24, np.random.default_rng(1))
    kw = {"precision": "mixed"}
    mbs = MultiBCSolver(ht, COMPONENT_BCS, ndsm_tpu_torch.Options(**kw), device="cpu")
    ut, it = mbs.solve(u0)
    assert mbs.df_defect
    for c, (us, info) in enumerate(_sequential(mbs, u0, kw)):
        assert info.ierr == it[c].ierr == 0 and info.cycles == it[c].cycles
        assert np.abs(us.numpy() - ut[c].numpy()).max() <= 5e-9
    solo = MultiBCSolver(ht, COMPONENT_BCS[:1], ndsm_tpu_torch.Options(**kw), device="cpu")
    u1, i1 = solo.solve(u0[:1])
    assert i1[0].cycles == it[0].cycles and torch.equal(u1[0], ut[0])


def test_fp32_and_ncycles_limits():
    """fp32 mode (JAX runs its defect groups in float32 there) against JAX,
    and the ncycles_max contracts: COVFAIL at the limit, u0 back at 0."""
    _, _, uj, ij, ut, it = _pair(12, {"precision": "fp32", "vc_tol": 1e-4})
    for c in range(3):
        assert ij[c].ierr == it[c].ierr == 0 and abs(ij[c].cycles - it[c].cycles) <= 1
    assert ut.dtype == np.float32
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-4)
    _, ht = _hierarchies(12)
    u0 = _component_u0s(12, np.random.default_rng(2))
    for nmax in (0, 2):
        mbs = MultiBCSolver(ht, COMPONENT_BCS, ndsm_tpu_torch.Options(
            precision="mixed", ncycles_max=nmax), device="cpu")
        u, infos = mbs.solve(u0)
        assert [i.cycles for i in infos[:2]] == [nmax, nmax]
        assert all(i.ierr == ndsm_tpu_torch.IERR_COVFAIL for i in infos[:2])
        if nmax == 0:
            assert np.array_equal(u.numpy(), u0)


def test_all_neumann_lane_rejected():
    _, ht = _hierarchies(12)
    with pytest.raises(ValueError, match="all-Neumann"):
        MultiBCSolver(ht, [(("N", "N"),) * 3], ndsm_tpu_torch.Options(), device="cpu")
    with pytest.raises(ValueError):
        MultiBCSolver(ht, COMPONENT_BCS * 3, ndsm_tpu_torch.Options(), device="cpu")
    mbs = MultiBCSolver(ht, COMPONENT_BCS, ndsm_tpu_torch.Options(), device="cpu")
    with pytest.raises(ValueError):
        mbs.solve(np.zeros((2, 12, 12, 12)))


def test_pipeline_batch_toggle_equivalence():
    """batch_components on/off gives the same vector potential (fp64)."""
    from ndsm_tpu.utils.testing import build_test_mesh, potential_field_case

    n = 14
    x, y, z = build_test_mesh(n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    _, b1 = potential_field_case(X, Y, Z)
    out = {}
    for mode in ("on", "off"):
        _, A, B, info = ndsm_tpu_torch.vector_potential(
            x, y, z, b1.copy(), device="cpu", full_output=True,
            options=ndsm_tpu_torch.Options(precision="fp64", batch_components=mode))
        out[mode] = (A, B, [s.cycles for s in info.components],
                     [s.batch_size for s in info.components])
    assert out["on"][3] == [3, 3, 3] and out["off"][3] == [1, 1, 1]
    assert out["on"][2] == out["off"][2]
    np.testing.assert_allclose(out["on"][0], out["off"][0], rtol=0, atol=1e-11)
    np.testing.assert_allclose(out["on"][1], out["off"][1], rtol=0, atol=1e-9)
