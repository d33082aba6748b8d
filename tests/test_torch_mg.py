"""Port's engine and PoissonBVP (mg/engine.py, mg/poisson.py) against
ndsm_tpu on the CPU, on identical numpy inputs.

Tolerances:
  * fp64 solves: equal cycle counts, u within 1e-12 (same algorithm in
    f64; only summation orders of the transfers and means differ);
  * mixed 3D (the port's f64 defect kernel semantics, plain versions on
    the CPU) against JAX ``mixed_defect="df32"`` with its Pallas kernels
    in interpret mode: cycles within +-1, u within 5e-10 (the vc_tol
    contract; the JAX pair arithmetic is ~2^-48, the port's f64);
  * mixed with the plain f64 defect (``mixed_defect="f64"``) and the
    all-Neumann 2D ``solve_batch`` (the chi faces): cycles within +-1,
    u within 5e-10.
"""

import numpy as np
import torch

import ndsm_tpu
import ndsm_tpu_torch
from ndsm_tpu_torch.mg.engine import MGEngine

torch.set_num_threads(1)


def _hierarchies(shape, ngrids=None):
    meshes = [np.linspace(0.0, 1.0, n) for n in shape]
    return (ndsm_tpu.GridHierarchy.from_mesh(meshes, ngrids=ngrids),
            ndsm_tpu_torch.GridHierarchy.from_mesh(meshes, ngrids=ngrids))


def _pair(shape, bcs, opts_kw, rhs, u0=None, ngrids=None, **solve_kw):
    hj, ht = _hierarchies(shape, ngrids)
    u0 = np.zeros(shape) if u0 is None else u0
    bj = ndsm_tpu.PoissonBVP(hj, bcs, ndsm_tpu.Options(**opts_kw))
    bt = ndsm_tpu_torch.PoissonBVP(ht, bcs, ndsm_tpu_torch.Options(**opts_kw), device="cpu")
    uj, ij = bj.solve(u0, rhs, **solve_kw)
    ut, it = bt.solve(u0, rhs, **solve_kw)
    return bt, np.asarray(uj), ij, ut.numpy(), it


def test_fp64_3d_solve_matches_jax():
    shape, bcs = (16, 14, 12), (("D", "D"), ("N", "N"), ("N", "D"))
    rng = np.random.default_rng(0)
    rhs = rng.standard_normal(shape)
    u0 = np.zeros(shape)
    u0[0] = 0.3  # Dirichlet data carried in u0 and frozen
    bt, uj, ij, ut, it = _pair(shape, bcs, {"precision": "fp64"}, rhs, u0)
    assert bt.mode == "fp64" and not bt.df_defect
    assert ij.ierr == it.ierr == 0
    assert ij.cycles == it.cycles
    assert np.abs(ut - uj).max() < 1e-12
    assert np.array_equal(ut[0], u0[0])


def test_fp64_2d_all_neumann_solve_matches_jax():
    shape, bcs = (20, 18), (("N", "N"), ("N", "N"))
    rng = np.random.default_rng(1)
    rhs = rng.standard_normal(shape)
    rhs -= rhs.mean()
    _, uj, ij, ut, it = _pair(shape, bcs, {"precision": "fp64"}, rhs)
    assert ij.cycles == it.cycles and it.ierr == 0
    assert np.abs(ut - uj).max() < 1e-12


def test_mixed_3d_df_matches_jax_df32_interpret(monkeypatch):
    """The configuration of tests/test_pallas_df.py:_solve_pair."""
    monkeypatch.setenv("NDSM_TPU_PALLAS", "interpret")
    monkeypatch.setenv("NDSM_TPU_PALLAS_MIN_POINTS", "0")
    n = 24
    bcs = (("D", "D"), ("N", "N"), ("N", "D"))
    rhs = np.random.default_rng(11).standard_normal((n, n, n))
    kw = dict(precision="mixed", vc_tol=1e-10, ncycles_max=64, ms=3, mixed_defect="df32")
    bt, uj, ij, ut, it = _pair((n, n, n), bcs, kw, rhs, ngrids=3)
    assert bt.df_defect and bt._inner.kernel_route
    assert ij.ierr == it.ierr == 0
    assert abs(ij.cycles - it.cycles) <= 1
    np.testing.assert_allclose(ut, uj, rtol=0, atol=5e-10)


def test_mixed_3d_zero_rhs_and_f64_defect_match_jax():
    """zero-rhs solve with Dirichlet data (the component solves' form);
    the port's df path and its plain f64 defect group both match JAX's
    CPU mixed path."""
    n = 18
    bcs = (("N", "N"), ("D", "D"), ("D", "D"))
    x = np.linspace(0, 1, n)
    u0 = np.zeros((n, n, n))
    u0[:, 0, :] = np.sin(3 * x)[None, :]
    u0[:, :, -1] = np.cos(2 * x)[:, None]
    for md in ("auto", "f64"):
        bt, uj, ij, ut, it = _pair((n, n, n), bcs, {"precision": "mixed", "mixed_defect": md},
                                   None, u0, zero_rhs=True)
        assert bt.df_defect == (md == "auto")
        assert ij.ierr == it.ierr == 0
        assert abs(ij.cycles - it.cycles) <= 1
        np.testing.assert_allclose(ut, uj, rtol=0, atol=5e-10)


def test_mixed_2d_all_neumann_solve_batch_matches_jax():
    """The chi faces' configuration: all-Neumann 2D, mixed, lane-batched."""
    shape, bcs = (22, 22), (("N", "N"), ("N", "N"))
    rng = np.random.default_rng(3)
    rhss = []
    # Scales off the f32 floor: at larger |rhs| the mixed du sits near
    # vc_tol on the float32 noise of the correction, and the cycle count
    # flips by 2-3 with rounding order (JAX's own batched and standalone
    # solves differ there; ROADMAP.md Queue C).
    for scale in (0.3, 0.5, 0.1):
        r = rng.standard_normal(shape) * scale
        rhss.append(r - r.mean())
    rhss.append(np.zeros(shape))  # a lane that converges at once
    u0s = [np.zeros(shape)] * 4
    hj, ht = _hierarchies(shape)
    bj = ndsm_tpu.PoissonBVP(hj, bcs, ndsm_tpu.Options(precision="mixed"))
    bt = ndsm_tpu_torch.PoissonBVP(ht, bcs, ndsm_tpu_torch.Options(precision="mixed"), device="cpu")
    uj, ij = bj.solve_batch(u0s, rhss, names=list("abcd"))
    ut, it = bt.solve_batch(u0s, rhss, names=list("abcd"))
    for a, b, ia, ib in zip(uj, ut, ij, it):
        assert ia.ierr == ib.ierr == 0 and ib.batch_size == 4 and ia.name == ib.name
        assert abs(ia.cycles - ib.cycles) <= 1
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=5e-10)
    # each lane follows its standalone solve (lane freezing): same cycle
    # count, u to the vc_tol contract (batched and single-lane matmuls and
    # means sum in different orders)
    for k in range(4):
        us, info = bt.solve(u0s[k], rhss[k])
        assert info.cycles == it[k].cycles
        np.testing.assert_allclose(us.numpy(), ut[k].numpy(), rtol=0, atol=1e-10)


def test_fp32_mode_and_covfail(capfd):
    shape, bcs = (12, 12, 12), (("D", "D"), ("D", "D"), ("N", "N"))
    rhs = np.random.default_rng(4).standard_normal(shape)
    _, uj, ij, ut, it = _pair(shape, bcs, {"precision": "fp32", "vc_tol": 1e-4}, rhs)
    assert ut.dtype == np.float32 and it.ierr == ij.ierr == 0
    assert abs(ij.cycles - it.cycles) <= 1
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-4)
    # ncycles_max too small: COVFAIL with the reference's warning text
    _, _, ij, _, it = _pair(shape, bcs, {"precision": "mixed", "ncycles_max": 2}, rhs)
    assert it.ierr == ij.ierr == ndsm_tpu_torch.IERR_COVFAIL and it.cycles == 2
    assert "IOPT_NCYCLES exceeded" in capfd.readouterr().err


def test_ncycles_max_zero_returns_u0():
    shape, bcs = (10, 10, 10), (("D", "D"), ("N", "N"), ("N", "N"))
    rng = np.random.default_rng(5)
    u0, rhs = rng.standard_normal((2,) + shape)
    _, ht = _hierarchies(shape)
    bt = ndsm_tpu_torch.PoissonBVP(ht, bcs, ndsm_tpu_torch.Options(precision="mixed",
                                                                   ncycles_max=0),
                                   device="cpu")
    assert bt.df_defect
    u, info = bt.solve(u0, rhs)
    assert info.cycles == 0 and info.ierr == ndsm_tpu_torch.IERR_COVFAIL
    assert np.array_equal(u.numpy(), u0)


def test_vcycle_matches_jax_engine():
    """One f64 V-cycle with a relax coarse solve, engine to engine."""
    shape, bcs = (12, 10, 14), (("N", "D"), ("D", "N"), ("N", "N"))
    rng = np.random.default_rng(6)
    u, rhs = rng.standard_normal((2,) + shape)
    hj, ht = _hierarchies(shape)
    bj = ndsm_tpu.PoissonBVP(hj, bcs, ndsm_tpu.Options(precision="fp64"))
    eng = MGEngine(ht, bcs, ms=5, du_max=True, dtype=torch.float64, device="cpu")
    want = np.asarray(bj.vcycle(u, rhs))
    got, noconv = eng.t_vcycle(torch.as_tensor(u), torch.as_tensor(rhs), 1e-13, 10000)
    assert not noconv
    assert np.abs(got.numpy() - want).max() < 1e-12
