"""The ``smoother="compact"`` route through the port's engine, PoissonBVP,
MultiBCSolver and vector_potential, on the CPU (the compact kernels' plain
versions), against the port's dense route and against ndsm_tpu.

Tolerances:
  * ``smoother="compact"`` against ``"auto"`` in the port, at engine, solve
    and pipeline level, fp32 and mixed: equal cycles and bitwise equal
    results (merged, a colour-split sweep is the masked sweep bit for bit
    where the problem is not all-Neumann, and all-Neumann levels keep
    their own smoother on both settings);
  * against ndsm_tpu's PoissonBVP (whose default smoother on the CPU is the
    XLA colour-split sweep): cycles within +-1, u within 5e-10 in mixed
    (the vc_tol contract) and 1e-4 in fp32 at vc_tol = 1e-4;
  * the 22^3 pipeline: the golden row's ``%.5e`` digits.
"""

import dataclasses

import numpy as np
import pytest
import torch

import ndsm_tpu
import ndsm_tpu_torch
from ndsm_tpu.utils.testing import build_test_mesh, potential_field_case
from ndsm_tpu_torch import Options, convert
from ndsm_tpu_torch.mg.batched import MultiBCSolver
from ndsm_tpu_torch.mg.engine import MGEngine
from ndsm_tpu_torch.ops import compact
from ndsm_tpu_torch.ops import stencils_compact as sc

torch.set_num_threads(1)

COMPONENT_BCS = [
    tuple(("N", "N") if (2 - ax) == c else ("D", "D") for ax in range(3)) for c in range(3)
]
GOLDEN_22 = dict(Ea_max=1.86048e-03, Ea_avg=2.67773e-04, Eb_max=7.65805e-02, Eb_avg=6.53421e-03)


@pytest.fixture
def sweeps(monkeypatch):
    """Counts the calls of the colour-split sweep."""
    calls = []
    real = sc.rb_sweep_compact

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(sc, "rb_sweep_compact", counted)
    return calls


def _hierarchies(shape, ngrids=None):
    meshes = [np.linspace(0.0, 1.0, n) for n in shape]
    return (ndsm_tpu.GridHierarchy.from_mesh(meshes, ngrids=ngrids),
            ndsm_tpu_torch.GridHierarchy.from_mesh(meshes, ngrids=ngrids))


def _component_u0s(n, rng):
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


def test_engine_routes_by_level_and_bcs():
    """float32 3D levels that are not all-Neumann and have nx >= 4 take the
    compact route; the others keep the kernels they have under "auto"."""
    _, h = _hierarchies((12, 12, 12), ngrids=3)
    bcs = COMPONENT_BCS[0]
    x = torch.zeros(h.shapes[0], dtype=torch.float32)
    eng = MGEngine(h, bcs, ms=2, du_max=True, dtype=torch.float32, device="cpu",
                   smoother="compact")
    assert h.shapes[-1][-1] < 4
    routes = [eng._route(x, level) for level in range(h.ngrids)]
    assert routes[0] == "compact" and routes[-1] == "zc"
    assert routes == ["compact" if s[-1] >= 4 else "zc" for s in h.shapes]
    for smoother in ("auto", "masked"):
        e = MGEngine(h, bcs, ms=2, du_max=True, dtype=torch.float32, device="cpu",
                     smoother=smoother)
        assert e._route(x, 0) == "zc"
    e = MGEngine(h, (("N", "N"),) * 3, ms=2, du_max=True, dtype=torch.float32, device="cpu",
                 smoother="compact")
    assert e._route(x, 0) == "zc_mean"
    e = MGEngine(h, bcs, ms=2, du_max=True, dtype=torch.float64, device="cpu",
                 smoother="compact")
    assert e._route(x.double(), 0) is None
    _, h2 = _hierarchies((12, 12))
    e = MGEngine(h2, (("N", "N"),) * 2, ms=2, du_max=True, dtype=torch.float32, device="cpu",
                 smoother="compact")
    assert e._route(torch.zeros(h2.shapes[0]), 0) == "v2d"


@pytest.mark.parametrize("shape", [(12, 10, 14), (9, 8, 11)])
def test_engine_level_ops_equal_dense_route(shape, sweeps):
    _, h = _hierarchies(shape)
    bcs = (("D", "N"), ("N", "D"), ("D", "D"))
    rng = np.random.default_rng(0)
    u, rhs, cor = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
                   for _ in range(3))
    dense = MGEngine(h, bcs, ms=3, du_max=True, dtype=torch.float32, device="cpu")
    comp = MGEngine(h, bcs, ms=3, du_max=True, dtype=torch.float32, device="cpu",
                    smoother="compact")
    assert torch.equal(comp.t_smooth(u, rhs, 0), dense.t_smooth(u, rhs, 0))
    assert len(sweeps) == 3
    for g, w in zip(comp.t_smooth_residual(u, rhs, 0), dense.t_smooth_residual(u, rhs, 0)):
        assert torch.equal(g, w)
    assert torch.equal(comp.t_smooth_cor(u, cor, rhs, 0), dense.t_smooth_cor(u, cor, rhs, 0))
    assert len(sweeps) == 9
    for g, w in zip(comp.t_vcycle(u, rhs, 1e-6, 50), dense.t_vcycle(u, rhs, 1e-6, 50)):
        assert torch.equal(torch.as_tensor(g), torch.as_tensor(w))


@pytest.mark.parametrize("precision,vc_tol,atol", [("fp32", 1e-4, 1e-4), ("mixed", 1e-10, 5e-10)])
def test_poisson_bvp_compact_equals_auto_and_matches_jax(precision, vc_tol, atol, sweeps):
    shape, bcs = (16, 14, 13), (("D", "D"), ("N", "N"), ("N", "D"))
    rng = np.random.default_rng(1)
    rhs = rng.standard_normal(shape)
    u0 = np.zeros(shape)
    u0[0] = 0.3
    hj, ht = _hierarchies(shape)
    kw = dict(precision=precision, vc_tol=vc_tol)
    out = {}
    for smoother in ("auto", "compact"):
        n0 = len(sweeps)
        bvp = ndsm_tpu_torch.PoissonBVP(ht, bcs, Options(smoother=smoother, **kw), device="cpu")
        out[smoother] = bvp.solve(u0, rhs)
        assert (len(sweeps) > n0) == (smoother == "compact")
    (ua, ia), (uc, ic) = out["auto"], out["compact"]
    assert ia.ierr == ic.ierr == 0 and ia.cycles == ic.cycles
    assert ia.du_last == ic.du_last
    assert torch.equal(ua, uc)
    uj, ij = ndsm_tpu.PoissonBVP(hj, bcs, ndsm_tpu.Options(smoother="compact", **kw)).solve(
        u0, rhs)
    assert ij.ierr == 0 and abs(ij.cycles - ic.cycles) <= 1
    np.testing.assert_allclose(uc.numpy(), np.asarray(uj), rtol=0, atol=atol)


@pytest.mark.parametrize("precision", ["fp32", "mixed"])
def test_multibc_solver_compact_equals_auto(precision, sweeps):
    n = 14
    _, ht = _hierarchies((n, n, n))
    u0 = _component_u0s(n, np.random.default_rng(2))
    kw = dict(precision=precision, vc_tol=1e-4 if precision == "fp32" else 1e-10)
    out = {}
    for smoother in ("auto", "compact"):
        n0 = len(sweeps)
        mbs = MultiBCSolver(ht, COMPONENT_BCS, Options(smoother=smoother, **kw), device="cpu")
        assert mbs._compact == [smoother == "compact" and s[-1] >= 4 for s in ht.shapes]
        out[smoother] = mbs.solve(u0, names=["Ax", "Ay", "Az"])
        assert (len(sweeps) > n0) == (smoother == "compact")
    (ua, ia), (uc, ic) = out["auto"], out["compact"]
    for a, c in zip(ia, ic):
        assert a.ierr == c.ierr == 0 and a.cycles == c.cycles and a.du_last == c.du_last
    assert torch.equal(ua, uc)
    # and each lane follows the compact sequential solve to the batched contract
    for b, bcs in enumerate(COMPONENT_BCS):
        bvp = ndsm_tpu_torch.PoissonBVP(ht, bcs, Options(smoother="compact", **kw), device="cpu")
        us, info = bvp.solve(u0[b], None, zero_rhs=True)
        assert abs(info.cycles - ic[b].cycles) <= 1
        assert float((us - uc[b]).abs().max()) <= (1e-4 if precision == "fp32" else 5e-9)


@pytest.mark.parametrize("batch", ["off", "on"])
def test_pipeline_22_compact_golden_and_equal_auto(batch, sweeps):
    x, y, z = build_test_mesh(22)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    A1, b1 = potential_field_case(X, Y, Z)
    out = {}
    for smoother in ("auto", "compact"):
        n0 = len(sweeps)
        out[smoother] = ndsm_tpu_torch.vector_potential(
            x, y, z, b1.copy(), device="cpu", full_output=True,
            options=Options(precision="mixed", smoother=smoother, batch_components=batch))
        assert (len(sweeps) > n0) == (smoother == "compact")
    (ierr_a, A_a, B_a, info_a), (ierr, A, B, info) = out["auto"], out["compact"]
    assert ierr == ierr_a == 0
    assert np.array_equal(A, A_a) and np.array_equal(B, B_a)
    assert [s.cycles for s in info.components] == [s.cycles for s in info_a.components]
    assert [s.batch_size for s in info.components] == [3 if batch == "on" else 1] * 3
    Ea = np.linalg.norm(A1 - A, axis=0)
    Eb = np.linalg.norm(b1 - B, axis=0)
    for key, got in (("Ea_max", Ea.max()), ("Ea_avg", Ea.mean()),
                     ("Eb_max", Eb.max()), ("Eb_avg", Eb.mean())):
        assert f"{got:.5e}" == f"{GOLDEN_22[key]:.5e}", key


@pytest.mark.parametrize("smoother", ["auto", "masked", "compact"])
def test_smoother_option_carried_by_convert(smoother):
    ref = dataclasses.asdict(ndsm_tpu.Options(smoother=smoother, precision="mixed"))
    o = convert.options_from_reference(ref)
    assert o.smoother == smoother and o == Options(smoother=smoother, precision="mixed")


def test_unknown_smoother_raises():
    with pytest.raises(ValueError, match="smoother"):
        Options(smoother="bogus")
    with pytest.raises(ValueError, match="smoother"):
        convert.options_from_reference({"smoother": "zc"})


def test_dense_interface_is_what_the_engines_call(monkeypatch):
    """The engines reach the colour-split kernels only through ops/compact.py's
    dense interface: with it stubbed out, a compact solve fails, an "auto"
    solve does not."""
    def boom(*args, **kw):
        raise RuntimeError("compact route taken")

    monkeypatch.setattr(compact, "smooth_dense", boom)
    monkeypatch.setattr(compact, "smooth_residual_dense", boom)
    shape, bcs = (10, 10, 10), COMPONENT_BCS[1]
    _, ht = _hierarchies(shape)
    rhs = np.random.default_rng(3).standard_normal(shape)
    kw = dict(precision="fp32", vc_tol=1e-3, ms=1)
    ndsm_tpu_torch.PoissonBVP(ht, bcs, Options(**kw), device="cpu").solve(np.zeros(shape), rhs)
    with pytest.raises(RuntimeError, match="compact route taken"):
        ndsm_tpu_torch.PoissonBVP(ht, bcs, Options(smoother="compact", **kw),
                                  device="cpu").solve(np.zeros(shape), rhs)
    with pytest.raises(RuntimeError, match="compact route taken"):
        MultiBCSolver(ht, COMPONENT_BCS, Options(smoother="compact", **kw), device="cpu").solve(
            np.zeros((3,) + shape))
