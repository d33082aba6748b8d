"""ops/v2d.py (the 2D smoother kernel's module) and the 2D route through
the port's engine, against ndsm_tpu's Pallas v2d kernel run in interpret
mode on the CPU (``NDSM_TPU_PALLAS=interpret`` with the 2D kernel switched
on, as tests/test_v2d_engine.py runs it).

On the CPU the wrappers run their plain PyTorch versions; those are what
the CUDA kernel is held to bitwise on the card (the ``cuda``-marked test
below, and chip_smoke.py).

Tolerances:
  * mixed BCs, against the interpreted JAX kernel: <= 2 ulp of max|u| per
    sweep.  XLA:CPU may contract multiply-adds, the plain versions do not;
    with these weights (w = 2.04, 0.59) a contracted stencil sum moves a
    point by up to 2 ulp of max|u| in one sweep (measured: 2.0 at ns = 1,
    and the same 2 ulp between JAX's own rb_sweep and the plain version,
    which equals an exactly ordered numpy sweep).  The residual adds
    4*sum(w) times that (it amplifies an iterate difference by up to the
    stencil's diagonal).
  * all-Neumann: the per-sweep sum is also taken in another order than
    the JAX kernel's ``jnp.sum``, so <= 4 ulp of max|u| per sweep
    (measured: at most 3.0, at ns = 1).
  * engine and pipeline level: cycles within +-1 and u within 1e-9 of
    max(|u|, 1) (both stop at the vc_tol = 1e-10 contract); the 22^3
    golden digits exact, chi cycles within +-1 per face.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ndsm_tpu
import ndsm_tpu_torch
from ndsm_tpu.mg import poisson as jpoisson
from ndsm_tpu.ops import pallas_v2d
from ndsm_tpu_torch import ops
from ndsm_tpu_torch.ops import v2d

torch.set_num_threads(1)

DQ = np.array([0.7, 1.3])
ALL_N = (("N", "N"), ("N", "N"))
MIXED = (("D", "N"), ("N", "D"))


@pytest.fixture
def kernel_env(monkeypatch):
    """JAX routes float32 2D levels to its v2d kernel, interpreted."""
    monkeypatch.setenv("NDSM_TPU_PALLAS", "interpret")
    monkeypatch.setenv("NDSM_TPU_PALLAS_2D", "1")
    monkeypatch.setenv("NDSM_TPU_PALLAS2D_MIN_POINTS", "0")
    monkeypatch.setenv("NDSM_TPU_PALLAS_MIN_POINTS", "0")
    jpoisson._ENGINE_CACHE.clear()
    jpoisson._BVP_CACHE.clear()
    yield
    jpoisson._ENGINE_CACHE.clear()
    jpoisson._BVP_CACHE.clear()


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3))


def _ulps(got, want, ns):
    """max|got - want| in ulps of max|want|, per sweep."""
    return float(np.abs(got - want).max()) / float(np.spacing(np.abs(want).max())) / ns


def _t(a):
    return torch.as_tensor(a)


@pytest.mark.parametrize("lanes", [None, 6])
@pytest.mark.parametrize("bcs", [ALL_N, MIXED], ids=["all_neumann", "mixed_bc"])
@pytest.mark.parametrize("ns", [1, 3, 5])
@pytest.mark.parametrize("shape", [(40, 48), (22, 22)])
def test_matches_pallas_interpret(shape, ns, bcs, lanes):
    """Each of the three wrappers against its JAX kernel; the lane-stacked
    form against JAX's batch rule (jax.vmap of the kernel)."""
    full = shape if lanes is None else (lanes,) + shape
    u, r, c = _data(full, 0)
    kw = dict(interpret=True)
    fs = pallas_v2d.v2d_smooth(bcs, DQ, shape, ns, **kw)
    fr = pallas_v2d.v2d_smooth_residual(bcs, DQ, shape, ns, **kw)
    fc = pallas_v2d.v2d_smooth_cor(bcs, DQ, shape, ns, **kw)
    if lanes is not None:
        fs, fr, fc = jax.vmap(fs), jax.vmap(fr), jax.vmap(fc)
    ju, jr, jc = jnp.asarray(u), jnp.asarray(r), jnp.asarray(c)
    want_s = np.asarray(jax.jit(fs)(ju, jr))
    want_u, want_r = (np.asarray(a) for a in jax.jit(fr)(ju, jr))
    want_c = np.asarray(jax.jit(fc)(ju, jc, jr))

    got_s = v2d.v2d_smooth(_t(u), _t(r), DQ, bcs, ns).numpy()
    got_u, got_r = (a.numpy() for a in v2d.v2d_smooth_residual(_t(u), _t(r), DQ, bcs, ns))
    got_c = v2d.v2d_smooth_cor(_t(u), _t(c), _t(r), DQ, bcs, ns).numpy()

    per_sweep = 4.0 if bcs == ALL_N else 2.0
    assert _ulps(got_s, want_s, ns) <= per_sweep
    assert _ulps(got_u, want_u, ns) <= per_sweep
    assert _ulps(got_c, want_c, ns) <= per_sweep
    tol_r = (float(np.spacing(np.abs(want_r).max()))
             + 4 * float(np.sum(1 / DQ**2)) * per_sweep * ns
             * float(np.spacing(np.abs(want_u).max())))
    assert np.abs(got_r - want_r).max() <= tol_r


def test_lanes_are_independent_and_wrappers_functional():
    """A lane of the stacked call equals its standalone call bitwise; on a
    CPU tensor each wrapper IS its plain version, counts no launch and
    leaves its inputs untouched."""
    u, r, c = (_t(a) for a in _data((6, 22, 26), 1))
    u0 = u.clone()
    names = ("v2d_smooth", "v2d_smooth_residual", "v2d_smooth_cor")
    before = [ops.launch_counts()[k] for k in names]
    for bcs in (ALL_N, MIXED):
        s = v2d.v2d_smooth(u, r, DQ, bcs, 3)
        su, sr = v2d.v2d_smooth_residual(u, r, DQ, bcs, 3)
        sc = v2d.v2d_smooth_cor(u, c, r, DQ, bcs, 3)
        assert torch.equal(s, v2d.v2d_smooth_plain(u, r, DQ, bcs, 3))
        assert torch.equal(s, su)
        assert torch.equal(sc, v2d.v2d_smooth_cor_plain(u, c, r, DQ, bcs, 3))
        for k in range(6):
            assert torch.equal(v2d.v2d_smooth(u[k], r[k], DQ, bcs, 3), s[k])
            lu, lr = v2d.v2d_smooth_residual(u[k], r[k], DQ, bcs, 3)
            assert torch.equal(lu, su[k]) and torch.equal(lr, sr[k])
            assert torch.equal(v2d.v2d_smooth_cor(u[k], c[k], r[k], DQ, bcs, 3), sc[k])
    assert torch.equal(u, u0)
    assert before == [ops.launch_counts()[k] for k in names]


def test_all_neumann_mean_is_the_rounded_reciprocal_product():
    """After every all-Neumann sweep the state is u - sum(u) * f32(1/n):
    one sweep of v2d equals red_black followed by that subtraction."""
    from ndsm_tpu_torch.ops import reduce, stencils

    u, r, _ = (_t(a) for a in _data((30, 34), 2))
    swept = stencils.red_black(u, r, DQ, ALL_N)
    s = reduce.strided_block_sum(swept.reshape(1, -1))[0, 0]
    inv_n = float(np.float32(1.0 / (30 * 34)))
    assert torch.equal(v2d.v2d_smooth(u, r, DQ, ALL_N, 1), swept - s * inv_n)


def test_wrapper_input_checks():
    u = torch.zeros((5, 6))
    with pytest.raises(TypeError):
        v2d.v2d_smooth(u.double(), u.double(), DQ, ALL_N, 1)
    with pytest.raises(ValueError):
        v2d.v2d_smooth(u, torch.zeros((5, 7)), DQ, ALL_N, 1)
    with pytest.raises(ValueError):
        v2d.v2d_smooth(u.t(), u.t(), DQ, ALL_N, 1)
    with pytest.raises(ValueError):
        v2d.v2d_smooth(u, u, DQ, ALL_N, 0)
    with pytest.raises(ValueError):
        v2d.v2d_smooth(torch.zeros((2, 3, 4, 5)), torch.zeros((2, 3, 4, 5)), DQ, ALL_N, 1)
    with pytest.raises(ValueError):  # no silent route for an unsupported device
        v2d.v2d_smooth(u.to("meta"), u.to("meta"), DQ, ALL_N, 1)


# ----------------------------------------------------------------------
# Engine level: the solves of tests/test_v2d_engine.py
# ----------------------------------------------------------------------


def _hierarchies(meshes):
    return (ndsm_tpu.GridHierarchy.from_mesh(meshes),
            ndsm_tpu_torch.GridHierarchy.from_mesh(meshes))


def _check_solution(ut, uj):
    scale = max(np.abs(uj).max(), 1.0)
    assert np.abs(ut - uj).max() < 1e-9 * scale


@pytest.mark.parametrize("case", ["chi_style", "mixed_bc"])
def test_engine_solve_matches_jax_kernel(kernel_env, case):
    if case == "chi_style":
        meshes, bcs, seed = (np.linspace(0, 1, 40), np.linspace(0, 1.2, 48)), ALL_N, 0
    else:
        meshes, bcs, seed = (np.linspace(0, 1, 32), np.linspace(0, 1, 40)), MIXED, 2
    shape = tuple(len(m) for m in meshes)
    rng = np.random.default_rng(seed)
    rhs = rng.standard_normal(shape)
    if bcs == ALL_N:
        rhs -= rhs.mean()
    hj, ht = _hierarchies(meshes)
    uj, ij = ndsm_tpu.PoissonBVP(hj, bcs, ndsm_tpu.Options(precision="mixed")).solve(
        np.zeros(shape), rhs)
    bt = ndsm_tpu_torch.PoissonBVP(ht, bcs, ndsm_tpu_torch.Options(precision="mixed"),
                                   device="cpu")
    assert bt._inner.kernel_route == "v2d"
    assert all(bt._inner._route(torch.zeros(s), lv) == "v2d"
               for lv, s in enumerate(ht.shapes[:-1]))
    ut, it = bt.solve(np.zeros(shape), rhs)
    assert ij.ierr == it.ierr == 0
    assert abs(ij.cycles - it.cycles) <= 1
    _check_solution(ut.numpy(), np.asarray(uj))


def test_engine_solve_batch_matches_jax_kernel(kernel_env):
    meshes = (np.linspace(0, 1, 40), np.linspace(0, 1.2, 48))
    shape = (40, 48)
    rng = np.random.default_rng(1)
    rhss = []
    for _ in range(4):
        r = rng.standard_normal(shape)
        rhss.append(r - r.mean())
    u0s = [np.zeros(shape)] * 4
    hj, ht = _hierarchies(meshes)
    uj, ij = ndsm_tpu.PoissonBVP(hj, ALL_N, ndsm_tpu.Options(precision="mixed")).solve_batch(
        u0s, rhss)
    ut, it = ndsm_tpu_torch.PoissonBVP(ht, ALL_N, ndsm_tpu_torch.Options(precision="mixed"),
                                       device="cpu").solve_batch(u0s, rhss)
    for a, b, ia, ib in zip(uj, ut, ij, it):
        assert ia.ierr == ib.ierr == 0
        assert abs(ia.cycles - ib.cycles) <= 1
        _check_solution(b.numpy(), np.asarray(a))


# ----------------------------------------------------------------------
# The slice as a whole: the chi phase of vector_potential through v2d
# ----------------------------------------------------------------------


def test_vector_potential_22_matches_jax_with_2d_kernel(kernel_env):
    from ndsm_tpu.utils.testing import build_test_mesh, potential_field_case

    x, y, z = build_test_mesh(22)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    A1, b1 = potential_field_case(X, Y, Z)
    ierr, A, B, info = ndsm_tpu_torch.vector_potential(
        x, y, z, b1.copy(), precision="mixed", device="cpu", full_output=True)
    ierr_j, A_j, B_j, info_j = ndsm_tpu.vector_potential(
        x, y, z, b1.copy(), precision="mixed", full_output=True)
    assert ierr == ierr_j == 0
    ea = np.linalg.norm(A1 - A, axis=0).max()
    eb = np.linalg.norm(b1 - B, axis=0).max()
    assert f"{ea:.5e}" == "1.86048e-03" and f"{eb:.5e}" == "7.65805e-02"
    for s, sj in zip(info.chi, info_j.chi):
        assert s.name == sj.name and abs(s.cycles - sj.cycles) <= 1, s.name
    assert np.abs(A - A_j).max() < 1e-9 and np.abs(B - B_j).max() < 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("bcs", [ALL_N, MIXED], ids=["all_neumann", "mixed_bc"])
def test_cuda_kernel_bitwise_plain(bcs):
    """On the card: the kernel equals its plain version bitwise, one lane
    and six: one block a lane, a cluster of blocks a lane (220^2, 512^2,
    odd extents, the one-block/cluster boundary at 168^2/169^2) and the
    global route of lanes past a 16-block cluster."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for shape in ((37, 45), (6, 37, 45), (220, 220), (6, 220, 220), (3, 221, 219),
                  (168, 168), (169, 169), (2, 512, 512), (33, 1001), (700, 700)):
        u, r, c = (_t(a).cuda() for a in _data(shape, 5))
        for ns in (1, 2, 5):
            assert torch.equal(v2d.v2d_smooth(u, r, DQ, bcs, ns),
                               v2d.v2d_smooth_plain(u, r, DQ, bcs, ns))
            for a, b in zip(v2d.v2d_smooth_residual(u, r, DQ, bcs, ns),
                            v2d.v2d_smooth_residual_plain(u, r, DQ, bcs, ns)):
                assert torch.equal(a, b)
            assert torch.equal(v2d.v2d_smooth_cor(u, c, r, DQ, bcs, ns),
                               v2d.v2d_smooth_cor_plain(u, c, r, DQ, bcs, ns))
