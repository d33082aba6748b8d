"""parallel/sm_engine.py (ShardedPoissonBVP) of the port against ndsm_tpu's,
and against the port's own single-device PoissonBVP.

The port's mesh is ``devices=["cpu"] * k``, JAX's ``make_mesh(k)`` on its
virtual CPU devices (tests/conftest.py).  Tolerances:
  * fp64: equal cycles, atol 1e-12 (the two engines sum the transfers and
    metrics in other orders);
  * mixed: cycles within 2, atol 5e-10 (as tests/test_pallas_df.py: on the
    CPU JAX runs the scaled float64 defect, the port its per-shard
    float64 defect with the unscaled semantics of the df path);
  * the lane-masked 2D all-Neumann solve_batch: per lane equal cycles and
    atol 1e-10 on the mean-free solutions against JAX; against the port's
    own standalone sharded solves, equal cycles and atol 1e-14 (fp64);
  * against the port's PoissonBVP: equal cycles and atol 1e-12 (fp64),
    cycles within 1 and atol 5e-10 (mixed);
  * the one-level ``make_sharded_sweep`` / ``make_sharded_residual``
    (tests/test_dist.py:29-75's cases, 8 shards, float64): atol 1e-12
    (1e-11 after four sweeps) against JAX's single-device sweep and
    residual, as there; bitwise against the port's unsharded ones where no
    mean is taken (the all-Neumann mean sums in another order);
  * the port's per-shard float64 defect loop against JAX's sharded df path
    (``_mixed_group_df``: its per-shard double-float kernel, run in
    interpret mode) on a 1-D and a 2 x 2 mesh: cycles within 2, atol
    5e-10 (JAX's outer iterate is an f32 pair, the port's float64).
"""

import numpy as np
import pytest
import torch

import ndsm_tpu
from ndsm_tpu.parallel.shard import make_mesh as j_make_mesh, make_mesh_nd as j_make_mesh_nd
from ndsm_tpu.parallel.sm_engine import ShardedPoissonBVP as JSharded
from ndsm_tpu_torch import GridHierarchy, Options, PoissonBVP
from ndsm_tpu_torch.parallel.shard import make_mesh, make_mesh_nd
from ndsm_tpu.ops import stencils as j_stencils
from ndsm_tpu_torch.ops import stencils
from ndsm_tpu_torch.parallel import collectives as C
from ndsm_tpu_torch.parallel.sm_engine import (
    ShardedPoissonBVP,
    make_sharded_residual,
    make_sharded_sweep,
)

torch.set_num_threads(1)

BCS3 = (("D", "D"), ("N", "N"), ("D", "N"))


def _problem(n=32, seed=0):
    x = np.linspace(0.0, 1.0, n)
    rng = np.random.default_rng(seed)
    return x, rng.standard_normal((n, n, n))


def _port(h, bcs, opts, k, **kw):
    return ShardedPoissonBVP(h, bcs, opts, mesh=make_mesh(k, devices=["cpu"] * k),
                             min_rows_per_shard=2, **kw)


@pytest.fixture(scope="module")
def case3d():
    """(x, rhs, JAX results) of the 3D problem: fp64 over 8 shards and
    mixed over 4."""
    x, rhs = _problem()
    jh = ndsm_tpu.GridHierarchy.from_mesh((x, x, x))
    out = {}
    for prec, k in (("fp64", 8), ("mixed", 4)):
        sb = JSharded(jh, BCS3, ndsm_tpu.Options(precision=prec), mesh=j_make_mesh(k),
                      min_rows_per_shard=2)
        u, info = sb.solve(np.zeros_like(rhs), rhs)
        out[prec] = (np.asarray(u), info)
    return x, rhs, out


@pytest.mark.parametrize("prec,k", [("fp64", 8), ("mixed", 4)])
def test_matches_jax_sharded(case3d, prec, k):
    x, rhs, jax_out = case3d
    u_j, info_j = jax_out[prec]
    h = GridHierarchy.from_mesh((x, x, x))
    sb = _port(h, BCS3, Options(precision=prec), k)
    assert sb.seam >= 2 and sb.df_defect == (prec == "mixed")
    u, info = sb.solve(np.zeros_like(rhs), rhs)
    assert info.ierr == 0 == info_j.ierr
    if prec == "fp64":
        assert info.cycles == info_j.cycles
        np.testing.assert_allclose(u.numpy(), u_j, rtol=0, atol=1e-12)
    else:
        assert abs(info.cycles - info_j.cycles) <= 2
        np.testing.assert_allclose(u.numpy(), u_j, rtol=0, atol=5e-10)


@pytest.mark.parametrize("prec,k", [("fp64", 8), ("mixed", 4), ("mixed", 8)])
def test_matches_port_single_device(case3d, prec, k):
    x, rhs, _ = case3d
    h = GridHierarchy.from_mesh((x, x, x))
    opts = Options(precision=prec)
    u, info = _port(h, BCS3, opts, k).solve(np.zeros_like(rhs), rhs)
    # the sharded engine solves the coarsest level directly (as JAX's does)
    ref = PoissonBVP(h, BCS3, Options(precision=prec, coarse_solver="direct"), device="cpu")
    u_r, info_r = ref.solve(np.zeros_like(rhs), rhs)
    if prec == "fp64":
        assert info.cycles == info_r.cycles
        np.testing.assert_allclose(u.numpy(), u_r.numpy(), rtol=0, atol=1e-12)
    else:
        assert abs(info.cycles - info_r.cycles) <= 1
        np.testing.assert_allclose(u.numpy(), u_r.numpy(), rtol=0, atol=5e-10)


def test_pass_widths_and_level_plan():
    """Widths follow the blocks: 2 on >= 6 planes, 1 on 4-5, the plain
    route below 4 and on float64 levels."""
    x = np.linspace(0.0, 1.0, 48)
    h = GridHierarchy.from_mesh((x, x, x))
    sb = _port(h, BCS3, Options(precision="mixed"), 8)
    f32, f64 = torch.zeros((), dtype=torch.float32), torch.zeros((), dtype=torch.float64)
    assert sb.seam == 2  # 48/8 = 6 planes, 24/8 = 3 planes, 12 does not divide
    assert [sb._pass_width(l, f32) for l in range(2)] == [2, 0]
    assert sb._pass_width(0, f64) == 0
    sb4 = _port(h, BCS3, Options(precision="mixed"), 4)
    assert sb4.seam == 3 and [sb4._pass_width(l, f32) for l in range(3)] == [2, 2, 0]
    x = np.linspace(0.0, 1.0, 40)
    sb5 = _port(GridHierarchy.from_mesh((x, x, x)), BCS3, Options(precision="mixed"), 8)
    assert sb5._pass_width(0, f32) == 1  # 5 planes
    with pytest.raises(ValueError):  # 8 does not divide 44's extent
        _port(GridHierarchy.from_mesh((np.linspace(0, 1, 44),) * 3), BCS3, Options(), 8)
    with pytest.raises(ValueError, match="no axis 'y'"):  # the 1-D mesh lacks "y"
        ShardedPoissonBVP(h, BCS3, Options(), mesh=make_mesh(2, devices=["cpu"] * 2),
                          axis_names=("z", "y"))


def test_all_neumann_3d(case3d):
    """3D all-Neumann levels take the plain sharded route with the global
    mean; mean-free solutions agree with the port's PoissonBVP."""
    x, rhs, _ = case3d
    rhs = rhs - rhs.mean()
    bcs = (("N", "N"),) * 3
    h = GridHierarchy.from_mesh((x, x, x))
    for prec in ("fp64", "mixed"):
        opts = Options(precision=prec, vc_tol=1e-9, coarse_solver="direct")
        u, info = _port(h, bcs, opts, 4).solve(np.zeros_like(rhs), rhs)
        u_r, info_r = PoissonBVP(h, bcs, opts, device="cpu").solve(np.zeros_like(rhs), rhs)
        assert info.ierr == 0 and abs(info.cycles - info_r.cycles) <= 1
        a, b = u.numpy(), u_r.numpy()
        np.testing.assert_allclose(a - a.mean(), b - b.mean(), rtol=0, atol=1e-8)


@pytest.fixture(scope="module")
def chi_batch():
    """Three compatible 2D all-Neumann problems (the chi faces' form) and
    JAX's lane-masked sharded solve_batch of them over 4 shards."""
    n = 24
    x = np.linspace(0.0, 1.0, n)
    rng = np.random.default_rng(8)
    rhss = [r - r.mean() for r in rng.standard_normal((3, n, n))]
    u0s = [np.zeros((n, n))] * 3
    out = {}
    for prec in ("fp64", "mixed"):
        opts = ndsm_tpu.Options(precision=prec, vc_tol=1e-8, ncycles_max=60)
        sb = JSharded(ndsm_tpu.GridHierarchy.from_mesh((x, x)), (("N", "N"),) * 2, opts,
                      mesh=j_make_mesh(4), min_rows_per_shard=2)
        us, infos = sb.solve_batch(u0s, rhss, names=["a", "b", "c"])
        out[prec] = ([np.asarray(u) for u in us], infos)
    return x, u0s, rhss, out


@pytest.mark.parametrize("prec", ["fp64", "mixed"])
def test_solve_batch_2d_all_neumann(chi_batch, prec):
    x, u0s, rhss, jax_out = chi_batch
    us_j, infos_j = jax_out[prec]
    opts = Options(precision=prec, vc_tol=1e-8, ncycles_max=60)
    sb = _port(GridHierarchy.from_mesh((x, x)), (("N", "N"),) * 2, opts, 4)
    us, infos = sb.solve_batch(u0s, rhss, names=["a", "b", "c"])
    for k in range(3):
        assert infos[k].ierr == 0 and infos[k].batch_size == 3 and infos[k].name == "abc"[k]
        assert abs(infos[k].cycles - infos_j[k].cycles) <= (0 if prec == "fp64" else 2)
        a = us[k].numpy()
        np.testing.assert_allclose(a - a.mean(), us_j[k] - us_j[k].mean(), rtol=0,
                                   atol=1e-10 if prec == "fp64" else 5e-9)
        # each lane follows its standalone sharded solve (converged lanes frozen)
        u_s, info_s = sb.solve(u0s[k], rhss[k])
        assert info_s.cycles == infos[k].cycles
        np.testing.assert_allclose(a, u_s.numpy(), rtol=0,
                                   atol=1e-14 if prec == "fp64" else 1e-9)


def test_zero_rhs_and_output_dtype():
    n = 16
    x = np.linspace(0.0, 1.0, n)
    bcs = (("N", "N"), ("D", "D"), ("D", "D"))
    u0 = np.zeros((n, n, n))
    u0[:, 0, :] = 1.0  # inhomogeneous Dirichlet data carried in u0
    jopts = ndsm_tpu.Options(precision="mixed", vc_tol=1e-8, ncycles_max=40)
    jsb = JSharded(ndsm_tpu.GridHierarchy.from_mesh((x, x, x), ngrids=2), bcs, jopts,
                   mesh=j_make_mesh(4), min_rows_per_shard=2)
    u_j, info_j = jsb.solve(u0, None, zero_rhs=True)
    opts = Options(precision="mixed", vc_tol=1e-8, ncycles_max=40)
    sb = _port(GridHierarchy.from_mesh((x, x, x), ngrids=2), bcs, opts, 4)
    u_a, ia = sb.solve(u0, np.zeros_like(u0))
    u_b, ib = sb.solve(u0, None, zero_rhs=True)
    assert torch.equal(u_a, u_b) and ia.cycles == ib.cycles
    assert abs(ib.cycles - info_j.cycles) <= 2
    np.testing.assert_allclose(u_b.numpy(), np.asarray(u_j), rtol=0, atol=5e-10)
    u_d, _ = sb.solve(u0, None, zero_rhs=True, output_dtype="float32")
    assert u_d.dtype == torch.float32 and torch.equal(u_d, u_b.float())


@pytest.mark.parametrize("grid", [(4,), (2, 2)])
def test_df_matches_jax_interpret_df(monkeypatch, grid):
    """The port's sharded mixed solve (per-shard float64 defect, B11 / B11y)
    against JAX's sharded df path, its kernels in interpret mode (at 32^3 on
    the 2 x 2 mesh: JAX's kernel takes no smaller y block there)."""
    n = 24 if len(grid) == 1 else 32
    x = np.linspace(0.0, 1.0, n)
    rng = np.random.default_rng(11)
    rhs = rng.standard_normal((n, n, n))
    names = ("z", "y")[: len(grid)]
    monkeypatch.setenv("NDSM_TPU_PALLAS", "interpret")
    monkeypatch.setenv("NDSM_TPU_PALLAS_MIN_POINTS", "0")
    jmesh = j_make_mesh(grid[0]) if len(grid) == 1 else j_make_mesh_nd(grid, names)
    jsb = JSharded(ndsm_tpu.GridHierarchy.from_mesh((x, x, x), ngrids=3), BCS3,
                   ndsm_tpu.Options(precision="mixed"), mesh=jmesh, axis_names=names,
                   min_rows_per_shard=2)
    assert jsb.df_defect and jsb._df_upd is not None
    u_j, info_j = jsb.solve(np.zeros_like(rhs), rhs)
    k = int(np.prod(grid))
    sb = ShardedPoissonBVP(GridHierarchy.from_mesh((x, x, x), ngrids=3), BCS3,
                           Options(precision="mixed"),
                           mesh=make_mesh_nd(grid, names, devices=["cpu"] * k), axis_names=names,
                           min_rows_per_shard=2)
    assert sb.df_defect
    u, info = sb.solve(np.zeros_like(rhs), rhs)
    assert info.ierr == 0 == info_j.ierr
    assert abs(info.cycles - info_j.cycles) <= 2
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=0, atol=5e-10)


BCS_CASES = [
    (("N", "N"), ("N", "N"), ("N", "N")),
    (("D", "D"), ("D", "D"), ("N", "N")),
    (("D", "N"), ("N", "D"), ("D", "D")),
]


def _one_level(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape), rng.standard_normal(shape)


@pytest.mark.parametrize("bcs", BCS_CASES)
def test_sharded_sweep_matches_single_device(bcs):
    shape, dq = (16, 9, 11), np.array([0.7, 1.1, 0.9])
    u, rhs = _one_level(shape, 3)
    mesh = make_mesh(8, devices=["cpu"] * 8)
    f, place = make_sharded_sweep(shape, bcs, dq, mesh, dtype=torch.float64)
    got = C.unshard(f(place(u), place(rhs)), mesh.devices, 0)
    want = np.asarray(j_stencils.rb_sweep(u, rhs, dq, bcs))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    if not stencils.is_all_neumann(bcs):
        assert torch.equal(got, stencils.rb_sweep(torch.as_tensor(u), torch.as_tensor(rhs),
                                                  dq, bcs))


def test_sharded_sweep_iterated():
    shape, dq = (24, 12, 12), np.array([1.0, 1.0, 1.0])
    bcs = (("D", "D"), ("N", "N"), ("N", "N"))
    u, rhs = _one_level(shape, 4)
    mesh = make_mesh(8, devices=["cpu"] * 8)
    f, place = make_sharded_sweep(shape, bcs, dq, mesh, dtype=torch.float64)
    want, got, rs = u, place(u), place(rhs)
    for _ in range(4):
        want = j_stencils.rb_sweep(want, rhs, dq, bcs)
        got = f(got, rs)
    np.testing.assert_allclose(C.unshard(got, mesh.devices, 0).numpy(), np.asarray(want),
                               rtol=0, atol=1e-11)


@pytest.mark.parametrize("bcs", BCS_CASES[:2])
def test_sharded_residual_matches(bcs):
    shape, dq = (16, 9, 11), np.array([0.8, 1.0, 1.2])
    u, rhs = _one_level(shape, 5)
    mesh = make_mesh(8, devices=["cpu"] * 8)
    f, place = make_sharded_residual(shape, bcs, dq, mesh, dtype=torch.float64)
    got = C.unshard(f(place(u), place(rhs)), mesh.devices, 0)
    want = np.asarray(j_stencils.poisson_residual(u, rhs, dq, bcs))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    assert torch.equal(got, stencils.poisson_residual(torch.as_tensor(u),
                                                      torch.as_tensor(rhs), dq, bcs))
    with pytest.raises(ValueError):  # 8 shards of 12 planes do not divide
        make_sharded_residual((12, 9, 11), bcs, dq, mesh)
