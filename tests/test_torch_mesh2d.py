"""The 2-D (z, y) shard mesh of the port: parallel/shard.py's mesh geometry,
parallel/collectives.py over two partitioned axes, parallel/sm_engine.py
(ShardedPoissonBVP with ``axis_names=("z", "y")``) against ndsm_tpu's
two-axis engine and the port's own solvers, and ``vector_potential`` with a
(z, y) ``DistConfig``.

The port's meshes are ``make_mesh_nd(shape, ("z", "y"), devices=["cpu"] *
k)``, JAX's ``make_mesh_nd(shape, ("z", "y"))`` on its virtual CPU devices
(tests/conftest.py).  Tolerances:
  * geometry, halo content (corners included), cut and join: exact;
  * one V-cycle's messages and bytes: exactly the model computed from the
    level plan;
  * the engine against JAX's (tests/test_dist.py:322's case, 4 x 2):
    fp64 equal cycles and atol 1e-12; mixed cycles within 2 and atol
    5e-10 (on the CPU JAX runs its scaled float64 defect there);
  * against the port's PoissonBVP: fp64 equal cycles, atol 1e-12; mixed
    cycles within 1, atol 5e-10; against the port's 1-D sharded solve:
    equal cycles and atol 1e-12 (the per-axis transfer blocks sum in the
    same order; measured 0.0);
  * ``vector_potential`` over a 2 x 2 mesh, mixed, 16^3: A within 5e-9 and
    B within 5e-8 of JAX's same call and of the port's single-device call;
    the chi faces (2D, partitioned in z on the mesh's z line) bitwise equal
    to a ``make_mesh(2)`` run; at 22^3 the golden digits exact.
"""

import numpy as np
import pytest
import torch

import ndsm_tpu
from ndsm_tpu.ops.transfer import interp_matrix_1d as j_interp, restrict_matrix_1d as j_restrict
from ndsm_tpu.parallel import sm_engine as jsm
from ndsm_tpu.parallel.shard import DistConfig as JDist, make_mesh_nd as j_make_mesh_nd
from ndsm_tpu.utils.testing import build_test_mesh, potential_field_case
from ndsm_tpu_torch import GridHierarchy, Options, PoissonBVP, vector_potential
from ndsm_tpu_torch.parallel import collectives as C
from ndsm_tpu_torch.parallel.shard import DistConfig, make_mesh, make_mesh_nd
from ndsm_tpu_torch.parallel.sm_engine import ShardedPoissonBVP
from ndsm_tpu_torch.potential.vector_potential import _dist_bvp

torch.set_num_threads(1)

GRIDS = [(2, 2), (4, 2)]


def _mesh(grid):
    return make_mesh_nd(grid, ("z", "y"), devices=["cpu"] * int(np.prod(grid)))


def test_mesh_geometry():
    m = make_mesh_nd((4, 2), ("z", "y"), devices=["cpu"] * 8)
    assert [m.coords(i) for i in (0, 1, 2, 7)] == [(0, 0), (0, 1), (1, 0), (3, 1)]
    assert all(m.index(m.coords(i)) == i for i in range(8))
    assert m.lines("z") == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert m.lines("y") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    # a third mesh axis: the engine's sub-mesh at index 0 of the others
    devs = [f"cpu:{i}" for i in range(12)]
    m3 = make_mesh_nd((3, 2, 2), ("r", "z", "y"), devices=devs)
    sub = m3.submesh(("z", "y"))
    assert sub.shape == (2, 2) and sub.axis_names == ("z", "y")
    assert [d.index for d in sub.devices] == [0, 1, 2, 3]
    yz = m3.submesh(("y", "r"))  # names in another order than the mesh's
    assert yz.shape == (2, 3) and [d.index for d in yz.devices] == [0, 4, 8, 1, 5, 9]
    assert [d for d in m.submesh(("z",)).devices] == [m.devices[i] for i in (0, 2, 4, 6)]
    with pytest.raises(ValueError, match="no axis"):
        m.submesh(("x",))


def _reflect(g, n):
    return np.where(g < 0, -g, np.where(g > n - 1, 2 * (n - 1) - g, g))


@pytest.mark.parametrize("grid", GRIDS)
def test_extend_block_corners(grid):
    """z then y extension of the blocks equals the index reflection of the
    whole array, corners included (the diagonal neighbours' values, or
    their mirrors at the global ends)."""
    rng = np.random.default_rng(sum(grid))
    mesh = _mesh(grid)
    for lz, ly in ((4, 5), (6, 3)):
        v = rng.standard_normal((grid[0] * lz, grid[1] * ly, 3))
        blocks = C.shard(torch.as_tensor(v), mesh.devices, 0, grid)
        for d in range(1, min(lz, ly)):
            ext = C.extend_block(blocks, mesh.devices, 0, d, mesh.lines("z"))
            ext = C.extend_block(ext, mesh.devices, 1, d, mesh.lines("y"))
            for i, got in enumerate(ext):
                iz, iy = mesh.coords(i)
                gz = _reflect(np.arange(iz * lz - d, (iz + 1) * lz + d), v.shape[0])
                gy = _reflect(np.arange(iy * ly - d, (iy + 1) * ly + d), v.shape[1])
                assert np.array_equal(got.numpy(), v[np.ix_(gz, gy)])


@pytest.mark.parametrize("grid", GRIDS)
def test_cut_join_and_counts(grid):
    mesh = _mesh(grid)
    n = int(np.prod(grid))
    full = torch.arange(float(grid[0] * 3 * grid[1] * 2 * 5)).reshape(grid[0] * 3,
                                                                       grid[1] * 2, 5)
    blocks = C.shard(full, mesh.devices, 0, grid)
    for i, b in enumerate(blocks):
        iz, iy = mesh.coords(i)
        assert torch.equal(b, full[iz * 3:(iz + 1) * 3, iy * 2:(iy + 1) * 2])
    C.reset_counts()
    assert torch.equal(C.unshard(blocks, mesh.devices, 0, grid), full)
    assert C.counts() == {"messages": 0, "bytes": 0}
    got = C.scatter(full, mesh.devices, 0, grid)
    assert all(torch.equal(a, b) for a, b in zip(got, blocks))
    assert torch.equal(C.all_gather(got, mesh.devices, 0, grid), full)
    assert C.counts() == {"messages": 2 * (n - 1), "bytes": 2 * (n - 1) * 3 * 2 * 5 * 4}
    # lanes before the partitioned axes
    lanes = torch.stack([full, -full])
    assert torch.equal(C.unshard(C.shard(lanes, mesh.devices, 1, grid), mesh.devices, 1, grid),
                       lanes)


def _model(h, grid, min_rows, ms, itemsize):
    """Messages and bytes of one V-cycle on a mesh of shape ``grid`` over
    the leading array axes, from the level plan: sharded levels, each
    level's smoothing route and pass width (from its smallest partitioned
    block extent), the exchanges along each partitioned axis (one line a
    combination of the other coordinates; the y stage on the z-extended
    blocks), the transfer halos of the JAX engine's blocks, and the seam's
    gather and scatter."""
    k, n = len(grid), int(np.prod(grid))
    seam = 0
    for shape in h.shapes[: h.ngrids - 1]:
        if any(shape[a] % g or shape[a] < g * min_rows for a, g in enumerate(grid)):
            break
        seam += 1
    tot = [0, 0]

    def local(l):
        return [s // g for s, g in zip(h.shapes[l], grid)] + list(h.shapes[l][k:])

    def exchange(ax, depth, block):
        msgs = n // grid[ax] * 2 * (grid[ax] - 1)
        tot[0] += msgs
        tot[1] += msgs * depth * int(np.prod(block)) // block[ax] * itemsize

    def extend(depth, block):
        block = list(block)
        for ax in range(k):
            exchange(ax, depth, block)
            block[ax] += 2 * depth

    def smooth(l, nsw, residual):
        b = local(l)
        m = min(b[:k])
        width = 0 if itemsize == 8 else 2 if m >= 6 else 1 if m >= 4 else 0
        if not width:
            for _ in range(2 * nsw + (1 if residual else 0)):
                for ax in range(k):
                    exchange(ax, 1, b)
            return
        ns_star = min(nsw, width)
        if residual:
            last = nsw % ns_star or ns_star
            depths = [2 * ns_star] * ((nsw - last) // ns_star) + [2 * last + 1]
        else:
            depths = [2 * ns_star] * (nsw // ns_star) + ([2 * (nsw % ns_star)]
                                                         if nsw % ns_star else [])
        for d in depths + sorted(set(depths)):  # u every pass, rhs once a depth
            extend(d, b)

    def transfer(l_in, l_out, mats):
        block = local(l_in)
        for ax in range(k):
            _, H = jsm._axis_blocks(mats[ax], grid[ax])
            if H:
                exchange(ax, H, block)
            block[ax] = local(l_out)[ax]

    for l in range(min(seam, h.ngrids - 1)):
        smooth(l, ms, True)
        fine, coarse = h.meshes[l], h.meshes[l + 1]
        if l + 1 < seam:
            transfer(l, l + 1, [j_restrict(c, f) for f, c in zip(fine, coarse)])
            transfer(l + 1, l, [j_interp(f, c) for f, c in zip(fine, coarse)])
            smooth(l + 1, ms, False)
        else:
            tot[0] += 2 * (n - 1)
            tot[1] += 2 * (n - 1) * int(np.prod(local(l))) * itemsize
        smooth(l, ms, False)
    return seam, tot[0], tot[1]


@pytest.mark.parametrize("precision", ["fp32", "fp64"])
@pytest.mark.parametrize("grid", GRIDS)
def test_vcycle_message_model(grid, precision):
    n = 48
    x = np.linspace(0.0, 1.0, n)
    h = GridHierarchy.from_mesh((x, x, x))
    bcs = (("D", "D"), ("N", "N"), ("D", "N"))
    opts = Options(precision=precision)
    sb = ShardedPoissonBVP(h, bcs, opts, mesh=_mesh(grid), axis_names=("z", "y"),
                           min_rows_per_shard=2)
    itemsize = 4 if precision == "fp32" else 8
    seam, msgs, nbytes = _model(h, grid, 2, opts.ms, itemsize)
    assert sb.seam == seam >= 2
    rng = np.random.default_rng(sum(grid))
    dt = sb.inner_dtype
    u = C.shard(torch.zeros((n, n, n), dtype=dt), sb.devices, 0, grid)
    rhs = C.shard(torch.as_tensor(rng.standard_normal((n, n, n)), dtype=dt), sb.devices, 0,
                  grid)
    C.reset_counts()
    sb._vcycle(u, rhs, 1e-13, 100)
    assert C.counts() == {"messages": msgs, "bytes": nbytes}
    # the 1-D model is the same function of a one-axis grid
    sb1 = ShardedPoissonBVP(h, bcs, opts, mesh=make_mesh(grid[0], devices=["cpu"] * grid[0]),
                            min_rows_per_shard=2)
    _, msgs1, nbytes1 = _model(h, grid[:1], 2, opts.ms, itemsize)
    u1 = C.shard(torch.zeros((n, n, n), dtype=dt), sb1.devices, 0)
    rhs1 = C.shard(torch.as_tensor(rng.standard_normal((n, n, n)), dtype=dt), sb1.devices, 0)
    C.reset_counts()
    sb1._vcycle(u1, rhs1, 1e-13, 100)
    assert C.counts() == {"messages": msgs1, "bytes": nbytes1}


BCS = (("D", "D"), ("N", "N"), ("D", "D"))


@pytest.fixture(scope="module")
def case():
    """tests/test_dist.py:322's problem and JAX's 4 x 2 results."""
    n = 32
    x = np.linspace(0.0, 1.0, n)
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    U = np.sin(np.pi * X) * np.sin(np.pi * Y) * np.sin(np.pi * Z)
    rhs = -3 * np.pi**2 * U
    jh = ndsm_tpu.GridHierarchy.from_mesh((x, x, x))
    out = {}
    for prec in ("fp64", "mixed"):
        sb = jsm.ShardedPoissonBVP(jh, BCS, ndsm_tpu.Options(precision=prec),
                                   mesh=j_make_mesh_nd((4, 2), ("z", "y")),
                                   axis_names=("z", "y"), min_rows_per_shard=2)
        u, info = sb.solve(np.zeros_like(U), rhs)
        out[prec] = (np.asarray(u), info)
    return x, rhs, out


@pytest.mark.parametrize("prec", ["fp64", "mixed"])
def test_engine_matches_jax_two_axis(case, prec):
    x, rhs, jax_out = case
    u_j, info_j = jax_out[prec]
    h = GridHierarchy.from_mesh((x, x, x))
    sb = ShardedPoissonBVP(h, BCS, Options(precision=prec), mesh=_mesh((4, 2)),
                           axis_names=("z", "y"), min_rows_per_shard=2)
    assert sb.seam >= 2 and sb.grid == (4, 2) and sb.df_defect == (prec == "mixed")
    u, info = sb.solve(np.zeros_like(rhs), rhs)
    assert info.ierr == 0 == info_j.ierr
    if prec == "fp64":
        assert info.cycles == info_j.cycles
        np.testing.assert_allclose(u.numpy(), u_j, rtol=0, atol=1e-12)
    else:
        assert abs(info.cycles - info_j.cycles) <= 2
        np.testing.assert_allclose(u.numpy(), u_j, rtol=0, atol=5e-10)


@pytest.mark.parametrize("prec", ["fp64", "mixed"])
def test_engine_matches_port(case, prec):
    """Against PoissonBVP and the 1-D sharded solve; also the engine on a
    larger mesh's sub-mesh (a third mesh axis at index 0)."""
    x, rhs, _ = case
    h = GridHierarchy.from_mesh((x, x, x))
    opts = Options(precision=prec)
    sb = ShardedPoissonBVP(h, BCS, opts, mesh=_mesh((2, 2)), axis_names=("z", "y"),
                           min_rows_per_shard=2)
    u, info = sb.solve(np.zeros_like(rhs), rhs)
    ref = PoissonBVP(h, BCS, Options(precision=prec, coarse_solver="direct"), device="cpu")
    u_r, info_r = ref.solve(np.zeros_like(rhs), rhs)
    assert abs(info.cycles - info_r.cycles) <= (0 if prec == "fp64" else 1)
    np.testing.assert_allclose(u.numpy(), u_r.numpy(), rtol=0,
                               atol=1e-12 if prec == "fp64" else 5e-10)
    u1, info1 = ShardedPoissonBVP(h, BCS, opts, mesh=make_mesh(2, devices=["cpu"] * 2),
                                  min_rows_per_shard=2).solve(np.zeros_like(rhs), rhs)
    assert info1.cycles == info.cycles
    np.testing.assert_allclose(u.numpy(), u1.numpy(), rtol=0, atol=1e-12)
    m3 = make_mesh_nd((2, 2, 2), ("z", "r", "y"), devices=["cpu"] * 8)
    sb3 = ShardedPoissonBVP(h, BCS, opts, mesh=m3, axis_names=("z", "y"),
                            min_rows_per_shard=2)
    assert sb3.grid == (2, 2) and len(sb3.devices) == 4
    u3, info3 = sb3.solve(np.zeros_like(rhs), rhs)
    assert info3.cycles == info.cycles and torch.equal(u3, u)


def test_engine_rejects_bad_axes():
    x = np.linspace(0.0, 1.0, 16)
    h3 = GridHierarchy.from_mesh((x, x, x))
    m = _mesh((2, 2))
    with pytest.raises(ValueError, match="no axis"):
        ShardedPoissonBVP(h3, BCS, Options(), mesh=m, axis_names=("z", "w"))
    with pytest.raises(ValueError, match="cannot be partitioned"):  # len(names) >= ndim
        ShardedPoissonBVP(GridHierarchy.from_mesh((x, x)), (("N", "N"),) * 2, Options(),
                          mesh=m, axis_names=("z", "y"))
    with pytest.raises(ValueError):  # 2 x 2 shards of 15 do not divide
        ShardedPoissonBVP(GridHierarchy.from_mesh((np.linspace(0, 1, 15),) * 3), BCS,
                          Options(), mesh=m, axis_names=("z", "y"))


def _potential_case(n, uniform=False):
    x, y, z = (np.linspace(0.0, 1.0, n),) * 3 if uniform else build_test_mesh(n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    A1, b1 = potential_field_case(X, Y, Z)
    return (x, y, z), A1, b1


def test_vector_potential_2d_mesh():
    """vector_potential(dist=<2 x 2 (z, y)>) against JAX's same call and
    the port's single-device call; the chi faces bitwise equal to a
    make_mesh(2) run."""
    (x, y, z), _, b1 = _potential_case(16, uniform=True)
    dist = DistConfig(_mesh((2, 2)), ("z", "y"))
    i_d, A_d, B_d, info = vector_potential(x, y, z, b1.copy(), precision="mixed", dist=dist,
                                           device="cpu", full_output=True)
    i_r, A_r, B_r = vector_potential(x, y, z, b1.copy(), precision="mixed", device="cpu")
    jdist = JDist(mesh=j_make_mesh_nd((2, 2), ("z", "y")), axis_names=("z", "y"))
    i_j, A_j, B_j = ndsm_tpu.vector_potential(
        x, y, z, b1.copy(), options=ndsm_tpu.Options(precision="mixed"), dist=jdist)
    assert i_d == i_r == i_j == 0
    for A_o, B_o in ((A_r, B_r), (np.asarray(A_j), np.asarray(B_j))):
        np.testing.assert_allclose(A_d, A_o, rtol=0, atol=5e-9)
        np.testing.assert_allclose(B_d, B_o, rtol=0, atol=5e-8)
    # the 3D components partition z and y, the chi faces z on the z line
    h3 = GridHierarchy.from_mesh((z, y, x))
    sb3 = _dist_bvp(h3, BCS, Options(precision="mixed"), dist)
    assert sb3.grid == (2, 2)
    h2 = GridHierarchy.from_mesh((y, x))
    sb2 = _dist_bvp(h2, (("N", "N"),) * 2, Options(precision="mixed"), dist)
    assert sb2.grid == (2,) and sb2.devices == (torch.device("cpu"),) * 2
    _, _, _, info1 = vector_potential(x, y, z, b1.copy(), precision="mixed", device="cpu",
                                      dist=DistConfig(make_mesh(2, devices=["cpu"] * 2)),
                                      full_output=True)
    for a, b in zip(info.chi, info1.chi):
        assert (a.cycles, a.du_last) == (b.cycles, b.du_last)
    rng = np.random.default_rng(7)
    rhss = [r - r.mean() for r in rng.standard_normal((3, 16, 16))]
    one = _dist_bvp(h2, (("N", "N"),) * 2, Options(precision="mixed"),
                    DistConfig(make_mesh(2, devices=["cpu"] * 2)))
    got, _ = sb2.solve_batch([np.zeros((16, 16))] * 3, rhss)
    want, _ = one.solve_batch([np.zeros((16, 16))] * 3, rhss)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_vector_potential_2d_mesh_golden_22():
    (x, y, z), A1, b1 = _potential_case(22)
    dist = DistConfig(_mesh((2, 2)), ("z", "y"))
    ierr, A, B = vector_potential(x, y, z, b1.copy(), precision="mixed", device="cpu",
                                  dist=dist)
    assert ierr == 0
    ea = np.linalg.norm(A1 - A, axis=0).max()
    eb = np.linalg.norm(b1 - B, axis=0).max()
    assert f"{ea:.5e} {eb:.5e}" == "1.86048e-03 7.65805e-02"
