"""ops/df_sharded.py (B11, the per-shard mixed-precision defect, and its
(z, y) form B11y) against ndsm_tpu.

On the CPU the wrappers run their plain float64 versions; the CUDA kernel
reproduces them bitwise on the card (the ``cuda``-marked test below, and
chip_smoke.py).

Tolerances (those of tests/test_torch_df.py):
  * against the double-float JAX kernel ``df_residual_sharded_3d`` in
    interpret mode, fed ``df_decompose``d extended pairs: r32 to one
    float32 rounding of r plus 1e-12 of the stencil-term scale (the pair
    format's own accuracy); the updated extended iterate to 4e-15 of its
    scale;
  * the stitched shards against the unsharded ``df_residual_3d_plain``:
    bitwise, in all four forms, at 2, 4 and 8 shards, odd local extents
    included;
  * B11y (``_zy``, extended by one plane in z and y) against JAX's kernel
    with ``parts=(0, 1)`` (fed its 8-plane y halo; the port reads the one
    plane next to the block) on a corner, an edge and an inner-z shard of
    2 x 2 and 4 x 2 meshes: the bounds above; stitched over 2 x 2 and
    4 x 2 meshes, bitwise against the unsharded kernel in all four forms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndsm_tpu.ops import pallas_df as jdf, stencils as js
from ndsm_tpu_torch.ops import df, df_sharded, stencils as ts
from ndsm_tpu_torch.parallel import collectives as C
from ndsm_tpu_torch.parallel.shard import make_mesh, make_mesh_nd

torch.set_num_threads(1)

BCS = [
    (("D", "D"), ("D", "D"), ("N", "N")),  # Ax
    (("N", "N"), ("D", "D"), ("D", "D")),  # Az: Neumann z faces (no mask code in JAX)
    (("D", "N"), ("N", "D"), ("N", "N")),
]


def _case(shape, seed):
    """Near-converged iterate: rhs := L(u), then u perturbed."""
    rng = np.random.default_rng(seed)
    z, y, x = (np.linspace(0.0, 1.0, n) for n in shape)
    dq = np.array([z[1] - z[0], y[1] - y[0], x[1] - x[0]])
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    u = np.sin(2.1 * Z + 0.3) * np.cos(1.7 * Y) * np.sin(2.9 * X + 1.1)
    return u, dq, rng


def _extend(v, z0, nz, H=1):
    n = v.shape[0]
    g = np.arange(z0 - H, z0 + nz + H)
    g = np.where(g < 0, -g, np.where(g > n - 1, 2 * (n - 1) - g, g))
    return v[g]


@pytest.mark.parametrize("bcs", BCS)
def test_plain_matches_jax_kernel(bcs):
    nz, ny, nx, nsh = 6, 8, 11, 3  # (JAX's tile picker needs ny % 8 == 0)
    NZ = nz * nsh
    u, dq, rng = _case((NZ, ny, nx), 1)
    rhs = -np.asarray(js.poisson_residual(jnp.asarray(u), jnp.zeros(u.shape), jnp.asarray(dq),
                                          bcs))
    u = u * (1 + 1e-9) + 1e-9
    e = (1e-7 * rng.standard_normal(u.shape)).astype(np.float32)
    with_c = "D" in bcs[0]
    term = 2 * 3 * np.abs(u).max() / dq.min() ** 2
    for zero_rhs in (False, True):
        for update in (False, True):
            call = jdf.df_residual_sharded_3d(bcs, dq, (nz, ny, nx), (0,), zero_rhs=zero_rhs,
                                              interpret=True, update=update)
            assert call is not None
            for i in range(nsh):
                z0 = i * nz
                ue = _extend(u, z0, nz)
                args = list(jdf.df_decompose(jnp.asarray(ue)))
                if not zero_rhs:
                    args += list(jdf.df_decompose(jnp.asarray(_extend(rhs, z0, nz))))
                ee = _extend(e, z0, nz)
                if update:
                    args.append(jnp.asarray(ee))
                if with_c:  # 2.0 on every Dirichlet-face point, in global z
                    _, _, interior = ts.shard_masks(ue.shape, z0 - 1, NZ, bcs, "cpu")
                    args.append(jnp.asarray(np.where(interior.numpy(), 0.0, 2.0)
                                            .astype(np.float32)))
                want = call(*args)
                r_rhs = None if zero_rhs else torch.as_tensor(rhs[z0 : z0 + nz])
                if update:
                    got = df_sharded.df_update_residual_sharded_3d(
                        torch.as_tensor(ue), r_rhs, torch.as_tensor(ee), dq, bcs, z0, NZ)
                    u_j = np.asarray(jdf.df_reconstruct(want[2], want[3]))
                    assert np.abs(got[2].numpy() - u_j).max() <= 4e-15 * np.abs(u_j).max()
                else:
                    got = df_sharded.df_residual_sharded_3d(torch.as_tensor(ue), r_rhs, dq,
                                                            bcs, z0, NZ)
                r_j = np.asarray(want[0])
                bound = np.spacing(np.abs(r_j)) + 1e-12 * term
                assert np.all(np.abs(got[0].numpy() - r_j) <= bound)
                assert abs(float(got[1]) - float(jnp.max(want[1]))) <= 1e-12 * term


FORMS = [(False, False), (True, False), (False, True), (True, True)]  # (rhs, update)


def _extend_zy(v, z0, y0, nz, ny, Hz, Hy):
    gz, gy = np.arange(z0 - Hz, z0 + nz + Hz), np.arange(y0 - Hy, y0 + ny + Hy)
    n, m = v.shape[:2]
    gz = np.where(gz < 0, -gz, np.where(gz > n - 1, 2 * (n - 1) - gz, gz))
    gy = np.where(gy < 0, -gy, np.where(gy > m - 1, 2 * (m - 1) - gy, gy))
    return v[np.ix_(gz, gy)]


@pytest.mark.parametrize("grid", [(2, 2), (4, 2)])
@pytest.mark.parametrize("bcs", BCS)
def test_zy_plain_matches_jax_kernel(bcs, grid):
    nz, ny, nx = 12 // grid[0], 32 // grid[1], 11  # (JAX's y halo of 8 needs 9 planes)
    NZ, NY = nz * grid[0], ny * grid[1]
    u, dq, rng = _case((NZ, NY, nx), 2)
    rhs = -np.asarray(js.poisson_residual(jnp.asarray(u), jnp.zeros(u.shape), jnp.asarray(dq),
                                          bcs))
    u = u * (1 + 1e-9) + 1e-9
    e = (1e-7 * rng.standard_normal(u.shape)).astype(np.float32)
    Hy = jdf.df_sharded_halos((0, 1))[1]
    with_c = jdf._df_with_c(bcs, (0, 1))
    term = 2 * 3 * np.abs(u).max() / dq.min() ** 2
    cut = (slice(None), slice(Hy - 1, -(Hy - 1)))  # the port's one-plane y halo
    for with_rhs, update in FORMS:
        call = jdf.df_residual_sharded_3d(bcs, dq, (nz, ny, nx), (0, 1), zero_rhs=not with_rhs,
                                          interpret=True, update=update)
        assert call is not None
        for iz, iy in sorted({(0, 0), (grid[0] - 1, 1), (grid[0] // 2, 0)}):
            z0, y0 = iz * nz, iy * ny
            ue = _extend_zy(u, z0, y0, nz, ny, 1, Hy)
            args = list(jdf.df_decompose(jnp.asarray(ue)))
            if with_rhs:
                args += list(jdf.df_decompose(jnp.asarray(_extend_zy(rhs, z0, y0, nz, ny, 1,
                                                                      Hy))))
            ee = _extend_zy(e, z0, y0, nz, ny, 1, Hy)
            if update:
                args.append(jnp.asarray(ee))
            if with_c:
                _, _, interior = ts.shard_masks(ue.shape, (z0 - 1, y0 - Hy), (NZ, NY), bcs,
                                                "cpu")
                args.append(jnp.asarray(np.where(interior.numpy(), 0.0, 2.0)
                                        .astype(np.float32)))
            want = call(*args)
            r_rhs = (torch.as_tensor(np.ascontiguousarray(rhs[z0:z0 + nz, y0:y0 + ny]))
                     if with_rhs else None)
            uc = torch.as_tensor(np.ascontiguousarray(ue[cut]))
            if update:
                got = df_sharded.df_update_residual_sharded_3d_zy(
                    uc, r_rhs, torch.as_tensor(np.ascontiguousarray(ee[cut])), dq, bcs,
                    (z0, y0), (NZ, NY))
                u_j = np.asarray(jdf.df_reconstruct(want[2], want[3]))[cut]
                assert np.abs(got[2].numpy() - u_j).max() <= 4e-15 * np.abs(u_j).max()
            else:
                got = df_sharded.df_residual_sharded_3d_zy(uc, r_rhs, dq, bcs, (z0, y0),
                                                           (NZ, NY))
            r_j = np.asarray(want[0])
            assert got[0].shape == r_j.shape == (nz, ny, nx)
            bound = np.spacing(np.abs(r_j)) + 1e-12 * term
            assert np.all(np.abs(got[0].numpy() - r_j) <= bound)
            assert abs(float(got[1]) - float(jnp.max(want[1]))) <= 1e-12 * term


@pytest.mark.parametrize("grid,local", [((2, 2), (5, 4)), ((4, 2), (3, 6)), ((4, 2), (2, 3))])
def test_zy_stitched_bitwise_unsharded(grid, local):
    mesh = make_mesh_nd(grid, ("z", "y"), devices=["cpu"] * (grid[0] * grid[1]))
    devs = mesh.devices
    NZ, NY = grid[0] * local[0], grid[1] * local[1]
    u, dq, rng = _case((NZ, NY, 8), sum(local))
    ut = torch.as_tensor(u + 1e-6 * rng.standard_normal(u.shape))
    rhs = torch.as_tensor(rng.standard_normal(u.shape))
    e = torch.as_tensor(1e-4 * rng.standard_normal(u.shape), dtype=torch.float32)

    def ext(v):
        b = C.extend_block(C.shard(v, devs, 0, grid), devs, 0, 1, mesh.lines("z"))
        return C.extend_block(b, devs, 1, 1, mesh.lines("y"))

    ue, ee, rb = ext(ut), ext(e), C.shard(rhs, devs, 0, grid)
    for bcs in BCS + [(("N", "D"), ("D", "N"), ("D", "D"))]:
        for with_rhs, upd in FORMS:
            outs = []
            for i in range(len(devs)):
                iz, iy = mesh.coords(i)
                off = (iz * local[0], iy * local[1])
                r_i = rb[i] if with_rhs else None
                if upd:
                    outs.append(df_sharded.df_update_residual_sharded_3d_zy(
                        ue[i], r_i, ee[i], dq, bcs, off, (NZ, NY)))
                else:
                    outs.append(df_sharded.df_residual_sharded_3d_zy(ue[i], r_i, dq, bcs, off,
                                                                     (NZ, NY)))
            r32, mx, u_new = df.df_residual_3d_plain(ut, rhs if with_rhs else None,
                                                     e if upd else None, dq, bcs)
            assert torch.equal(C.unshard([o[0] for o in outs], devs, 0, grid), r32)
            assert float(max(o[1] for o in outs)) == float(mx)
            if upd:  # the extended iterate: real points and halos both u + e
                assert all(torch.equal(o[2], w) for o, w in zip(outs, ext(u_new)))


@pytest.mark.parametrize("nsh,nzl", [(2, 7), (4, 4), (8, 3), (8, 2)])
def test_stitched_bitwise_unsharded(nsh, nzl):
    u, dq, rng = _case((nsh * nzl, 7, 8), nsh)
    ut = torch.as_tensor(u + 1e-6 * rng.standard_normal(u.shape))
    rhs = torch.as_tensor(rng.standard_normal(u.shape))
    e = torch.as_tensor(1e-4 * rng.standard_normal(u.shape), dtype=torch.float32)
    devs = make_mesh(nsh, devices=["cpu"] * nsh).devices
    ue = C.extend_block(C.shard(ut, devs, 0), devs, 0, 1)
    rb, ee = C.shard(rhs, devs, 0), C.extend_block(C.shard(e, devs, 0), devs, 0, 1)
    NZ = nsh * nzl
    for bcs in BCS:
        for with_rhs, upd in FORMS:
            outs = []
            for i in range(nsh):
                r_i = rb[i] if with_rhs else None
                if upd:
                    outs.append(df_sharded.df_update_residual_sharded_3d(
                        ue[i], r_i, ee[i], dq, bcs, i * nzl, NZ))
                else:
                    outs.append(df_sharded.df_residual_sharded_3d(ue[i], r_i, dq, bcs,
                                                                  i * nzl, NZ))
            r32, mx, u_new = df.df_residual_3d_plain(ut, rhs if with_rhs else None,
                                                     e if upd else None, dq, bcs)
            assert torch.equal(torch.cat([o[0] for o in outs]), r32)
            assert float(max(o[1] for o in outs)) == float(mx)
            if upd:
                # the extended iterate: real planes and halos both u + e
                for i, o in enumerate(outs):
                    want = C.extend_block(C.shard(u_new, devs, 0), devs, 0, 1)[i]
                    assert torch.equal(o[2], want)


def test_checks_and_inputs_untouched():
    u, dq, rng = _case((8, 5, 6), 5)
    ue = torch.as_tensor(u)
    e = torch.full(ue.shape, 1e-3, dtype=torch.float32)
    u0 = ue.clone()
    r32, mx, v = df_sharded.df_update_residual_sharded_3d(ue, None, e, dq, BCS[0], 2, 10)
    assert r32.shape == (6, 5, 6) and v.shape == ue.shape and torch.equal(ue, u0)
    with pytest.raises(ValueError):  # the real planes outside the level
        df_sharded.df_residual_sharded_3d(ue, None, dq, BCS[0], 5, 10)
    with pytest.raises(ValueError):  # rhs is the real block
        df_sharded.df_residual_sharded_3d(ue, ue, dq, BCS[0], 2, 10)
    with pytest.raises(TypeError):
        df_sharded.df_residual_sharded_3d(ue.float(), None, dq, BCS[0], 2, 10)
    # the (z, y) form
    r32, mx, v = df_sharded.df_update_residual_sharded_3d_zy(ue, None, e, dq, BCS[0], (2, 1),
                                                             (10, 4))
    assert r32.shape == (6, 3, 6) and v.shape == ue.shape and torch.equal(ue, u0)
    with pytest.raises(ValueError):  # the real y points outside the level
        df_sharded.df_residual_sharded_3d_zy(ue, None, dq, BCS[0], (2, 2), (10, 4))
    with pytest.raises(ValueError):  # the update takes e
        df_sharded.df_update_residual_sharded_3d_zy(ue, None, None, dq, BCS[0], (2, 1),
                                                    (10, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("bcs", BCS)
def test_cuda_kernel_bitwise_plain(bcs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    u, dq, rng = _case((9, 10, 11), 6)
    ue = torch.as_tensor(u).cuda()
    rhs = torch.as_tensor(rng.standard_normal((7, 10, 11))).cuda()
    e = torch.as_tensor(1e-5 * rng.standard_normal(u.shape), dtype=torch.float32).cuda()
    for r_ in (None, rhs):
        for a, b in zip(df_sharded.df_residual_sharded_3d(ue, r_, dq, bcs, 3, 20),
                        df_sharded.df_residual_sharded_3d_plain(ue, r_, dq, bcs, 3, 20)):
            assert torch.equal(a, b)
        for a, b in zip(df_sharded.df_update_residual_sharded_3d(ue, r_, e, dq, bcs, 3, 20),
                        df_sharded.df_update_residual_sharded_3d_plain(ue, r_, e, dq, bcs, 3,
                                                                       20)):
            assert torch.equal(a, b)
    # the (z, y) form: rhs is the real block (7, 8, 11)
    for r_ in (None, rhs[:, 1:-1]):
        r_ = None if r_ is None else r_.contiguous()
        args = (dq, bcs, (3, 2), (20, 12))
        for a, b in zip(df_sharded.df_residual_sharded_3d_zy(ue, r_, *args),
                        df_sharded.df_residual_sharded_3d_zy_plain(ue, r_, *args)):
            assert torch.equal(a, b)
        for a, b in zip(df_sharded.df_update_residual_sharded_3d_zy(ue, r_, e, *args),
                        df_sharded.df_update_residual_sharded_3d_zy_plain(ue, r_, e, *args)):
            assert torch.equal(a, b)
