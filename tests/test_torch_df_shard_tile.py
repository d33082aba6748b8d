"""The shard form of the defect's z-marching tile (csrc/defect.cu:
defect_tile_f64 with S, the kernel behind ops/df_sharded.py: B11 on a z
mesh, B11y on a (z, y) mesh), on the CPU.

The kernel runs only on the card (chip_smoke.py holds it bitwise against
the plain versions there).  Here a tile-by-tile emulation in torch runs it
as the kernel's blocks do: (TILE_Y, TILE_X) column tiles over the real
block and z chunks of ``cz`` planes (on the card ``cz`` fills one wave of
resident blocks; here 1, 2, 3 and the whole block are run); each point's
v = u (+ e) and its z neighbours read from the extended block (the halo
planes beyond the block's z ends read as data); the tile's plane with its
one-point halo: the rows beyond the tile from the neighbour tile, or beyond
the block's y ends the halo rows (the (z, y) mesh) or the reflection (a z
mesh), the columns beyond it the neighbour's or the reflection at the x
faces; Dirichlet faces in global z and y.  The update writes v over the
whole extended block: each real point by its tile, a halo plane by the
first (last) chunk of each tile column, a halo row by the y-halo threads of
the edge tiles at every plane of their chunk, a corner by those threads of
the first (last) chunk.

It must equal ``df_(update_)residual_sharded_3d(_zy)_plain`` **bitwise**:
r32 over the real block, the maximum, and v over the whole extended block,
corners included, every point written once (unwritten outputs are NaN).
One case goes against JAX's interpreted ``df_residual_sharded_3d`` with
the bounds of tests/test_torch_df_sharded.py: r32 to one float32 rounding
plus 1e-12 of the stencil-term scale, v to 4e-15 of its scale.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndsm_tpu.ops import pallas_df as jdf, stencils as js
from ndsm_tpu_torch.ops import df, df_sharded, stencils as ts
from ndsm_tpu_torch.parallel import collectives as C
from ndsm_tpu_torch.parallel.shard import make_mesh, make_mesh_nd

torch.set_num_threads(1)

#: csrc/defect.cu: kTileY, kTileX
TILE_Y, TILE_X = 16, 32
NAN = float("nan")
BCS = [
    (("D", "D"), ("D", "D"), ("N", "N")),  # Ax
    (("N", "N"), ("D", "D"), ("D", "D")),  # Az: Neumann z faces (mirror planes read)
    (("D", "D"), ("N", "N"), ("D", "D")),  # Ay: Neumann y faces
    (("D", "N"), ("N", "D"), ("N", "N")),
]
FORMS = [(False, False), (True, False), (False, True), (True, True)]  # (rhs, update)


def _reflect(i, n):
    return 1 if i < 0 else (n - 2 if i > n - 1 else i)


def emulate_shard_tile(u_ext, rhs, e_ext, dq, bcs, offsets, extents, cz):
    """(r32, mx[, v]) of one shard as the kernel's blocks compute them, and
    the write counts of r32 (and v)."""
    zy = len(offsets) == 2
    hy = 1 if zy else 0
    nz, nye, nx = u_ext.shape[0] - 2, u_ext.shape[1], u_ext.shape[2]
    ny = nye - 2 * hy
    z0, y0 = int(offsets[0]), int(offsets[1]) if zy else 0
    NZ, NY = int(extents[0]), int(extents[1]) if zy else ny
    (wz, wy, wx), _ = ts.stencil_weights(dq, torch.float64)
    dm = ts.validate_bcs(bcs, 3)
    v = u_ext + e_ext.to(torch.float64) if e_ext is not None else u_ext
    r32 = torch.full((nz, ny, nx), NAN, dtype=torch.float32)
    wr = torch.zeros(r32.shape, dtype=torch.int64)
    vout = torch.full_like(u_ext, NAN) if e_ext is not None else None
    wv = torch.zeros(u_ext.shape, dtype=torch.int64)
    gz = z0 + torch.arange(nz)
    zface = ((gz == 0) & (dm[0][0] == "D")) | ((gz == NZ - 1) & (dm[0][1] == "D"))
    mx = torch.zeros((), dtype=torch.float32)
    for (ty, tx), c in itertools.product(
            itertools.product(range(-(-ny // TILE_Y)), range(-(-nx // TILE_X))),
            range(-(-nz // cz))):
        ya, xa, za = ty * TILE_Y, tx * TILE_X, c * cz
        yb, xb, zb = min(ny, ya + TILE_Y), min(nx, xa + TILE_X), min(nz, za + cz)
        zs = slice(za + 1, zb + 1)  # u's planes of the chunk
        ys, xs = slice(ya + hy, yb + hy), slice(xa, xb)
        vc = v[zs, ys, xs]
        vp, vn = v[za:zb, ys, xs], v[za + 2:zb + 2, ys, xs]
        # the tile's plane with its one-point halo: rows beyond the tile (the
        # neighbour tile's, the block's halo rows, or the reflection), then
        # columns beyond it (the neighbour's or the reflection)
        lo = ya - 1 + hy if hy else _reflect(ya - 1, ny)
        hi = yb + hy if hy else _reflect(yb, ny)
        xl, xh = _reflect(xa - 1, nx), _reflect(xb, nx)
        c2 = 2.0 * vc
        s = ((vp - c2) + vn) * wz
        s = s + ((torch.cat([v[zs, lo:lo + 1, xs], vc[:, :-1]], 1) - c2)
                 + torch.cat([vc[:, 1:], v[zs, hi:hi + 1, xs]], 1)) * wy
        s = s + ((torch.cat([v[zs, ys, xl:xl + 1], vc[:, :, :-1]], 2) - c2)
                 + torch.cat([vc[:, :, 1:], v[zs, ys, xh:xh + 1]], 2)) * wx
        rh = rhs[za:zb, ya:yb, xa:xb] if rhs is not None else torch.zeros_like(vc)
        rv = (rh - s).to(torch.float32)
        gy, gx = y0 + torch.arange(ya, yb), torch.arange(xa, xb)
        face = (zface[za:zb, None, None]
                | (((gy == 0) & (dm[1][0] == "D")) | ((gy == NY - 1) & (dm[1][1] == "D")))[:, None]
                | ((gx == 0) & (dm[2][0] == "D")) | ((gx == nx - 1) & (dm[2][1] == "D")))
        rv = torch.where(face, torch.zeros((), dtype=torch.float32), rv)
        r32[za:zb, ya:yb, xa:xb] = rv
        wr[za:zb, ya:yb, xa:xb] += 1
        mx = torch.maximum(mx, rv.abs().max())
        if vout is None:
            continue
        # the real points, the halo planes of the end chunks, and the halo
        # rows (corners with the end chunks) of the edge tiles
        planes = list(range(za + 1, zb + 1)) + ([0] if za == 0 else []) + \
            ([nz + 1] if zb == nz else [])
        rows = list(range(ya + hy, yb + hy))
        for z in planes:
            vout[z, rows, xs] = v[z, rows, xs]
            wv[z, rows, xs] += 1
        edge = ([0] if hy and ya == 0 else []) + ([ny + 1] if hy and yb == ny else [])
        for z, y in itertools.product(planes, edge):
            vout[z, y, xs] = v[z, y, xs]
            wv[z, y, xs] += 1
    assert (wr == 1).all(), "an r32 point written more or less than once"
    if vout is None:
        return (r32, mx), (wr,)
    assert (wv == 1).all(), "a point of the extended block written more or less than once"
    return (r32, mx, vout), (wr, wv)


def _case(shape, seed):
    rng = np.random.default_rng(seed)
    z, y, x = (np.linspace(0.0, 1.0, n) for n in shape)
    dq = np.array([z[1] - z[0], y[1] - y[0], x[1] - x[0]])
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    u = np.sin(2.1 * Z + 0.3) * np.cos(1.7 * Y) * np.sin(2.9 * X + 1.1)
    return u + 1e-6 * rng.standard_normal(shape), dq, rng


def _check_mesh(grid, local, nx, bcs_list, chunks, seed, shards=None):
    """Every shard (or ``shards``) of a level cut over ``grid`` into blocks
    of ``local``, extended by the port's collectives: the emulation in all
    four forms equals the plain versions bitwise, and stitched the
    unsharded defect."""
    n = len(grid)
    mesh = (make_mesh(grid[0], devices=["cpu"] * grid[0]) if n == 1 else
            make_mesh_nd(grid, ("z", "y"), devices=["cpu"] * int(np.prod(grid))))
    devs = mesh.devices
    shape = tuple(g * l for g, l in zip(grid, local)) + ((local[1],) if n == 1 else ()) + (nx,)
    u, dq, rng = _case(shape, seed)
    ut = torch.as_tensor(u)
    rhs = torch.as_tensor(rng.standard_normal(shape))
    e = torch.as_tensor(1e-4 * rng.standard_normal(shape), dtype=torch.float32)

    def ext(t):
        b = C.shard(t, devs, 0, grid if n == 2 else None)
        if n == 1:
            return C.extend_block(b, devs, 0, 1)
        b = C.extend_block(b, devs, 0, 1, mesh.lines("z"))
        return C.extend_block(b, devs, 1, 1, mesh.lines("y"))

    ue, ee, rb = ext(ut), ext(e), C.shard(rhs, devs, 0, grid if n == 2 else None)
    picks = range(len(devs)) if shards is None else shards
    for k, bcs in enumerate(bcs_list):
        for f, (with_rhs, upd) in enumerate(FORMS):
            cz = chunks[(k + f) % len(chunks)]
            outs = {}
            for i in picks:
                off = tuple(c * l for c, l in zip(mesh.coords(i), local))
                pos = (off[0], shape[0]) if n == 1 else (off, shape[:2])
                args = (ue[i], rb[i] if with_rhs else None) + ((ee[i],) if upd else ()) + (dq, bcs)
                key = ("df_update_residual_sharded_3d" if upd else "df_residual_sharded_3d") + \
                    ("_zy" if n == 2 else "")
                want = getattr(df_sharded, key + "_plain")(*args, *pos)
                got, _ = emulate_shard_tile(ue[i], rb[i] if with_rhs else None,
                                            ee[i] if upd else None, dq, bcs,
                                            off if n == 2 else off[:1], pos[1] if n == 2 else
                                            (shape[0],), cz)
                for part, g, w in zip(("r32", "max", "v"), got, want):
                    assert torch.equal(g, w), (part, i, bcs, with_rhs, upd, cz)
                outs[i] = got
            if shards is None:  # stitched: the unsharded defect of the level
                r32, mx, u_new = df.df_residual_3d_plain(ut, rhs if with_rhs else None,
                                                         e if upd else None, dq, bcs)
                blocks = [outs[i][0] for i in range(len(devs))]
                assert torch.equal(C.unshard(blocks, devs, 0, grid if n == 2 else None), r32)
                assert float(max(o[1] for o in outs.values())) == float(mx)
                if upd:
                    assert all(torch.equal(outs[i][2], w) for i, w in enumerate(ext(u_new)))


@pytest.mark.parametrize("nsh,nzl", [(2, 5), (4, 3)])
def test_z_mesh_bitwise_plain(nsh, nzl):
    """z meshes of 2 and 4 shards: y and x cut into partial tiles (ny 21,
    nx 37), chunks of 1, 2 and the whole block."""
    _check_mesh((nsh,), (nzl, 21), 37, BCS, (1, 2, nzl), nsh)


@pytest.mark.parametrize("local,nx", [((3, 9), 11), ((4, 20), 33)])
def test_zy_mesh_bitwise_plain(local, nx):
    """A 2 x 2 (z, y) mesh: one and two y tiles a block, every shard (each
    has two block edges on the mesh's ends, two halo rows or planes from a
    neighbour), the update's halo rows and corners."""
    _check_mesh((2, 2), local, nx, BCS, (1, 3, local[0]), 5)


def test_64x128_blocks():
    """Blocks of 64 x 128 (z, y) points, 8 y tiles each, a corner and an
    inner shard of a 4 x 2 mesh, chunks of 7 and 64 planes."""
    _check_mesh((4, 2), (64, 128), 9, BCS[:2], (7, 64), 6, shards=(0, 5))


def test_matches_jax_kernel():
    """A z mesh of 3 against JAX's double-float kernel in interpret mode
    (JAX's tile picker needs ny % 8 == 0)."""
    nz, ny, nx, nsh = 6, 8, 11, 3
    NZ = nz * nsh
    bcs = BCS[0]
    u, dq, rng = _case((NZ, ny, nx), 1)
    rhs = -np.asarray(js.poisson_residual(jnp.asarray(u), jnp.zeros(u.shape), jnp.asarray(dq),
                                          bcs))
    u = u * (1 + 1e-9) + 1e-9
    e = (1e-7 * rng.standard_normal(u.shape)).astype(np.float32)
    term = 2 * 3 * np.abs(u).max() / dq.min() ** 2
    call = jdf.df_residual_sharded_3d(bcs, dq, (nz, ny, nx), (0,), zero_rhs=False,
                                      interpret=True, update=True)
    for i in range(nsh):
        z0 = i * nz
        g = np.arange(z0 - 1, z0 + nz + 1)
        g = np.where(g < 0, -g, np.where(g > NZ - 1, 2 * (NZ - 1) - g, g))
        ue, ee = u[g], e[g]
        args = list(jdf.df_decompose(jnp.asarray(ue))) + \
            list(jdf.df_decompose(jnp.asarray(rhs[g]))) + [jnp.asarray(ee)]
        _, _, interior = ts.shard_masks(ue.shape, z0 - 1, NZ, bcs, "cpu")
        args.append(jnp.asarray(np.where(interior.numpy(), 0.0, 2.0).astype(np.float32)))
        want = call(*args)
        (r32, mx, v), _ = emulate_shard_tile(torch.as_tensor(ue), torch.as_tensor(rhs[z0:z0 + nz]),
                                             torch.as_tensor(ee), dq, bcs, (z0,), (NZ,), 2)
        r_j = np.asarray(want[0])
        assert np.all(np.abs(r32.numpy() - r_j) <= np.spacing(np.abs(r_j)) + 1e-12 * term)
        assert abs(float(mx) - float(jnp.max(want[1]))) <= 1e-12 * term
        u_j = np.asarray(jdf.df_reconstruct(want[2], want[3]))
        assert np.abs(v.numpy() - u_j).max() <= 4e-15 * np.abs(u_j).max()


@pytest.mark.cuda
def test_cuda_shard_tile_bitwise_plain():
    """On the card: the shard tile equals the plain versions bitwise (r32,
    max, v over the whole extended block) on a z mesh and a (z, y) mesh of
    blocks that cut y and x into partial tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    u, dq, rng = _case((13, 40, 37), 7)
    ue = torch.as_tensor(u).cuda()
    e = torch.as_tensor(1e-5 * rng.standard_normal(u.shape), dtype=torch.float32).cuda()
    rhs = torch.as_tensor(rng.standard_normal((11, 40, 37))).cuda()
    for bcs in BCS:
        for r_ in (None, rhs):
            z = (dq, bcs, 3, 20)
            for a, b in zip(df_sharded.df_update_residual_sharded_3d(ue, r_, e, *z),
                            df_sharded.df_update_residual_sharded_3d_plain(ue, r_, e, *z)):
                assert torch.equal(a, b)
            r_y = None if r_ is None else r_[:, 1:-1].contiguous()
            zy = (dq, bcs, (3, 5), (20, 50))
            for a, b in zip(df_sharded.df_update_residual_sharded_3d_zy(ue, r_y, e, *zy),
                            df_sharded.df_update_residual_sharded_3d_zy_plain(ue, r_y, e, *zy)):
                assert torch.equal(a, b)
