"""ops/zc_sharded.py (B10, the per-shard red-black sweeps, and its (z, y)
form B10y) against ndsm_tpu.

On the CPU the wrappers run their plain versions; the CUDA kernel
reproduces them bitwise on the card (the ``cuda``-marked test below, and
chip_smoke.py).

Tolerances:
  * against the JAX kernel ``pallas_zc.zc_smooth_sharded_3d`` in interpret
    mode, fed the same extended blocks and the mask code of the same
    Dirichlet faces: u to <= 2 ulp of max|u| a sweep (XLA:CPU contracts the
    update into multiply-adds; ROADMAP.md Queue C); the residual to that
    bound carried through the stencil (times 1 + 4 sum(w)) plus 2 ulp of
    its terms' scale 4 sum(w) max|u| (its own contractions);
  * the stitched shards against the unsharded ``zc_smooth_3d_plain`` of the
    whole level: bitwise, at 2, 4 and 8 shards, even and odd local extents
    (odd shard offsets), with Neumann z faces (mirror planes) and
    Dirichlet ones;
  * B10y (``_zy``, a block of the (z, y) mesh extended in z and y) against
    JAX's kernel with ``ext_y=True``, fed the same extended blocks (JAX's
    halos: z rounded to even, y to 8 planes) on a corner, an edge and an
    inner shard of 2 x 2 and 4 x 2 cuts of a 32^3 level, compared on the
    real block: the bounds above; stitched over 2 x 2 and 4 x 2 meshes,
    halo-extended by the port's collectives (z, then y), bitwise against
    the unsharded kernel, even and odd local extents, Neumann and
    Dirichlet z and y faces.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndsm_tpu.ops import pallas_zc as jzc
from ndsm_tpu_torch.ops import stencils, zc, zc_sharded
from ndsm_tpu_torch.parallel import collectives as C
from ndsm_tpu_torch.parallel.shard import make_mesh, make_mesh_nd

torch.set_num_threads(1)

BCS = [
    (("D", "D"), ("D", "D"), ("N", "N")),  # Ax
    (("N", "N"), ("D", "D"), ("D", "D")),  # Az: Neumann z faces
    (("D", "N"), ("N", "D"), ("D", "N")),
]
DQ = (0.9, 1.1, 1.3)


def _extend(v: np.ndarray, z0: int, nz: int, H: int):
    """numpy halo rule: the global planes z0 - H .. z0 + nz + H - 1, node
    mirrors beyond the level's ends."""
    n = v.shape[0]
    g = np.arange(z0 - H, z0 + nz + H)
    g = np.where(g < 0, -g, np.where(g > n - 1, 2 * (n - 1) - g, g))
    return v[g]


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("bcs", BCS)
def test_plain_matches_jax_kernel(bcs, ns, residual):
    nz, ny, nx, nsh = 8, 16, 32, 4
    NZ = nz * nsh
    rng = np.random.default_rng(ns)
    u_g = rng.standard_normal((NZ, ny, nx)).astype(np.float32)
    r_g = rng.standard_normal((NZ, ny, nx)).astype(np.float32)
    H = jzc._halos(ns, residual)[0]
    p0 = 1 if bcs[2][0] == "D" else 0
    call = jzc.zc_smooth_sharded_3d(DQ, (nz, ny, nx), ns, p0, interpret=True,
                                    residual=residual)
    assert call is not None
    for i in (0, 1, nsh - 1):  # first, middle, last shard (even offsets, as JAX needs)
        z0 = i * nz
        ue, re = _extend(u_g, z0, nz, H), _extend(r_g, z0, nz, H)
        _, _, interior = stencils.shard_masks(ue.shape, z0 - H, NZ, bcs, "cpu")
        code = np.where(interior.numpy(), 0.0, 2.0).astype(np.float32)
        want = call(jnp.asarray(ue), jnp.asarray(re), jnp.asarray(code))
        fn = (zc_sharded.zc_smooth_residual_sharded_3d if residual
              else zc_sharded.zc_smooth_sharded_3d)
        got = fn(torch.as_tensor(ue), torch.as_tensor(re), DQ, bcs, ns, z0, NZ, H)
        want = [np.asarray(w) for w in (want if residual else (want,))]
        got = [g.numpy() for g in (got if residual else (got,))]
        ulp = float(np.spacing(np.float32(np.abs(want[0]).max())))
        assert np.abs(got[0] - want[0]).max() <= 2 * ns * ulp
        if residual:
            sw = float(np.sum(1.0 / np.square(DQ)))
            term_ulp = float(np.spacing(np.float32(4 * sw * np.abs(want[0]).max())))
            bound = 2 * ns * ulp * (1 + 4 * sw) + 2 * term_ulp
            assert np.abs(got[1] - want[1]).max() <= bound


def _extend_zy(v: np.ndarray, z0: int, y0: int, nz: int, ny: int, Hz: int, Hy: int):
    """numpy halo rule in z and y, corners included: node mirrors beyond
    the level's ends along each axis."""
    gz = np.arange(z0 - Hz, z0 + nz + Hz)
    gy = np.arange(y0 - Hy, y0 + ny + Hy)
    n, m = v.shape[:2]
    gz = np.where(gz < 0, -gz, np.where(gz > n - 1, 2 * (n - 1) - gz, gz))
    gy = np.where(gy < 0, -gy, np.where(gy > m - 1, 2 * (m - 1) - gy, gy))
    return v[np.ix_(gz, gy)]


def _ulp_bounds(want, ns, residual):
    ulp = float(np.spacing(np.float32(np.abs(want[0]).max())))
    bound_u = 2 * ns * ulp
    if not residual:
        return bound_u, None
    sw = float(np.sum(1.0 / np.square(DQ)))
    term_ulp = float(np.spacing(np.float32(4 * sw * np.abs(want[0]).max())))
    return bound_u, 2 * ns * ulp * (1 + 4 * sw) + 2 * term_ulp


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("grid", [(2, 2), (4, 2)])
def test_zy_plain_matches_jax_kernel(grid, ns, residual):
    """B10y's plain version against JAX's ext_y kernel on a corner, an edge
    (4 x 2 only) and an inner-z shard."""
    N = 32
    nz, ny, nx = N // grid[0], N // grid[1], N
    rng = np.random.default_rng(10 * ns + grid[0])
    u_g = rng.standard_normal((N, N, nx)).astype(np.float32)
    r_g = rng.standard_normal((N, N, nx)).astype(np.float32)
    Hz, Hy = jzc._halos(ns, residual)
    for bcs in BCS[:2] + [(("D", "N"), ("D", "N"), ("D", "N"))]:
        p0 = 1 if bcs[2][0] == "D" else 0
        call = jzc.zc_smooth_sharded_3d(DQ, (nz, ny, nx), ns, p0, ext_y=True, interpret=True,
                                        residual=residual)
        assert call is not None
        for iz, iy in sorted({(0, 0), (grid[0] - 1, 1), (grid[0] // 2, 0)}):
            z0, y0 = iz * nz, iy * ny
            ue = _extend_zy(u_g, z0, y0, nz, ny, Hz, Hy)
            re = _extend_zy(r_g, z0, y0, nz, ny, Hz, Hy)
            _, _, interior = stencils.shard_masks(ue.shape, (z0 - Hz, y0 - Hy), (N, N), bcs,
                                                  "cpu")
            code = np.where(interior.numpy(), 0.0, 2.0).astype(np.float32)
            want = call(jnp.asarray(ue), jnp.asarray(re), jnp.asarray(code))
            fn = (zc_sharded.zc_smooth_residual_sharded_3d_zy if residual
                  else zc_sharded.zc_smooth_sharded_3d_zy)
            got = fn(torch.as_tensor(ue), torch.as_tensor(re), DQ, bcs, ns, (z0, y0), (N, N),
                     (Hz, Hy))
            want = [np.asarray(w) for w in (want if residual else (want,))]
            got = [g.numpy() for g in (got if residual else (got,))]
            bound_u, bound_r = _ulp_bounds(want, ns, residual)
            assert got[0].shape == (nz, ny, nx)
            assert np.abs(got[0] - want[0]).max() <= bound_u
            if residual:
                assert np.abs(got[1] - want[1]).max() <= bound_r


def _stitched_zy(u, rhs, bcs, ns, grid, residual):
    mesh = make_mesh_nd(grid, ("z", "y"), devices=["cpu"] * (grid[0] * grid[1]))
    devs = mesh.devices
    N, M = u.shape[:2]
    H = 2 * ns + (1 if residual else 0)
    exts = []
    for v in (u, rhs):
        b = C.extend_block(C.shard(v, devs, 0, grid), devs, 0, H, mesh.lines("z"))
        exts.append(C.extend_block(b, devs, 1, H, mesh.lines("y")))
    nzl, nyl = N // grid[0], M // grid[1]
    fn = (zc_sharded.zc_smooth_residual_sharded_3d_zy if residual
          else zc_sharded.zc_smooth_sharded_3d_zy)
    outs = []
    for i, (ue, re) in enumerate(zip(*exts)):
        iz, iy = mesh.coords(i)
        outs.append(fn(ue, re, DQ, bcs, ns, (iz * nzl, iy * nyl), (N, M), (H, H)))
    parts = list(zip(*outs)) if residual else [outs]
    return [C.unshard(list(p), devs, 0, grid) for p in parts]


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("grid,local", [((2, 2), (8, 9)), ((4, 2), (5, 6)), ((4, 2), (7, 5))])
def test_zy_stitched_bitwise_unsharded(grid, local, residual):
    rng = np.random.default_rng(sum(local) + grid[0])
    shape = (grid[0] * local[0], grid[1] * local[1], 7)
    u = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
    rhs = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
    for bcs in BCS + [(("N", "D"), ("D", "N"), ("D", "D"))]:
        for ns in (1, 2):
            if min(local) < 2 * ns + 2:
                continue  # the mirror needs H + 1 planes
            got = _stitched_zy(u, rhs, bcs, ns, grid, residual)
            want = (zc.zc_smooth_residual_3d_plain if residual else zc.zc_smooth_3d_plain)(
                u, rhs, DQ, bcs, ns)
            for g, w in zip(got, want if residual else (want,)):
                assert torch.equal(g, w)


def _stitched(u, rhs, bcs, ns, nsh, residual):
    devs = make_mesh(nsh, devices=["cpu"] * nsh).devices
    NZ = u.shape[0]
    H = 2 * ns + (1 if residual else 0)
    ue = C.extend_block(C.shard(u, devs, 0), devs, 0, H)
    re = C.extend_block(C.shard(rhs, devs, 0), devs, 0, H)
    nzl = NZ // nsh
    fn = zc_sharded.zc_smooth_residual_sharded_3d if residual else zc_sharded.zc_smooth_sharded_3d
    outs = [fn(ue[i], re[i], DQ, bcs, ns, i * nzl, NZ, H) for i in range(nsh)]
    if residual:
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
    return torch.cat(outs)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("nsh,nzl", [(2, 9), (2, 8), (4, 5), (4, 6), (8, 6), (8, 7)])
def test_stitched_bitwise_unsharded(nsh, nzl, residual):
    rng = np.random.default_rng(nsh * nzl)
    shape = (nsh * nzl, 6, 7)
    u = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
    rhs = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
    for bcs in BCS:
        for ns in (1, 2):
            if nzl < 2 * ns + 2:
                continue  # the mirror needs H + 1 planes
            got = _stitched(u, rhs, bcs, ns, nsh, residual)
            if residual:
                want = zc.zc_smooth_residual_3d_plain(u, rhs, DQ, bcs, ns)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            else:
                assert torch.equal(got, zc.zc_smooth_3d_plain(u, rhs, DQ, bcs, ns))


def test_wrapper_checks_and_inputs_untouched():
    rng = np.random.default_rng(3)
    bcs = BCS[0]
    ue = torch.as_tensor(rng.standard_normal((12, 5, 6)), dtype=torch.float32)
    re = torch.as_tensor(rng.standard_normal((12, 5, 6)), dtype=torch.float32)
    u0 = ue.clone()
    out = zc_sharded.zc_smooth_sharded_3d(ue, re, DQ, bcs, 2, 4, 20, 4)
    assert out.shape == (4, 5, 6) and out.is_contiguous() and torch.equal(ue, u0)
    with pytest.raises(ValueError):  # halo 4 < 2*2 + 1 for the residual
        zc_sharded.zc_smooth_residual_sharded_3d(ue, re, DQ, bcs, 2, 4, 20, 4)
    with pytest.raises(ValueError):  # the real planes outside the level
        zc_sharded.zc_smooth_sharded_3d(ue, re, DQ, bcs, 2, 18, 20, 4)
    with pytest.raises(TypeError):
        zc_sharded.zc_smooth_sharded_3d(ue.double(), re.double(), DQ, bcs, 2, 4, 20, 4)
    with pytest.raises(ValueError):  # all-Neumann takes the mean smoother
        zc_sharded.zc_smooth_sharded_3d(ue, re, DQ, (("N", "N"),) * 3, 2, 4, 20, 4)
    # the (z, y) form: halos and offsets checked along both axes
    ue = torch.as_tensor(rng.standard_normal((12, 13, 6)), dtype=torch.float32)
    re = torch.as_tensor(rng.standard_normal(ue.shape), dtype=torch.float32)
    u0 = ue.clone()
    out = zc_sharded.zc_smooth_sharded_3d_zy(ue, re, DQ, bcs, 2, (4, 3), (20, 10), (4, 4))
    assert out.shape == (4, 5, 6) and torch.equal(ue, u0)
    with pytest.raises(ValueError):  # y halo 3 < 2*2
        zc_sharded.zc_smooth_sharded_3d_zy(ue, re, DQ, bcs, 2, (4, 3), (20, 11), (4, 3))
    with pytest.raises(ValueError):  # the real y points outside the level
        zc_sharded.zc_smooth_sharded_3d_zy(ue, re, DQ, bcs, 2, (4, 6), (20, 10), (4, 4))


@pytest.mark.cuda
def test_cuda_kernel_bitwise_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(4)
    for bcs in BCS:
        for ns, res in ((1, False), (2, True), (5, False)):
            H = 2 * ns + res
            ue = torch.as_tensor(rng.standard_normal((7 + 2 * H, 9, 10)), dtype=torch.float32)
            re = torch.as_tensor(rng.standard_normal(ue.shape), dtype=torch.float32)
            args = (DQ, bcs, ns, 5, 30, H)
            fn = zc_sharded.zc_smooth_residual_sharded_3d if res else zc_sharded.zc_smooth_sharded_3d
            plain = (zc_sharded.zc_smooth_residual_sharded_3d_plain if res
                     else zc_sharded.zc_smooth_sharded_3d_plain)
            got = fn(ue.cuda(), re.cuda(), *args)
            want = plain(ue.cuda(), re.cuda(), *args)
            for g, w in zip(got if res else (got,), want if res else (want,)):
                assert torch.equal(g, w)
            # the (z, y) form: a block extended in z and y
            ue = torch.as_tensor(rng.standard_normal((7 + 2 * H, 6 + 2 * H, 10)),
                                 dtype=torch.float32)
            re = torch.as_tensor(rng.standard_normal(ue.shape), dtype=torch.float32)
            args = (DQ, bcs, ns, (5, 3), (30, 21), (H, H))
            fn = (zc_sharded.zc_smooth_residual_sharded_3d_zy if res
                  else zc_sharded.zc_smooth_sharded_3d_zy)
            plain = (zc_sharded.zc_smooth_residual_sharded_3d_zy_plain if res
                     else zc_sharded.zc_smooth_sharded_3d_zy_plain)
            got = fn(ue.cuda(), re.cuda(), *args)
            want = plain(ue.cuda(), re.cuda(), *args)
            for g, w in zip(got if res else (got,), want if res else (want,)):
                assert torch.equal(g, w)
