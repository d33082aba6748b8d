"""The shard form of the multi-sweep pass (csrc/lane_pass.cuh with S, the
kernel behind ops/zc_sharded.py: B10 on a z mesh, B10y on a (z, y) mesh),
on the CPU.

The kernel runs only on the card (chip_smoke.py holds it bitwise against
the plain versions there).  What can be checked here:

  (a) ``zc.shard_pass_tile`` / ``zc.shard_pass_plan``: one pass of all
      the call's sweeps; the tiles cover the real block exactly once; a
      window is the tile grown by 2w (+1) inside the extended block (never
      clamped along a partitioned axis when the halo is what the pass
      needs); the shared memory fits a block;
  (b) a block-level emulation in torch of the pass as the kernel runs it
      over a shard's halo-extended block: the tiles of the real block,
      the windows, the ring of planes marching in z with stage s on plane
      t - 1 - s, colour and Dirichlet freezing from global indices, the
      block's partitioned ends as cut edges (reach = distance from them),
      the real block written, the residual of the final planes.  It must
      equal ``zc_sharded``'s plain versions (both mesh forms, both
      outputs) **bitwise** on a first, an inner and a last shard of a z
      mesh and on every shard of a 2 x 2 mesh, with Dirichlet and Neumann
      faces along the partitioned axes (frozen face planes with mirror
      planes beyond them, and mirror planes read by a Neumann face),
      ns 1 and 2, the plan's tile and a small one that cuts every axis,
      and a halo thicker than the pass needs.  Unloaded planes are NaN.
"""

import itertools

import numpy as np
import pytest
import torch

from ndsm_tpu_torch.ops import stencils, zc, zc_sharded

torch.set_num_threads(1)

DQ = (0.9, 1.1, 1.3)
BCS = {
    "Ax": (("D", "D"), ("D", "D"), ("N", "N")),
    "Az": (("N", "N"), ("D", "D"), ("D", "D")),  # Neumann z faces: mirror planes read
    "Ay": (("D", "D"), ("N", "N"), ("D", "D")),  # Neumann y faces
    "mix": (("D", "N"), ("N", "D"), ("D", "N")),
}
SMALL_TILE = (3, 4, 5)
FAR = 1 << 20


def _extend(v, offsets, reals, halos):
    """numpy halo rule: global indices offset - H .. offset + real + H - 1
    along each partitioned axis, node mirrors beyond the level's ends (the
    engine's collectives fill the same values, corners included)."""
    idx = []
    for ax, (o, n, h) in enumerate(zip(offsets, reals, halos)):
        g = np.arange(o - h, o + n + h)
        m = v.shape[ax]
        idx.append(np.where(g < 0, -g, np.where(g > m - 1, 2 * (m - 1) - g, g)))
    idx += [np.arange(s) for s in v.shape[len(idx):]]
    return np.ascontiguousarray(v[np.ix_(*idx)])


def _reach(g, w0, w1, n, g0, ng, dlo, dhi, cut):
    """Stages an array index ``g`` (in [w0, w1)) is worth updating: its
    distance from a cut edge (with ``cut`` the array's ends too), -1 on a
    Dirichlet face of the level (global index g0 + g)."""
    lo = g - w0 if (cut or w0 > 0) else torch.full_like(g, FAR)
    hi = (w1 - 1 - g) if (cut or w1 < n) else torch.full_like(g, FAR)
    d = torch.minimum(lo, hi)
    d = torch.where((g0 + g == 0) & bool(dlo), -1, d)
    return torch.where((g0 + g == ng - 1) & bool(dhi), -1, d)


def _blocks(p, ext, hz, hy):
    """(o0, o1, w0, w1) of every block: the tiles of the real block at
    (hz, hy) of the extended block ``ext``, their windows."""
    nze, nye, nx = ext
    real = (nze - 2 * hz, nye - 2 * hy, nx)
    start = (hz, hy, 0)
    cz, ty, tx = p.tile
    ntx = -(-nx // tx)
    for bx, bz in itertools.product(range(p.grid[0]), range(p.grid[1])):
        o0 = (hz + bz * cz, hy + (bx // ntx) * ty, (bx % ntx) * tx)
        o1 = tuple(min(s + n, a + t) for s, n, a, t in zip(start, real, o0, (cz, ty, tx)))
        w0 = tuple(max(0, a - p.halo) for a in o0)
        w1 = tuple(min(n, b + p.halo) for b, n in zip(o1, ext))
        yield o0, o1, w0, w1


def emulate_shard_pass(ue, re, dq, bcs, offsets, extents, halos, p):
    """One pass ``p`` over a shard's extended block as the kernel's shard
    form runs it, block by block.  Returns (u, r) of the real block (r
    None without the residual) and the count of writes of each point."""
    nze, nye, nx = ue.shape
    zy = len(halos) == 2
    (z0, y0), (NZ, NY), (hz, hy) = ((offsets, extents, halos) if zy else
                                    ((offsets[0], 0), (extents[0], nye), (halos[0], 0)))
    gz0, gy0 = z0 - hz, y0 - hy
    nz, ny = nze - 2 * hz, nye - 2 * hy
    (wz, wy, wx), w0 = stencils.stencil_weights(dq, torch.float32)
    color = stencils.first_color_parity(bcs)
    dm = zc.dirichlet_mask(bcs)
    out = torch.full((nz, ny, nx), float("nan"))
    r = torch.full_like(out, float("nan")) if p.residual else None
    writes = torch.zeros((nz, ny, nx), dtype=torch.int64)
    R, ns, rs = p.ring, 2 * p.width, int(p.residual)
    for o0, o1, w0_, w1_ in _blocks(p, (nze, nye, nx), hz, hy):
        writes[o0[0] - hz:o1[0] - hz, o0[1] - hy:o1[1] - hy, o0[2]:o1[2]] += 1
        gy, gx = torch.arange(w0_[1], w1_[1]), torch.arange(w0_[2], w1_[2])
        WZ, WY, WX = (b - a for a, b in zip(w0_, w1_))
        j, i = torch.arange(WY), torch.arange(WX)
        ry = _reach(gy, w0_[1], w1_[1], nye, gy0, NY, dm & 4, dm & 8, zy)
        rx = _reach(gx, w0_[2], w1_[2], nx, 0, nx, dm & 16, dm & 32, False)
        # reflected neighbours inside the window (at a cut edge: clipped,
        # and never updated)
        rl = torch.where(gy == 0, j + 1, j - 1).clamp(0, WY - 1)
        rh = torch.where(gy == nye - 1, j - 1, j + 1).clamp(0, WY - 1)
        il = torch.where(gx == 0, i + 1, i - 1).clamp(0, WX - 1)
        ih = torch.where(gx == nx - 1, i - 1, i + 1).clamp(0, WX - 1)
        ring = torch.full((R, WY, WX), float("nan"))
        fring = torch.full_like(ring, float("nan"))

        def load(q):
            win = (w0_[0] + q, slice(w0_[1], w1_[1]), slice(w0_[2], w1_[2]))
            ring[q % R], fring[q % R] = ue[win], re[win]

        def neighbours(q):
            gz = w0_[0] + q
            zl = q + 1 if gz == 0 else q - 1
            zh = q - 1 if gz == nze - 1 else q + 1
            return ring[q % R], ring[zl % R], ring[zh % R], fring[q % R]

        def sweep(st, q):
            gz = w0_[0] + q
            rz = _reach(torch.tensor(gz), w0_[0], w1_[0], nze, gz0, NZ, dm & 1, dm & 2, True)
            if int(rz) <= st:
                return
            u, ul, uh, f = neighbours(q)
            parity = (gz0 + gz + gy0 + gy[:, None] + gx[None, :]) % 2
            mask = (ry[:, None] > st) & (rx[None, :] > st) & (parity == color ^ (st & 1))
            t = (ul + uh) * wz
            t = t + (u[rl] + u[rh]) * wy
            t = t + (u[:, il] + u[:, ih]) * wx
            ring[q % R] = torch.where(mask, (t - f) * w0, u)

        def tile_of(a):
            return a[o0[1] - w0_[1]:o1[1] - w0_[1], o0[2] - w0_[2]:o1[2] - w0_[2]]

        def residual(q):
            gz = w0_[0] + q
            u, ul, uh, f = neighbours(q)
            c2 = 2.0 * u
            t = ((ul - c2) + uh) * wz
            t = t + ((u[rl] - c2) + u[rh]) * wy
            t = t + ((u[:, il] - c2) + u[:, ih]) * wx
            frozen = ((bool(dm & 1) & (gz0 + gz == 0)) | (bool(dm & 2) & (gz0 + gz == NZ - 1))
                      | (bool(dm & 4) & (gy0 + gy[:, None] == 0))
                      | (bool(dm & 8) & (gy0 + gy[:, None] == NY - 1))
                      | (bool(dm & 16) & (gx[None, :] == 0))
                      | (bool(dm & 32) & (gx[None, :] == nx - 1)))
            return tile_of(torch.where(frozen, torch.zeros(()), f - t))

        dst = (slice(o0[1] - hy, o1[1] - hy), slice(o0[2], o1[2]))
        qo0, qo1 = o0[0] - w0_[0], o1[0] - w0_[0]
        load(0)
        for t in range(qo1 + ns + rs):
            if t + 1 < WZ:
                load(t + 1)  # lands, at the latest, while the stages run
            for st in range(ns):
                q = t - 1 - st
                if 0 <= q < WZ:
                    sweep(st, q)
            q = t - ns
            if qo0 <= q < qo1:
                out[(w0_[0] + q - hz,) + dst] = tile_of(ring[q % R])
            q = t - ns - 1
            if rs and qo0 <= q < qo1:
                r[(w0_[0] + q - hz,) + dst] = residual(q)
    return out, r, writes


# ----------------------------------------------------------------------
# (a) the plan
# ----------------------------------------------------------------------


PLAN_CASES = [  # (real block, halos) of paths 4, 4b, 5 and 5b, and small ones
    ((110, 220, 220), (1, 0)), ((55, 220, 220), (1, 0)), ((64, 256, 256), (1, 0)),
    ((4, 16, 16), (1, 0)), ((110, 110, 220), (1, 1)), ((55, 110, 220), (1, 1)),
    ((64, 128, 256), (1, 1)), ((4, 8, 16), (1, 1)), ((8, 9, 16), (1, 1)), ((3, 24, 24), (1, 0)),
]


@pytest.mark.parametrize("real,cut", PLAN_CASES)
def test_shard_pass_plan_invariants(real, cut):
    for ns, res, extra in itertools.product((1, 2), (False, True), (0, 1)):
        H = 2 * ns + res + extra
        halos = (H, H * cut[1])
        ext = (real[0] + 2 * halos[0], real[1] + 2 * halos[1], real[2])
        p = zc.shard_pass_plan(ext, halos, ns, res)
        assert p.width == ns and p.residual == res and p.halo == 2 * ns + res
        assert not p.resident and p.ring == 2 * ns + 2 + zc.PASS_AHEAD + res
        assert p.smem_bytes == 2 * p.ring * p.window[1] * (-(-p.window[2] // 2) * 2) * 4
        assert p.smem_bytes <= zc.MAX_SMEM
        assert p.window[1] <= zc.PASS_WINDOW and p.window[2] <= zc.PASS_WINDOW
        assert p.grid[2] == 1
        count = np.zeros(real, dtype=np.int64)
        for o0, o1, w0, w1 in _blocks(p, ext, *halos):
            count[o0[0] - halos[0]:o1[0] - halos[0], o0[1] - halos[1]:o1[1] - halos[1],
                  o0[2]:o1[2]] += 1
            for ax in range(3):
                assert w1[ax] - w0[ax] <= p.window[ax]
                if ax < 2 and (ax == 0 or cut[1]):  # a partitioned axis: never clamped
                    assert w0[ax] == o0[ax] - p.halo and w1[ax] == o1[ax] + p.halo
        assert (count == 1).all(), "a real point written more or less than once"


def test_shard_pass_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        zc.shard_pass_plan((110 + 2 * 41, 220, 220), (41, 0), 20, True)


# ----------------------------------------------------------------------
# (b) the emulation against the plain versions
# ----------------------------------------------------------------------


def _shards(level, grid):
    """(offsets, reals) of a first, an inner and a last shard of a z mesh,
    or of every shard of a (z, y) mesh."""
    local = [n // g for n, g in zip(level, grid)]
    if len(grid) == 1:
        return [((c * local[0],), (local[0],)) for c in sorted({0, grid[0] // 2, grid[0] - 1})]
    return [((cz * local[0], cy * local[1]), tuple(local))
            for cz, cy in itertools.product(range(grid[0]), range(grid[1]))]


CASES = [((24, 24, 24), (3,)), ((20, 18, 16), (2, 2))]


@pytest.mark.parametrize("level,grid", CASES)
@pytest.mark.parametrize("tag", list(BCS))
@pytest.mark.parametrize("ns", [1, 2])
def test_emulated_shard_pass_is_the_plain_version(level, grid, tag, ns):
    bcs = BCS[tag]
    rng = np.random.default_rng(ns + 10 * list(BCS).index(tag))
    u_g, r_g = (rng.standard_normal(level).astype(np.float32) for _ in range(2))
    zy = len(grid) == 2
    k = list(BCS).index(tag) + ns
    for s, (offsets, reals) in enumerate(_shards(level, grid)):
        for res in (False, True):
            # the pass's own halo, or one more (its window's edge then lies
            # inside the halo); the plan's tile, or the small one
            extra, small = (k + s + res) % 2, (k + s) % 2 == 1
            H = 2 * ns + res + extra
            halos = (H, H) if zy else (H,)
            ue = torch.as_tensor(_extend(u_g, offsets, reals, halos))
            re = torch.as_tensor(_extend(r_g, offsets, reals, halos))
            hz, hy = (halos + (0,))[:2]
            p = (zc.shard_pass_tile(ue.shape, (hz, hy), ns, res, SMALL_TILE) if small
                 else zc.shard_pass_plan(ue.shape, (hz, hy), ns, res))
            extents = tuple(level[:len(grid)])
            got_u, got_r, writes = emulate_shard_pass(ue, re, DQ, bcs, offsets, extents,
                                                      halos, p)
            assert (writes == 1).all()
            if zy:
                fn = (zc_sharded.zc_smooth_residual_sharded_3d_zy_plain if res
                      else zc_sharded.zc_smooth_sharded_3d_zy_plain)
                want = fn(ue, re, DQ, bcs, ns, offsets, extents, halos)
            else:
                fn = (zc_sharded.zc_smooth_residual_sharded_3d_plain if res
                      else zc_sharded.zc_smooth_sharded_3d_plain)
                want = fn(ue, re, DQ, bcs, ns, offsets[0], extents[0], H)
            want_u, want_r = want if res else (want, None)
            where = f"shard at {offsets}, H={H}, tile {p.tile}"
            assert torch.equal(got_u, want_u), f"u, {where}"
            if res:
                assert torch.equal(got_r, want_r), f"r, {where}"
