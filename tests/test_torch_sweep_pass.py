"""The multi-sweep pass of csrc/fused_smooth.cu (the 3D red-black lane
kernel behind ops/zc.py and ops/fused.py), on the CPU.

The kernel runs only on the card (chip_smoke.py holds it bitwise against
the plain versions there).  What can be checked here:

  (a) ``zc.pass_plan`` / ``zc.pass_tile``: the widths sum to the sweeps,
      the tiles cover every point of every lane exactly once a pass, a
      window is the tile grown by the halo and clamped to the domain (so a
      face and its inner neighbour lie inside it), the shared memory fits
      the H100's 227 KB a block;
  (b) a block-level emulation in torch of the pass as the kernel runs it,
      driven by ``pass_plan`` (its width forced to 1, 2, 3 or 5, and with
      the default tile or a small one that cuts every axis): the window
      load (u + cor in the first pass), the ring of planes with the copy
      of plane t + PASS_AHEAD landing before the stages of step t, the stages in
      order on planes t - 1 - s, the points past their reach (distance
      from a cut edge) left as they are, the crop to the tile, the
      residual of the final planes; and the resident pass of a lane that
      fits shared memory whole (each stage over every plane).  It must equal
      the plain versions (``fused.lane_sweeps`` / ``lane_residual``
      through the ``*_plain`` lane forms, which tests/test_torch_fused.py
      holds against JAX) **bitwise**: every point sees the inputs of the
      half-sweep sequence in the same order.  A slot of the ring reused too
      early, a stage out of order, a halo too thin or a wrong reflection
      shows here as a difference (unloaded planes are NaN).
"""

import itertools
import math

import numpy as np
import pytest
import torch

from ndsm_tpu_torch.ops import fused, stencils, zc

torch.set_num_threads(1)

DQ = np.array([0.9, 1.1, 1.0])
COMPONENTS = (
    (("D", "D"), ("D", "D"), ("N", "N")),  # Ax
    (("D", "D"), ("N", "N"), ("D", "D")),  # Ay
    (("N", "N"), ("D", "D"), ("D", "D")),  # Az
)
ALL_D = (("D", "D"),) * 3
MIXED = ((("D", "N"), ("N", "D"), ("D", "D")), (("N", "D"), ("D", "N"), ("N", "N")))

SHAPES = [(12, 10, 14), (7, 9, 11), (6, 5, 2), (2, 3, 5), (13, 27, 6)]
WIDTHS = [1, 2, 3, 5]
# a tile that cuts every axis of the shapes above into several blocks
SMALL_TILE = (3, 4, 5)


# ----------------------------------------------------------------------
# (a) the plan
# ----------------------------------------------------------------------


def _blocks(shape, p):
    """The output tile and the window of every block of pass ``p`` over
    one lane, as the kernel derives them from its block index."""
    nz, ny, nx = shape
    cz, ty, tx = p.tile
    ntx = -(-nx // tx)
    for bx, bz in itertools.product(range(p.grid[0]), range(p.grid[1])):
        o0 = (bz * cz, (bx // ntx) * ty, (bx % ntx) * tx)
        o1 = tuple(min(n, a + t) for a, t, n in zip(o0, (cz, ty, tx), shape))
        w0 = tuple(max(0, a - p.halo) for a in o0)
        w1 = tuple(min(n, b + p.halo) for b, n in zip(o1, shape))
        yield o0, o1, w0, w1


PLAN_SHAPES = [(220, 220, 220), (110, 110, 110), (55, 55, 55), (27, 27, 27), (13, 13, 13),
               (6, 6, 6), (221, 220, 220), (2, 3, 5), (3, 2, 2), (2, 2, 2), (13, 27, 6)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_pass_plan_invariants(shape):
    for ns, nb, res in itertools.product((1, 2, 5), (1, 3, 8), (False, True)):
        plan = zc.pass_plan(shape, ns, nb, res)
        assert sum(p.width for p in plan) == ns
        assert all(p.residual == (res and i == len(plan) - 1) for i, p in enumerate(plan))
        for p in plan:
            _check_pass(shape, nb, p)
    # forced widths and tiles take the same geometry (small tiles only on
    # small shapes: a block is checked point by point)
    small = max(shape) <= 27
    for w, tile in itertools.product(WIDTHS, (None,) + ((SMALL_TILE, (1, 1, 1)) if small else ())):
        for res in (False, True):
            _check_pass(shape, 2, zc.pass_tile(shape, w, res, 2, tile))


def _check_pass(shape, nb, p):
    assert p.halo == 2 * p.width + p.residual
    assert p.grid[2] == nb
    row = -(-p.window[2] // 2) * 2  # even columns, then odd ones
    if p.resident:  # the whole lane, no march: every plane of u and rhs
        assert p.tile == tuple(shape) and p.ring == shape[0]
        assert p.smem_bytes == 2 * shape[0] * p.window[1] * row * 4
    else:
        assert p.ring == 2 * p.width + 2 + zc.PASS_AHEAD + p.residual
        assert p.smem_bytes == 2 * p.ring * p.window[1] * row * 4
    assert p.smem_bytes <= 227 * 1024
    assert p.window[1] <= zc.PASS_WINDOW and p.window[2] <= zc.PASS_WINDOW
    # the blocks are the product of per-axis intervals: each axis covered once
    seen = [dict() for _ in shape]
    n_blocks = 0
    for o0, o1, w0, w1 in _blocks(shape, p):
        n_blocks += 1
        assert all(a < b for a, b in zip(o0, o1)), "an empty block"
        for ax, n in enumerate(shape):
            seen[ax][(o0[ax], o1[ax])] = (w0[ax], w1[ax])
            # clamped, never padded; the face and its inner neighbour inside
            assert 0 <= w0[ax] <= o0[ax] and o1[ax] <= w1[ax] <= n
            assert w0[ax] == max(0, o0[ax] - p.halo) and w1[ax] == min(n, o1[ax] + p.halo)
            assert 2 <= w1[ax] - w0[ax] <= p.window[ax]
    assert n_blocks == p.grid[0] * p.grid[1] == math.prod(len(s_) for s_ in seen)
    for ax, n in enumerate(shape):
        count = np.zeros(n, dtype=np.int64)
        for a, b in seen[ax]:
            count[a:b] += 1
        assert (count == 1).all(), "a point written more or less than once a pass"


def test_default_plan_rule():
    # ns = 5 at the main path's levels: ceil(5 / PASS_WIDTH) passes, the
    # remainder last; the residual only in the last
    plan = zc.pass_plan((220, 220, 220), 5, 3, True)
    assert len(plan) == math.ceil(5 / zc.PASS_WIDTH) and not any(p.resident for p in plan)
    assert [p.width for p in plan] == sorted((p.width for p in plan), reverse=True)
    assert plan[-1].residual and not any(p.residual for p in plan[:-1])
    assert all(p.smem_bytes <= zc.MAX_SMEM for p in plan)
    # the small levels of the main path: one resident pass of all sweeps
    for n in (13, 6):
        (p,) = zc.pass_plan((n, n, n), 5, 3, True)
        assert p.resident and p.width == 5 and p.residual and p.grid == (1, 1, 3)
    for n in (55, 27):
        assert not any(p.resident for p in zc.pass_plan((n, n, n), 5, 3))


# ----------------------------------------------------------------------
# (b) the block-level emulation
# ----------------------------------------------------------------------


def _reach(g, n, w0, w1, dlo, dhi):
    """Stages a window index (global ``g`` in [w0, w1)) is worth updating:
    its distance from a cut edge of the window, -1 on a Dirichlet face."""
    far = 1 << 20
    i = g - w0
    d = torch.minimum(i if w0 > 0 else torch.full_like(i, far),
                      (w1 - 1 - g) if w1 < n else torch.full_like(i, far))
    d = torch.where((g == 0) & bool(dlo), -1, d)
    return torch.where((g == n - 1) & bool(dhi), -1, d)


class _Block:
    """One block of a pass over the lanes of a stack (the active lanes
    share the geometry; colour and faces are per lane)."""

    def __init__(self, shape, p, o0, o1, w0, w1, bcs_list):
        self.p, self.o0, self.o1, self.w0, self.w1 = p, o0, o1, w0, w1
        nz, ny, nx = shape
        self.shape = shape
        self.color = torch.tensor([stencils.first_color_parity(b) for b in bcs_list])
        self.dmask = [zc.dirichlet_mask(b) for b in bcs_list]
        gy = torch.arange(w0[1], w1[1])
        gx = torch.arange(w0[2], w1[2])
        wy, wx = len(gy), len(gx)
        j, i = torch.arange(wy), torch.arange(wx)
        # reflected neighbour rows / columns inside the window (cut edges:
        # clipped, and masked out below)
        self.rl = torch.where(gy == 0, j + 1, j - 1).clamp(0, wy - 1)
        self.rh = torch.where(gy == ny - 1, j - 1, j + 1).clamp(0, wy - 1)
        self.il = torch.where(gx == 0, i + 1, i - 1).clamp(0, wx - 1)
        self.ih = torch.where(gx == nx - 1, i - 1, i + 1).clamp(0, wx - 1)
        self.gy, self.gx = gy, gx
        # per lane: how many stages each row / column is worth updating (the
        # kernel's reach: distance from a cut edge, -1 on a Dirichlet face)
        self.ry = torch.stack([_reach(gy, ny, w0[1], w1[1], dm & 4, dm & 8) for dm in self.dmask])
        self.rx = torch.stack([_reach(gx, nx, w0[2], w1[2], dm & 16, dm & 32)
                               for dm in self.dmask])

    def sweep(self, ring, fring, st, q, w):
        p, (nz, ny, nx) = self.p, self.shape
        R, wz0, nzw = p.ring, self.w0[0], self.w1[0] - self.w0[0]
        gz = wz0 + q
        rz = torch.stack([_reach(torch.tensor([gz]), nz, wz0, self.w1[0], dm & 1, dm & 2)
                          for dm in self.dmask])[:, 0]
        zl = q + 1 if gz == 0 else q - 1
        zh = q - 1 if gz == nz - 1 else q + 1
        (wz, wy, wx), w0 = w
        u, ul, uh, f = ring[q % R], ring[zl % R], ring[zh % R], fring[q % R]
        col = self.color ^ (st & 1)
        parity = (gz + self.gy[:, None] + self.gx[None, :]) % 2
        mask = ((self.ry[:, :, None] > st) & (self.rx[:, None, :] > st)
                & (rz[:, None, None] > st) & (parity[None] == col[:, None, None]))
        t = (ul + uh) * wz
        t = t + (u[:, self.rl] + u[:, self.rh]) * wy
        t = t + (u[:, :, self.il] + u[:, :, self.ih]) * wx
        ring[q % R] = torch.where(mask, (t - f) * w0, u)

    def residual(self, ring, fring, q, w, interior):
        p, (nz, ny, nx) = self.p, self.shape
        R, gz = p.ring, self.w0[0] + q
        zl = q + 1 if gz == 0 else q - 1
        zh = q - 1 if gz == nz - 1 else q + 1
        (wz, wy, wx), _ = w
        u, ul, uh, f = ring[q % R], ring[zl % R], ring[zh % R], fring[q % R]
        c2 = 2.0 * u
        t = ((ul - c2) + uh) * wz
        t = t + ((u[:, self.rl] - c2) + u[:, self.rh]) * wy
        t = t + ((u[:, :, self.il] - c2) + u[:, :, self.ih]) * wx
        r = f - t
        y0, x0 = self.o0[1] - self.w0[1], self.o0[2] - self.w0[2]
        y1, x1 = self.o1[1] - self.w0[1], self.o1[2] - self.w0[2]
        inner = interior[:, gz, self.o0[1]:self.o1[1], self.o0[2]:self.o1[2]]
        return torch.where(inner, r[:, y0:y1, x0:x1], torch.zeros(()))


def emulate_pass(src, cor, rhs, dq, bcs_list, active, p):
    """One pass ``p`` over a (B, nz, ny, nx) stack as csrc/fused_smooth.cu's
    lane_pass runs it, block by block.  Returns (dst, r, writes)."""
    nb = src.shape[0]
    shape = tuple(src.shape[1:])
    w = stencils.stencil_weights(dq, torch.float32)
    dst = torch.full_like(src, float("nan"))
    r = torch.full_like(src, float("nan")) if p.residual else None
    writes = torch.zeros(src.shape, dtype=torch.int64)
    interior = torch.stack([stencils.interior_mask(shape, b, "cpu") for b in bcs_list])
    on = [b for b in range(nb) if active[b]]
    R = p.ring
    for o0, o1, w0, w1 in _blocks(shape, p):
        sl = (slice(o0[0], o1[0]), slice(o0[1], o1[1]), slice(o0[2], o1[2]))
        for b in range(nb):
            writes[(b,) + sl] += 1
            if not active[b]:  # a frozen lane's block: a copy, zero residual
                dst[(b,) + sl] = src[(b,) + sl]
                if r is not None:
                    r[(b,) + sl] = 0.0
        if not on:
            continue
        blk = _Block(shape, p, o0, o1, w0, w1, [bcs_list[b] for b in on])
        nzw, wy, wx = (b - a for a, b in zip(w0, w1))
        ring = torch.full((R, len(on), wy, wx), float("nan"))
        fring = torch.full_like(ring, float("nan"))

        def load(q):
            win = (on, w0[0] + q, slice(w0[1], w1[1]), slice(w0[2], w1[2]))
            v = src[win]
            ring[q % R] = v + cor[win] if cor is not None else v
            fring[q % R] = rhs[win]

        ns, rs = 2 * p.width, int(p.residual)
        if p.resident:  # every plane loaded, then each stage over every plane
            for q in range(nzw):
                load(q)
            for st in range(ns):
                for q in range(nzw):
                    blk.sweep(ring, fring, st, q, w)
            dst[on] = ring.transpose(0, 1)
            if rs:
                for q in range(nzw):
                    r[on, q] = blk.residual(ring, fring, q, w, interior[on])
            continue
        qo0, qo1 = o0[0] - w0[0], o1[0] - w0[0]
        for q in range(min(zc.PASS_AHEAD, nzw)):
            load(q)
        for t in range(qo1 + ns + rs):
            if t + zc.PASS_AHEAD < nzw:
                load(t + zc.PASS_AHEAD)  # lands, at the latest, while the stages run
            for st in range(ns):
                q = t - 1 - st
                if 0 <= q < nzw:
                    blk.sweep(ring, fring, st, q, w)
            q = t - ns
            if qo0 <= q < qo1:
                dst[on, w0[0] + q, sl[1], sl[2]] = ring[q % R][
                    :, o0[1] - w0[1]:o1[1] - w0[1], o0[2] - w0[2]:o1[2] - w0[2]]
            q = t - ns - 1
            if rs and qo0 <= q < qo1:
                r[on, w0[0] + q, sl[1], sl[2]] = blk.residual(ring, fring, q, w, interior[on])
    return dst, r, writes


def emulate_sweeps(u, cor, rhs, dq, bcs_list, nsweeps, active, residual, width, tile):
    """The passes of ``zc.pass_plan`` (``width`` None), or of its marching
    rule with the width forced to ``width`` (each pass's tile forced to
    ``tile`` when given), chained.  A pass whose tile is the whole lane and
    fits is resident, as the kernel makes it."""
    nb = u.shape[0]
    shape = tuple(u.shape[1:])
    if width is None:
        plan = zc.pass_plan(shape, nsweeps, nb, residual)
    else:
        mp = pytest.MonkeyPatch()
        mp.setattr(zc, "_resident", lambda s: False)
        try:
            plan = zc._plan.__wrapped__(shape, nsweeps, nb, residual, width)
        finally:
            mp.undo()
        assert [p.width for p in plan] == [width] * (nsweeps // width) + (
            [nsweeps % width] if nsweeps % width else [])
    if tile is not None:
        plan = tuple(zc.pass_tile(shape, p.width, p.residual, nb, tile) for p in plan)
    src, r = u, None
    for i, p in enumerate(plan):
        src, r, writes = emulate_pass(src, cor if i == 0 else None, rhs, dq, bcs_list,
                                      active, p)
        assert (writes == 1).all()
    return src, r


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
                 for _ in range(3))


def _check(shape, lanes, ns, active, width, tile, seed):
    u, rhs, cor = _data((len(lanes),) + shape, seed)
    act = [True] * len(lanes) if active is None else list(active)
    got = emulate_sweeps(u, None, rhs, DQ, lanes, ns, act, False, width, tile)[0]
    want = fused.fused_smooth_3d_batched_plain(u, rhs, DQ, lanes, ns, active)
    assert torch.equal(got, want), "smoothing"
    got_u, got_r = emulate_sweeps(u, None, rhs, DQ, lanes, ns, act, True, width, tile)
    want_u, want_r = fused.fused_smooth_residual_3d_batched_plain(u, rhs, DQ, lanes, ns, active)
    assert torch.equal(got_u, want_u) and torch.equal(got_r, want_r), "residual form"
    got = emulate_sweeps(u, cor, rhs, DQ, lanes, ns, act, False, width, tile)[0]
    want = fused.fused_smooth_cor_3d_batched_plain(u, cor, rhs, DQ, lanes, ns, active)
    assert torch.equal(got, want), "correction form"


FROZEN = [None, (True, True, False), (False, True, False)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("width", WIDTHS)
def test_emulated_pass_is_the_plain_sweeps(shape, width):
    """Three component lanes, the default tile and the small one; ns and
    the frozen pattern vary with the case, so that every shape and width
    meets ns 1, 2 and 5 and both frozen patterns."""
    k = SHAPES.index(shape) + WIDTHS.index(width)
    for j, tile in enumerate((None, SMALL_TILE)):
        ns = (1, 2, 5)[(k + j) % 3]
        _check(shape, COMPONENTS, ns, FROZEN[(k + 2 * j) % 3], width, tile, 10 * k + j)


@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_pass_other_bcs(shape):
    """All-Dirichlet and mixed faces (one face of a pair Dirichlet), five
    sweeps in passes of 2, 2 and 1 over the small tile, and the one-lane
    stack; then the plan as it is (these shapes: one resident pass)."""
    _check(shape, (ALL_D,) + MIXED, 5, None, 2, SMALL_TILE, 7)
    _check(shape, (ALL_D,), 2, None, 1, None, 8)
    assert zc.pass_plan(shape, 5, 3, True)[0].resident == (math.prod(shape) <= 16 ** 3)
    _check(shape, COMPONENTS, 5, (True, True, False), None, None, 9)


@pytest.mark.parametrize("ns", [1, 2, 5])
def test_emulated_pass_frozen_lanes(ns):
    """Both frozen patterns at every ns, w = 2, the small tile: a frozen
    lane comes out unchanged (its cor ignored) with a zero residual."""
    shape = (7, 9, 11)
    for active in FROZEN[1:]:
        _check(shape, COMPONENTS, ns, active, 2, SMALL_TILE, 20 + ns)
