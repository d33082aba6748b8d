"""The halves form of the multi-sweep pass (csrc/lane_pass.cuh with C, the
kernel behind ops/compact.py: compact_smooth_3d and its lane form), on the
CPU.

The kernel runs only on the card (chip_smoke.py holds it bitwise against
the plain versions there).  What can be checked here:

  (a) ``compact.compact_plan`` / ``compact.compact_tile``: the widths sum
      to the sweeps; the tiles cover every entry of both halves exactly
      once a pass, the ghosts of odd nx included; a tile's width is even
      or the tile spans nx (an odd one is refused); the window is the tile
      grown by the halo 2w and clamped; shared memory fits a block; the
      plan is ops/zc.py's ``pass_plan`` where its tiles are even;
  (b) a block-level emulation in torch of the pass as the kernel runs it,
      driven by the plan (its width forced to 1, 2, 3 or 5, with the
      default tile or small even ones that cut every axis): the window
      load of two segments a row, (rp ? B : R) into the even half of the
      shared row and (rp ? R : B) into the odd half; the ring of planes;
      the stages in order on planes t - 1 - s; the points past their
      reach left as they are;
      the store of the tile's two segments with the ghost of odd nx
      written from x = nx - 2 by the tile that owns it; a frozen lane's
      copy; the resident pass.  It must equal
      ``compact_smooth_3d(_batched)_plain`` **bitwise**, halves and
      ghosts, every entry written once.  Unloaded shared words and
      unwritten outputs are NaN;
  (c) one case against JAX's interpreted Pallas ``compact_smooth_3d``,
      within the tolerance of tests/test_torch_compact.py (1 ulp of
      max|u| a sweep: XLA:CPU contracts multiply-adds, the port does not).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndsm_tpu.ops import pallas_compact
from ndsm_tpu.ops import stencils_compact as jsc
from ndsm_tpu_torch.ops import compact, stencils, zc
from ndsm_tpu_torch.ops import stencils_compact as sc

torch.set_num_threads(1)

DQ = (0.9, 1.1, 1.0)
COMPONENTS = (
    (("D", "D"), ("D", "D"), ("N", "N")),  # Ax
    (("D", "D"), ("N", "N"), ("D", "D")),  # Ay
    (("N", "N"), ("D", "D"), ("D", "D")),  # Az
)
ALL_D = (("D", "D"),) * 3
MIXED = ((("D", "N"), ("N", "D"), ("D", "D")), (("N", "D"), ("D", "N"), ("N", "N")))
FAR = 1 << 20
NAN = float("nan")


# ----------------------------------------------------------------------
# (a) the plan
# ----------------------------------------------------------------------


def _blocks(shape, p):
    """(o0, o1, w0, w1) of every block of pass ``p`` over one lane."""
    nz, ny, nx = shape
    cz, ty, tx = p.tile
    ntx = -(-nx // tx)
    for bx, bz in itertools.product(range(p.grid[0]), range(p.grid[1])):
        o0 = (bz * cz, (bx // ntx) * ty, (bx % ntx) * tx)
        o1 = tuple(min(n, a + t) for a, t, n in zip(o0, (cz, ty, tx), shape))
        w0 = tuple(max(0, a - p.halo) for a in o0)
        w1 = tuple(min(n, b + p.halo) for b, n in zip(o1, shape))
        yield o0, o1, w0, w1


def _segments(o0x, o1x, nx):
    """The tile's entries of each half of a row: k0 + [0, ne) of the even
    columns, k0 + [0, no) of the odd ones, and whether the last odd one is
    the ghost (the tile owns x = nx - 2 of odd nx)."""
    ghost = nx % 2 == 1 and o0x <= nx - 2 < o1x
    return o0x // 2, (o1x - o0x + 1) // 2, (o1x - o0x) // 2 + ghost, ghost


PLAN_SHAPES = [(220, 220, 220), (221, 220, 221), (110, 110, 110), (55, 55, 55), (27, 27, 27),
               (13, 13, 13), (6, 6, 6), (2, 3, 5), (9, 7, 9), (30, 17, 70), (12, 10, 13)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_invariants(shape):
    nz, ny, nx = shape
    hx = (nx + 1) // 2
    small = max(shape) <= 30
    for ns, nb in itertools.product((1, 2, 5), (1, 3)):
        plan = compact.compact_plan(shape, ns, nb)
        assert sum(p.width for p in plan) == ns
        assert plan[0].resident == (nz * ny * nx <= zc.PASS_RESIDENT)
        assert plan == zc.pass_plan(shape, ns, nb)
        passes = list(plan)
        if small:
            passes += [compact.compact_tile(shape, w, nb, t)
                       for w, t in itertools.product((1, 2, 3), ((3, 4, 4), (2, 3, 2)))]
        for p in passes:
            _check_pass(shape, nb, p, hx)


def _row(sx):
    """Words of a shared row: the even columns, then the odd ones."""
    return 2 * -(-sx // 2)


def _check_pass(shape, nb, p, hx):
    nz, ny, nx = shape
    assert not p.residual and p.halo == 2 * p.width and p.grid[2] == nb
    assert p.tile[2] % 2 == 0 or p.tile[2] == nx, "a window must start on an even column"
    assert p.smem_bytes <= 227 * 1024
    assert p.window[1] <= zc.PASS_WINDOW and p.window[2] <= zc.PASS_WINDOW
    assert p.smem_bytes == 2 * p.ring * p.window[1] * _row(p.window[2]) * 4
    if p.resident:
        assert p.tile == tuple(shape) and p.ring == nz
    else:
        assert p.ring == 2 * p.width + 2 + zc.PASS_AHEAD
    # the blocks are the product of per-axis intervals: z and y covered once,
    # and along x each entry of both halves of a row (the ghost included)
    seen = [set() for _ in shape]
    n_blocks = 0
    for o0, o1, w0, w1 in _blocks(shape, p):
        n_blocks += 1
        assert w0[2] % 2 == 0, "a window starts on an odd column"
        for a, n in enumerate(shape):
            assert w0[a] == max(0, o0[a] - p.halo) and w1[a] == min(n, o1[a] + p.halo)
            seen[a].add((o0[a], o1[a]))
    assert n_blocks == p.grid[0] * p.grid[1] == np.prod([len(x) for x in seen])
    for a in (0, 1):
        count = np.zeros(shape[a], np.int64)
        for lo, hi in seen[a]:
            count[lo:hi] += 1
        assert (count == 1).all()
    even, odd = np.zeros(hx, np.int64), np.zeros(hx, np.int64)
    for lo, hi in seen[2]:
        k0, ne, no, _ = _segments(lo, hi, nx)
        even[k0:k0 + ne] += 1
        odd[k0:k0 + no] += 1
    assert (even == 1).all() and (odd == 1).all()


def test_odd_tile_width_refused():
    with pytest.raises(ValueError):
        compact.compact_tile((12, 10, 14), 1, 1, (3, 4, 5))
    # an odd width that spans nx is one tile: taken
    assert compact.compact_tile((12, 10, 13), 1, 1, (3, 4, 13)).tile[2] == 13


def test_default_plan_rule():
    """ns = 5 at the compact route's levels: widths 2, 2, 1 at 220^3 down
    to 27^3 (marching), one resident pass at 13^3 and 6^3."""
    for n in (220, 110, 55, 27):
        plan = compact.compact_plan((n, n, n), 5, 3)
        assert [p.width for p in plan] == [2, 2, 1] and not any(p.resident for p in plan)
    for n in (13, 6):
        (p,) = compact.compact_plan((n, n, n), 5, 3)
        assert p.resident and p.width == 5 and p.grid == (1, 1, 3)


# ----------------------------------------------------------------------
# (b) the block-level emulation
# ----------------------------------------------------------------------


def _reach(g, n, w0, w1, dlo, dhi):
    """Stages a window index (global ``g`` in [w0, w1)) is worth updating:
    its distance from a cut edge of the window, -1 on a Dirichlet face."""
    g = torch.as_tensor(g)
    d = torch.minimum(g - w0 if w0 > 0 else torch.full_like(g, FAR),
                      (w1 - 1 - g) if w1 < n else torch.full_like(g, FAR))
    d = torch.where((g == 0) & bool(dlo), -1, d)
    return torch.where((g == n - 1) & bool(dhi), -1, d)


class _LaneBlock:
    """One block of a pass over one active lane of the stack, as the
    kernel's threads run it: the shared rings are flat (ring, WY * SX)."""

    def __init__(self, src, rhs, out, writes, b, shape, p, o0, o1, w0, w1, bcs):
        self.src, self.rhs, self.out, self.writes, self.b = src, rhs, out, writes, b
        self.shape, self.p, self.o0, self.o1, self.w0, self.w1 = shape, p, o0, o1, w0, w1
        nz, ny, nx = shape
        self.WZ, self.WY, self.WX = (e - a for a, e in zip(w0, w1))
        self.SX = _row(p.window[2])
        self.HX = self.SX // 2
        self.color = stencils.first_color_parity(bcs)
        self.dm = zc.dirichlet_mask(bcs)
        self.w = stencils.stencil_weights(DQ, torch.float32)
        self.rows = torch.arange(self.WY)
        self.gy = w0[1] + self.rows
        i = torch.arange(self.WX)
        self.gx = w0[2] + i
        self.col = (i % 2) * self.HX + i // 2
        il = torch.where(self.gx == 0, i + 1, i - 1).clamp(0, self.WX - 1)
        ih = torch.where(self.gx == nx - 1, i - 1, i + 1).clamp(0, self.WX - 1)
        self.coll, self.colh = self.col[il], self.col[ih]
        ry = _reach(self.gy, ny, w0[1], w1[1], self.dm & 4, self.dm & 8)
        rx = _reach(self.gx, nx, w0[2], w1[2], self.dm & 16, self.dm & 32)
        self.rxy = torch.minimum(ry[:, None], rx[None, :])  # a point's reach in y and x
        self.rz = [int(r) for r in _reach(torch.arange(w0[0], w1[0]), nz, w0[0], w1[0],
                                          self.dm & 1, self.dm & 2)]
        self.par = (self.gy[:, None] + self.gx[None, :]) % 2
        # rows and their reflected neighbour rows (clipped at cut edges: never updated)
        jl = torch.where(self.gy == 0, self.rows + 1, self.rows - 1).clamp(0, self.WY - 1)
        jh = torch.where(self.gy == ny - 1, self.rows - 1, self.rows + 1).clamp(0, self.WY - 1)
        self.base = self.rows[:, None] * self.SX
        self.jl, self.jh = jl[:, None] * self.SX, jh[:, None] * self.SX
        self.gyl, self.gyh = w0[1] + jl, w0[1] + jh
        R = p.ring
        self.U = torch.full((R, self.WY * self.SX), NAN)
        self.F = torch.full_like(self.U, NAN)

    def load(self, q):
        """Two segments a row of u and rhs into ring slot q % ring."""
        b, gz, k0 = self.b, self.w0[0] + q, self.w0[2] // 2
        ne, no = (self.WX + 1) // 2, self.WX // 2
        rp = ((gz + self.gy) % 2 == 1)[:, None]
        slot = q % self.p.ring
        self.U[slot] = NAN
        self.F[slot] = NAN
        for half, cnt in ((0, ne), (1, no)):
            m = torch.arange(cnt)
            idx = (self.rows[:, None] * self.SX + half * self.HX + m).reshape(-1)
            for ring, (hr, hb) in ((self.U, self.src), (self.F, self.rhs)):
                r_, b_ = hr[b, gz, self.gy, k0:k0 + cnt], hb[b, gz, self.gy, k0:k0 + cnt]
                # even columns from (rp ? B : R), odd ones from (rp ? R : B)
                seg = torch.where(rp, b_, r_) if half == 0 else torch.where(rp, r_, b_)
                ring[slot, idx] = seg.reshape(-1)

    def sweep(self, st, q):
        """Stage st (colour = first colour ^ (st & 1)) on window plane q."""
        nz = self.shape[0]
        if self.rz[q] <= st:
            return
        gz, R, col, base = self.w0[0] + q, self.p.ring, self.col, self.base
        gzl, gzh = (1 if gz == 0 else gz - 1), (gz - 1 if gz == nz - 1 else gz + 1)
        u, ul, uh = self.U[q % R], self.U[(gzl - self.w0[0]) % R], self.U[(gzh - self.w0[0]) % R]
        f = self.F[q % R]
        p_ = base + col
        (wz, wy, wx), w0 = self.w
        t = (ul[p_] + uh[p_]) * wz
        t = t + (u[self.jl + col] + u[self.jh + col]) * wy
        t = t + (u[base + self.coll] + u[base + self.colh]) * wx
        v = (t - f[p_]) * w0
        mask = (self.rxy > st) & (self.par == (self.color ^ (st & 1) ^ gz) & 1)
        u[p_[mask]] = v[mask]

    def store(self, q):
        """The tile's two segments of each row, the ghost from x = nx - 2."""
        b, (R_out, B_out), (wR, wB) = self.b, self.out, self.writes
        nx = self.shape[2]
        gz = self.w0[0] + q
        k0, ne, no, ghost = _segments(self.o0[2], self.o1[2], nx)
        s0 = (self.o0[2] - self.w0[2]) // 2
        u = self.U[q % self.p.ring]
        ys = torch.arange(self.o0[1], self.o1[1])
        rp = (gz + ys) % 2 == 1
        start = ((ys - self.w0[1]) * self.SX)[:, None] + s0
        l = torch.arange(no)
        if ghost:
            l[-1] -= 1
        ev, od = u[start + torch.arange(ne)], u[start + self.HX + l]
        # even columns to (rp ? B : R), odd ones to (rp ? R : B)
        _put(B_out, wB, R_out, wR, b, gz, ys, rp, k0, ev)
        _put(R_out, wR, B_out, wB, b, gz, ys, rp, k0, od)


def _put(on_rp, count_rp, off_rp, count_off, b, z, ys, rp, k0, vals):
    """Rows ``ys`` of plane z, entries k0 + [0, n), into ``on_rp`` where
    the row parity is 1 and ``off_rp`` where it is 0; count the writes."""
    n = vals.shape[1]
    for tgt, cnt, sel in ((on_rp, count_rp, rp), (off_rp, count_off, ~rp)):
        tgt[b, z, ys[sel], k0:k0 + n] = vals[sel]
        cnt[b, z, ys[sel], k0:k0 + n] += 1


def emulate_compact_pass(R, B, rR, rB, bcs_list, active, nx, p):
    """One pass ``p`` over (nb, nz, ny, hx) halves as the kernel's halves
    form runs it, block by block.  Returns (R', B') and the write counts."""
    nb, nz, ny, hx = R.shape
    shape = (nz, ny, nx)
    out = (torch.full_like(R, NAN), torch.full_like(B, NAN))
    writes = (torch.zeros(R.shape, dtype=torch.int64), torch.zeros(B.shape, dtype=torch.int64))
    ns = 2 * p.width
    for o0, o1, w0, w1 in _blocks(shape, p):
        for b in range(nb):
            if not active[b]:  # a frozen lane: the tile's entries of both halves copied
                k0, ne, no, _ = _segments(o0[2], o1[2], nx)
                ys = torch.arange(o0[1], o1[1])
                for z in range(o0[0], o1[0]):
                    rp = (z + ys) % 2 == 1
                    ev = torch.where(rp[:, None], B[b, z, ys, k0:k0 + ne], R[b, z, ys, k0:k0 + ne])
                    od = torch.where(rp[:, None], R[b, z, ys, k0:k0 + no], B[b, z, ys, k0:k0 + no])
                    _put(out[1], writes[1], out[0], writes[0], b, z, ys, rp, k0, ev)
                    _put(out[0], writes[0], out[1], writes[1], b, z, ys, rp, k0, od)
                continue
            blk = _LaneBlock((R, B), (rR, rB), out, writes, b, shape, p, o0, o1, w0, w1,
                             bcs_list[b])
            nzw = w1[0] - w0[0]
            if p.resident:  # every plane, then each stage over every plane
                for q in range(nzw):
                    blk.load(q)
                for st in range(ns):
                    for q in range(nzw):
                        blk.sweep(st, q)
                for q in range(nzw):
                    blk.store(q)
                continue
            qo0, qo1 = o0[0] - w0[0], o1[0] - w0[0]
            blk.load(0)
            for t in range(qo1 + ns):
                if t + zc.PASS_AHEAD < nzw:
                    blk.load(t + zc.PASS_AHEAD)
                for st in range(ns):
                    if 0 <= t - 1 - st < nzw:
                        blk.sweep(st, t - 1 - st)
                if qo0 <= t - ns < qo1:
                    blk.store(t - ns)
    return out, writes


def emulate_compact(R, B, rR, rB, bcs_list, nsweeps, nx, active, width=None, tile=None):
    """The passes of ``compact_plan`` (``width`` None), or of its marching
    rule with the width forced (each tile forced to ``tile`` when given),
    chained."""
    nb, nz, ny, _ = R.shape
    shape = (nz, ny, nx)
    if width is None:
        plan = compact.compact_plan(shape, nsweeps, nb)
    else:
        widths = [width] * (nsweeps // width) + ([nsweeps % width] if nsweeps % width else [])
        # (a whole-lane tile that fits runs resident, as the kernel makes it)
        plan = tuple(compact.compact_tile(shape, w, nb, tile) for w in widths)
    for p in plan:
        (R, B), writes = emulate_compact_pass(R, B, rR, rB, bcs_list, active, nx, p)
        assert all((w == 1).all() for w in writes), "an entry written more or less than once"
    return R, B


def _halves(shape, nb, seed):
    rng = np.random.default_rng(seed)
    u, r = (torch.as_tensor(rng.standard_normal((nb,) + shape).astype(np.float32))
            for _ in range(2))
    return sc.split_colors_p(u, sc.row_parity(shape[:2], "cpu")) + \
        sc.split_colors_p(r, sc.row_parity(shape[:2], "cpu"))


def _check(shape, lanes, ns, active, width, tile, seed):
    R, B, rR, rB = _halves(shape, len(lanes), seed)
    act = [True] * len(lanes) if active is None else list(active)
    got = emulate_compact(R, B, rR, rB, lanes, ns, shape[-1], act, width, tile)
    want = compact.compact_smooth_3d_batched_plain(R, B, rR, rB, DQ, lanes, ns, shape[-1],
                                                   active)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


SHAPES = [(8, 10, 14), (7, 9, 11), (9, 7, 9), (6, 5, 4), (2, 3, 5)]
WIDTHS = [1, 2, 3, 5]
SMALL_TILES = [(3, 4, 4), (2, 3, 2)]
FROZEN = [None, (True, True, False), (False, True, False)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("width", WIDTHS)
def test_emulated_pass_is_the_plain_sweeps(shape, width):
    """Three component lanes, a small even tile (ns and the frozen pattern
    vary with the case, so that every shape and width meets ns 1, 2 and 5
    and both frozen patterns)."""
    k = SHAPES.index(shape) + WIDTHS.index(width)
    ns = (1, 2, 5)[k % 3]
    _check(shape, COMPONENTS, ns, FROZEN[k % 3], width, SMALL_TILES[k % 2], 10 * k)


@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_pass_other_bcs_and_plan(shape):
    """All-Dirichlet and mixed faces, five sweeps in passes of 2, 2 and 1
    over a small tile; then the plan as it is (these shapes: one resident
    pass), Az frozen."""
    _check(shape, (ALL_D,) + MIXED, 5, None, 2, SMALL_TILES[0], 7)
    _check(shape, COMPONENTS, 5, (True, True, False), None, None, 9)


def test_emulated_pass_default_tile_odd_nx():
    """A shape the default rule cuts into several x tiles (tx = 56 at
    width 2, 60 at width 1), odd nx: the last tile owns x = nx - 2 and
    writes the ghost; one lane and a frozen second one."""
    shape = (3, 4, 121)
    plan = compact.compact_plan(shape, 3, 2)
    assert all(p.grid[0] == 3 for p in plan)
    _check(shape, COMPONENTS[:2], 3, (True, False), None, None, 11)


# ----------------------------------------------------------------------
# (c) against JAX's kernel
# ----------------------------------------------------------------------


def test_emulated_pass_matches_pallas_interpret():
    shape, bcs, ns = (16, 16, 32), (("D", "N"), ("N", "D"), ("D", "D")), 3
    rng = np.random.default_rng(3)
    u, r = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    call = pallas_compact.compact_smooth_3d(bcs, np.asarray(DQ), shape, ns, interpret=True)
    assert call is not None
    Rj, Bj = jsc.split_colors(jnp.asarray(u))
    rRj, rBj = jsc.split_colors(jnp.asarray(r))
    want = jax.jit(call)(Rj, Bj, rRj, rBj)
    R, B = sc.split_colors(torch.as_tensor(u))
    rR, rB = sc.split_colors(torch.as_tensor(r))
    got = emulate_compact(R[None], B[None], rR[None], rB[None], (bcs,), ns, shape[-1], [True],
                          2, (8, 8, 16))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g[0].numpy() - w).max() <= ns * float(np.spacing(np.abs(w).max()))


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_compact_pass_bitwise():
    """On the card: the pass equals the plain version bitwise (odd nx: ghosts included; small tiles; a frozen lane)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for shape, tile in (((23, 18, 21), (4, 5, 6)), ((16, 12, 10), None), ((9, 7, 9), None)):
        R, B, rR, rB = (t.cuda() for t in _halves(shape, 3, 5))
        for ns, act in ((1, None), (5, (True, True, False))):
            plan = None if tile is None else tuple(
                compact.compact_tile(shape, w, 3, tile) for w in (2,) * (ns // 2)
                + ((ns % 2,) if ns % 2 else ()))
            got = compact._sweeps_cuda(R, B, rR, rB, DQ, COMPONENTS, ns, shape[-1],
                                       act or (True,) * 3, "test", plan=plan)
            want = compact.compact_smooth_3d_batched_plain(R, B, rR, rB, DQ, COMPONENTS, ns,
                                                           shape[-1], act)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
