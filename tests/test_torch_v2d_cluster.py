"""The lane kernel of csrc/v2d_smooth.cu (the 2D chi-face smoother behind
ops/v2d.py: one block a lane, or a thread-block cluster of C blocks a
lane), on the CPU.

The kernel runs only on the card (chip_smoke.py holds it bitwise against
the plain versions there).  What can be checked here:

  (a) ``v2d.v2d_plan``: every row owned by one block, the shared memory of
      a block within the H100's 227 KB, C <= 16, one block a lane on the
      levels of the 220^3 chi hierarchy below 220^2, a cluster of two at
      220^2, a cluster at 512^2, the global route only past what 16 blocks
      hold;
  (b) a block-by-block emulation in torch of the kernel as it runs, driven
      by the plan (its C forced to 1, 2, 3 and 5): each block's shared
      rows in the split layout (even columns, then odd ones; unloaded
      words NaN), the band and its halo rows loaded (u + cor staged as the
      kernel does), each half-sweep over the band with the kernel's word
      offsets (the x neighbours of each parity, the peeled y faces), the
      halo rows copied from the neighbours' edge rows after each barrier
      (only the colour just updated), the slot partials walked as the
      kernel walks them and chained through the blocks in rank order, the
      tree, the mean subtracted from band and halo rows, the store and the
      residual epilogue.  It must equal ``v2d_smooth_plain``,
      ``_residual_plain`` and ``_cor_plain`` **bitwise**, which
      tests/test_torch_v2d.py holds against JAX;
  (c) the chain alone against ``reduce.strided_block_sum``, bitwise, where
      n is not a multiple of 1024 and the band edges cut a row of slots.
"""

import functools
import itertools

import numpy as np
import pytest
import torch

from ndsm_tpu_torch.ops import reduce, stencils, v2d
from ndsm_tpu_torch.utils.testing import build_test_mesh
from ndsm_tpu_torch.grids import GridHierarchy

torch.set_num_threads(1)

DQ = np.array([0.7, 1.3])
ALL_N = (("N", "N"), ("N", "N"))
MIXED = (("D", "N"), ("N", "D"))
SLOTS = reduce.SUM_THREADS
THREADS = v2d.LANE_THREADS


# ----------------------------------------------------------------------
# (a) the plan
# ----------------------------------------------------------------------


PLAN_SHAPES = [(220, 220), (110, 110), (55, 55), (27, 27), (13, 13), (6, 6), (512, 512),
               (256, 256), (168, 168), (169, 169), (221, 220), (3, 3), (7, 30), (13, 11),
               (2, 700), (660, 660), (700, 700), (3, 20000)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_invariants(shape):
    ny, nx = shape
    for lanes in (1, 6):
        p = v2d.v2d_plan(lanes, ny, nx)
        assert p.grid == (p.cluster, lanes)
        if p.route == "global":
            # only past what a cluster of 16 holds
            assert all(v2d.lane_smem(ny, nx, c) > v2d.MAX_SMEM
                       for c in range(1, min(v2d.MAX_CLUSTER, ny) + 1))
            assert p.cluster == 1 and p.smem_bytes == 0
            continue
        assert p.route == ("block" if p.cluster == 1 else "cluster")
        assert 1 <= p.cluster <= min(v2d.MAX_CLUSTER, ny)
        assert p.smem_bytes == v2d.lane_smem(ny, nx, p.cluster) <= v2d.MAX_SMEM == 232448
        # the fewest blocks that fit
        assert all(v2d.lane_smem(ny, nx, c) > v2d.MAX_SMEM for c in range(1, p.cluster))
        assert p.row_words == 2 * -(-nx // 2)
        _check_bands(ny, p.cluster, p.rows)
    for c in (1, 2, 3, 5, 16):  # forced sizes take the same bands
        p = v2d.v2d_plan(1, ny, nx, cluster=c)
        assert p.cluster == min(c, ny)
        _check_bands(ny, p.cluster, p.rows)


def _check_bands(ny, c, rows):
    count = np.zeros(ny, dtype=np.int64)
    for k in range(c):
        r0, r1 = v2d.band(k, c, ny)
        assert 1 <= r1 - r0 <= rows, "an empty band, or one larger than its rows"
        count[r0:r1] += 1
        if k:
            assert v2d.band(k - 1, c, ny)[1] == r0, "bands out of rank order"
    assert (count == 1).all(), "a row owned by no block or by two"
    assert v2d.area_rows(ny, c) == rows + (2 if c > 1 else 0)


def test_plan_of_the_chi_hierarchies():
    """The chi faces of a 220^3 box: one block a lane below 220^2, a
    cluster of two at 220^2; the 512^3 box's faces on a cluster; no
    global route at or below 512^2."""
    for n, clusters in ((220, {220: 2, 110: 1, 55: 1, 27: 1, 13: 1, 6: 1}),
                        (512, {512: 10, 256: 3})):
        x = build_test_mesh(n)[0]
        h = GridHierarchy.from_mesh((x, x))
        for ny, nx in h.shapes:
            p = v2d.v2d_plan(6, ny, nx)
            assert p.route != "global"
            if ny in clusters:
                assert p.cluster == clusters[ny], (ny, p)
            assert p.route == ("cluster" if p.cluster > 1 else "block")
    assert v2d.v2d_plan(6, 220, 220).route == "cluster"
    assert v2d.v2d_plan(6, 221, 220).cluster == 2
    assert v2d.v2d_plan(6, 168, 168).route == "block"  # the largest square on one block
    assert v2d.v2d_plan(6, 169, 169).cluster == 2
    assert v2d.v2d_plan(6, 700, 700).route == "global"


# ----------------------------------------------------------------------
# (b) the kernel, block by block
# ----------------------------------------------------------------------


def _col_word(x, hx):
    return (x & 1) * hx + (x >> 1)


def _words(rows, nx, hx, S):
    """Word of each point of ``rows`` full rows (row-major), relative to
    the first row, in the split layout."""
    r = torch.arange(rows).repeat_interleave(nx)
    x = torch.arange(nx).repeat(rows)
    return r * S + _col_word(x, hx)


class _Block:
    """Block k's shared memory: U (area rows: band and halos), F (as many
    rows: cor while loading, then rhs from r0) and its slot partials."""

    def __init__(self, k, c, ny, nx):
        self.k, self.c = k, c
        self.r0, self.r1 = v2d.band(k, c, ny)
        self.lo = self.r0 - 1 if k > 0 else self.r0
        self.hi = self.r1 + 1 if k < c - 1 else self.r1
        self.hx, self.S = (nx + 1) // 2, 2 * ((nx + 1) // 2)
        rows = v2d.area_rows(ny, c)
        self.U = torch.full((rows * self.S,), float("nan"), dtype=torch.float32)
        self.F = torch.full((rows * self.S,), float("nan"), dtype=torch.float32)
        self.slots = torch.full((SLOTS,), float("nan"), dtype=torch.float32)


def _load(blk, u, cor, rhs, nx):
    hx, S = blk.hx, blk.S
    w = _words(blk.hi - blk.lo, nx, hx, S)
    blk.U[w] = u[blk.lo:blk.hi].reshape(-1)
    if cor is not None:  # staged in F, added in place
        blk.F[w] = cor[blk.lo:blk.hi].reshape(-1)
        n = (blk.hi - blk.lo) * S
        blk.U[:n] = blk.U[:n] + blk.F[:n]
    wf = _words(blk.r1 - blk.r0, nx, hx, S)
    blk.F[wf] = rhs[blk.r0:blk.r1].reshape(-1)


def _half(blk, ny, nx, color, dmask, w):
    """One half-sweep of ``color`` over the band, the kernel's offsets:
    every point of the colour read first, then written."""
    (wy, wx), w0 = w
    idx = _half_words(blk.k, blk.c, ny, nx, color, dmask)
    if idx is None:
        return
    c, f, yl, yh, xl, xh = idx
    U, F = blk.U, blk.F
    s = (U[yl] + U[yh]) * wy
    s = s + (U[xl] + U[xh]) * wx
    blk.U[c] = (s - F[f]) * w0


@functools.lru_cache(maxsize=None)
def _half_words(k, c, ny, nx, color, dmask):
    """The words a half-sweep of block k reads and writes: the point, its
    rhs, its y neighbours (reflected at the domain's y faces) and its x
    neighbours (the kernel's offsets of each column parity)."""
    blk = _Block(k, c, ny, nx)
    hx, S = blk.hx, blk.S
    c_idx, f_idx, yl_idx, yh_idx, xl_idx, xh_idx = [], [], [], [], [], []
    for y in range(blk.r0, blk.r1):
        if (dmask & 1 and y == 0) or (dmask & 2 and y == ny - 1):
            continue
        p = (color + y) & 1
        for i in range(hx):
            x = 2 * i + p
            if x >= nx or (dmask & 4 and x == 0) or (dmask & 8 and x == nx - 1):
                continue
            own = p * hx + i
            dxl = -hx if p else (0 if i == 0 else -1) + hx
            dxh = (1 - hx if x + 1 < nx else -hx) if p else (hx if x + 1 < nx else hx - 1)
            c = (y - blk.lo) * S + own
            dn = S if y == 0 else -S
            up = -S if y == ny - 1 else S
            c_idx.append(c)
            f_idx.append((y - blk.r0) * S + own)
            yl_idx.append(c + dn)
            yh_idx.append(c + up)
            xl_idx.append(c + dxl)
            xh_idx.append(c + dxh)
    if not c_idx:
        return None
    return tuple(torch.tensor(a, dtype=torch.long)
                 for a in (c_idx, f_idx, yl_idx, yh_idx, xl_idx, xh_idx))


def _copy_halos(blocks, ny, color, halo_rows=1):
    """After a barrier: each block copies the colour-``color`` half of its
    neighbours' edge rows into its halo rows (reading the neighbours'
    words as they are at the barrier)."""
    new = []
    for b in blocks:
        for up in (False, True):
            if (not up and b.k == 0) or (up and b.k == b.c - 1) or not halo_rows:
                continue
            nb = blocks[b.k + 1 if up else b.k - 1]
            g = b.r1 if up else b.r0 - 1
            word = ((color + g) & 1) * b.hx + torch.arange(b.hx)
            new.append((b, (g - b.lo) * b.S + word, nb.U[(g - nb.lo) * nb.S + word].clone()))
    for b, dst, vals in new:
        b.U[dst] = vals


def _slot_walk(slot, blk, nx):
    """The kernel's SlotWalk of the given slots (a LongTensor): terms left,
    row, column and word of the first term in the band."""
    f0, f1 = blk.r0 * nx, blk.r1 * nx
    f = f0 + (((slot - f0) % SLOTS) + SLOTS) % SLOTS
    n = torch.where(f < f1, (f1 - 1 - f) // SLOTS + 1, torch.zeros_like(f))
    y = f // nx
    x = f - y * nx
    return [n, y, x, (y - blk.lo) * blk.S + _col_word(x, blk.hx)]


def _slot_step(s, blk, nx):
    n, y, x, w = s
    dy, dx = SLOTS // nx, SLOTS % nx
    x, y = x + dx, y + dy
    wrap = x >= nx
    if nx % 2 == 0:  # the column parity stays: the word moves by dw (+ hx on a wrap)
        w = w + dy * blk.S + (dx >> 1) + torch.where(wrap, blk.hx, 0)
        x, y = torch.where(wrap, x - nx, x), torch.where(wrap, y + 1, y)
    else:
        x, y = torch.where(wrap, x - nx, x), torch.where(wrap, y + 1, y)
        w = (y - blk.lo) * blk.S + _col_word(x, blk.hx)
    return [n, y, x, w]


def _band_slot_sums(blk, nx, a0, a1):
    """Slots t and t + 512 of every thread t, summed over the band from a0
    and a1, term by term in the kernel's order."""
    t = torch.arange(THREADS)
    s0, s1 = _slot_walk(t, blk, nx), _slot_walk(t + THREADS, blk, nx)
    for m in range(int(max(s0[0].max(), s1[0].max()))):
        for s, which in ((s0, 0), (s1, 1)):
            live = m < s[0]
            v = blk.U[torch.where(live, s[3], 0)]
            if which == 0:
                a0 = torch.where(live, a0 + v, a0)
            else:
                a1 = torch.where(live, a1 + v, a1)
        s0, s1 = _slot_step(s0, blk, nx), _slot_step(s1, blk, nx)
    return a0, a1


def _slot_tree(a0, a1):
    v = a0 + a1  # stride 512
    width = THREADS
    while width > 1:
        width //= 2
        v = v[:width] + v[width:2 * width]
    return v[0]


def _chain(blocks, nx, order=None):
    """The slot partials chained through the blocks in rank order (or
    ``order``), then every block's tree of the last block's partials."""
    a0 = a1 = None
    for k in (range(len(blocks)) if order is None else order):
        b = blocks[k]
        if a0 is None:
            a0 = torch.zeros(THREADS, dtype=torch.float32)
            a1 = torch.zeros(THREADS, dtype=torch.float32)
        a0, a1 = _band_slot_sums(b, nx, a0, a1)
        b.slots[:THREADS], b.slots[THREADS:] = a0, a1
    last = blocks[-1 if order is None else order[-1]]
    return _slot_tree(last.slots[:THREADS], last.slots[THREADS:])


def emulate(u, cor, rhs, dq, bcs, ns, residual=False, cluster=None):
    """The lane kernel on a (ny, nx) or (B, ny, nx) stack, block by block,
    with the plan's C (or ``cluster``)."""
    if u.ndim == 3:
        outs = [emulate(u[b], None if cor is None else cor[b], rhs[b], dq, bcs, ns,
                        residual, cluster) for b in range(u.shape[0])]
        if residual:
            return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
        return torch.stack(outs)
    ny, nx = u.shape
    plan = v2d.v2d_plan(1, ny, nx, cluster)
    assert plan.route != "global"
    c = plan.cluster
    red = stencils.first_color_parity(bcs)
    dmask = _dmask(bcs)
    neumann = stencils.is_all_neumann(bcs)
    inv_n = float(np.float32(1.0 / (ny * nx)))
    w = stencils.stencil_weights(dq, torch.float32)
    blocks = [_Block(k, c, ny, nx) for k in range(c)]
    for b in blocks:
        _load(b, u, cor, rhs, nx)
    for _ in range(ns):
        for b in blocks:
            _half(b, ny, nx, red, dmask, w)
        _copy_halos(blocks, ny, red)
        for b in blocks:
            _half(b, ny, nx, 1 - red, dmask, w)
        _copy_halos(blocks, ny, 1 - red)
        if neumann:
            m = _chain(blocks, nx) * inv_n
            for b in blocks:
                n = (b.hi - b.lo) * b.S
                b.U[:n] = b.U[:n] - m
    out = torch.empty_like(u)
    res = torch.empty_like(u)
    (wy, wx), _ = w
    for b in blocks:
        hx, S = b.hx, b.S
        rows = torch.arange(b.r0, b.r1)
        y = rows.repeat_interleave(nx)
        x = torch.arange(nx).repeat(b.r1 - b.r0)
        cw = _col_word(x, hx)
        row = (y - b.lo) * S
        val = b.U[row + cw]
        out[b.r0:b.r1] = val.reshape(-1, nx)
        if residual:
            c2 = 2.0 * val
            yl = torch.where(y == 0, 1, y - 1)
            yh = torch.where(y == ny - 1, ny - 2, y + 1)
            xl = torch.where(x == 0, 1, x - 1)
            xh = torch.where(x == nx - 1, nx - 2, x + 1)
            lap = ((b.U[(yl - b.lo) * S + cw] - c2) + b.U[(yh - b.lo) * S + cw]) * wy
            lap = lap + ((b.U[row + _col_word(xl, hx)] - c2) + b.U[row + _col_word(xh, hx)]) * wx
            r = b.F[(y - b.r0) * S + cw] - lap
            face = (((dmask & 1) > 0) & (y == 0)) | (((dmask & 2) > 0) & (y == ny - 1)) \
                | (((dmask & 4) > 0) & (x == 0)) | (((dmask & 8) > 0) & (x == nx - 1))
            res[b.r0:b.r1] = torch.where(face, 0.0, r).reshape(-1, nx)
    return (out, res) if residual else out


def _dmask(bcs):
    from ndsm_tpu_torch.ops.zc import dirichlet_mask

    return dirichlet_mask(bcs)


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
                 for _ in range(3))


EMU_SHAPES = [(13, 11), (24, 24), (7, 30), (3, 3), (40, 52), (37, 45)]


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("bcs", [ALL_N, MIXED], ids=["all_neumann", "mixed_bc"])
@pytest.mark.parametrize("cluster", [1, 2, 3, 5])
@pytest.mark.parametrize("shape", EMU_SHAPES)
def test_emulated_lane_kernel_is_the_plain_smoother(shape, cluster, bcs, lanes):
    full = shape if lanes == 1 else (lanes,) + shape
    u, rhs, cor = _data(full, sum(shape) + cluster)
    for ns in (1, 2, 5):
        assert torch.equal(emulate(u, None, rhs, DQ, bcs, ns, cluster=cluster),
                           v2d.v2d_smooth_plain(u, rhs, DQ, bcs, ns))
        got = emulate(u, None, rhs, DQ, bcs, ns, residual=True, cluster=cluster)
        want = v2d.v2d_smooth_residual_plain(u, rhs, DQ, bcs, ns)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(emulate(u, cor, rhs, DQ, bcs, ns, cluster=cluster),
                           v2d.v2d_smooth_cor_plain(u, cor, rhs, DQ, bcs, ns))


def test_emulated_lane_kernel_needs_the_halo_exchange():
    """Without the copy of the neighbours' edge rows after each half-sweep
    the cluster's result differs: the halo rows carry real data."""
    u, rhs, _ = _data((24, 24), 3)
    want = v2d.v2d_smooth_plain(u, rhs, DQ, MIXED, 2)
    global _copy_halos
    keep = _copy_halos
    try:
        _copy_halos = lambda blocks, ny, color: keep(blocks, ny, color, halo_rows=0)  # noqa: E731
        assert not torch.equal(emulate(u, None, rhs, DQ, MIXED, 2, cluster=3), want)
    finally:
        _copy_halos = keep
    assert torch.equal(emulate(u, None, rhs, DQ, MIXED, 2, cluster=3), want)


# ----------------------------------------------------------------------
# (c) the chain alone
# ----------------------------------------------------------------------


@pytest.mark.parametrize("shape,cluster", [((97, 45), 3), ((61, 52), 2), ((51, 61), 5),
                                           ((13, 330), 4), ((63, 49), 16)])
def test_chain_is_the_strided_block_sum(shape, cluster):
    """Slot partials walked band by band and chained in rank order, then
    the tree: bitwise the fixed-order sum of ops/reduce.py, with n not a
    multiple of 1024 and band edges that cut a row of slots; chained out of
    rank order they are not (every slot has at least three terms, so the
    order of its adds matters)."""
    ny, nx = shape
    assert (ny * nx) % SLOTS and ny * nx >= 3 * SLOTS and any((v2d.band(k, cluster, ny)[0] * nx) % SLOTS
                                     for k in range(1, cluster))
    rng = np.random.default_rng(ny * nx)
    u = torch.as_tensor(rng.standard_normal(shape).astype(np.float32)) * 1e3
    blocks = [_Block(k, cluster, ny, nx) for k in range(cluster)]
    for b in blocks:
        _load(b, u, None, u, nx)
    want = reduce.strided_block_sum(u.reshape(1, -1))[0, 0]
    assert torch.equal(_chain(blocks, nx), want)
    assert not torch.equal(_chain(blocks, nx, order=list(range(cluster))[::-1]), want)


def test_slot_walk_visits_every_term_once():
    """Across the blocks, slots t and t + 512 of the 512 threads visit every
    point of the lane exactly once, each at the word the kernel loads."""
    for (ny, nx), c in itertools.product(((37, 45), (40, 52), (3, 3), (7, 30)), (1, 2, 3)):
        c = min(c, ny)
        seen = torch.zeros(ny * nx, dtype=torch.long)
        for k in range(c):
            b = _Block(k, c, ny, nx)
            for base in (0, THREADS):
                s = _slot_walk(torch.arange(THREADS) + base, b, nx)
                for m in range(int(s[0].max()) if s[0].numel() else 0):
                    live = m < s[0]
                    f = s[1][live] * nx + s[2][live]
                    assert torch.equal(s[3][live], (s[1][live] - b.lo) * b.S
                                       + _col_word(s[2][live], b.hx))
                    assert ((f >= b.r0 * nx) & (f < b.r1 * nx)).all()
                    seen.index_add_(0, f, torch.ones_like(f))
                    s = _slot_step(s, b, nx)
        assert (seen == 1).all(), ((ny, nx), c)
