"""The one-launch all-Neumann 3D smoother of csrc/zc_smooth.cu (the kernel
behind ops/zc.py:zc_smooth_mean_3d), on the CPU.

The kernel runs only on the card (chip_smoke.py holds it bitwise against
the plain version there).  What can be checked here:

  (a) ``zc.mean_plan``: the block route exactly where u, rhs and the
      block's extra words fit one block's shared memory, never more than
      32 virtual blocks there (one a warp), the grid route beyond; the
      virtual blocks are ``mean_blocks(N)``;
  (b) ``warp_tree_sum``'s order (csrc/reduce.cuh: a register tree over
      v[j] = slot lane + 32 j, then shuffles) is ``block_tree_sum``'s;
  (c) an emulation in torch of both routes as the kernel runs them: on the
      grid route the resident blocks (fewer than, as many as, or more than
      the virtual blocks) each standing for the virtual blocks b, b + grid,
      ... in every phase, taken in a shuffled order; per sweep the red
      half-sweep in place (black neighbours minus the previous mean), the
      barrier, the black half-sweep in place with each virtual thread's
      sum of the final values of its indices in their order, each virtual
      block's fold into its partial, the barrier, the fold of the partials
      in every block (all blocks must get the same mean), and the final
      subtraction; on the block route the same sweeps over the whole level
      and the sums one warp a virtual block.  Both must equal
      ``zc_smooth_mean_3d_plain`` **bitwise** (which
      tests/test_torch_zc_mean.py holds against the JAX passes) at N <
      1024, N not a multiple of 1024, and N > 256 * 1024 (a virtual thread
      then adds two indices), ns 1, 2 and 5.
"""

import numpy as np
import pytest
import torch

from ndsm_tpu_torch.ops import stencils, zc
from ndsm_tpu_torch.ops.reduce import SUM_THREADS, strided_block_sum

torch.set_num_threads(1)

ALL_N = (("N", "N"),) * 3
DQ = (0.9, 1.1, 0.8)


def warp_tree(vals: torch.Tensor) -> torch.Tensor:
    """reduce.cuh:warp_tree_sum of 1024 slots (slot lane + 32 j is v[j])."""
    v = vals.reshape(32, 32)  # [j, lane]
    for h in (16, 8, 4, 2, 1):
        v = v[:h] + v[h:2 * h]
    s = v[0]
    for d in (16, 8, 4, 2, 1):
        s = s[:d] + s[d:2 * d]
    return s[0]


def fold(parts: torch.Tensor, nf: float, reversed_strides: bool = False) -> torch.Tensor:
    """The fold of the partials (sum_final's order) and the division;
    ``reversed_strides`` folds with strides 1, 2, .., 512 instead (a
    mutation)."""
    v = torch.zeros(SUM_THREADS, dtype=torch.float32)
    v[:parts.numel()] = 0.0 + parts
    if reversed_strides:
        while v.numel() > 1:
            v = v[0::2] + v[1::2]
        return v[0] / torch.tensor(nf, dtype=torch.float32)
    return warp_tree(v) / torch.tensor(nf, dtype=torch.float32)


class _Level:
    """Flat indices, colours and reflected neighbours of an (nz, ny, nx)
    level, and the update of a set of points."""

    def __init__(self, shape, rhs):
        nz, ny, nx = shape
        self.n = nz * ny * nx
        z, y, x = (t.reshape(-1) for t in torch.meshgrid(
            torch.arange(nz), torch.arange(ny), torch.arange(nx), indexing="ij"))
        p = torch.arange(self.n)
        sz = ny * nx
        self.red = (z + y + x) % 2 == stencils.first_color_parity(ALL_N)
        self.nbrs = (torch.where(z == 0, p + sz, p - sz), torch.where(z == nz - 1, p - sz, p + sz),
                     torch.where(y == 0, p + nx, p - nx), torch.where(y == ny - 1, p - nx, p + nx),
                     torch.where(x == 0, p + 1, p - 1), torch.where(x == nx - 1, p - 1, p + 1))
        (self.wz, self.wy, self.wx), self.w0 = stencils.stencil_weights(DQ, torch.float32)
        self.rhs = rhs.reshape(-1)

    def update(self, pts, v):
        zl, zh, yl, yh, xl, xh = (a[pts] for a in self.nbrs)
        t = (v(zl) + v(zh)) * self.wz
        t = t + (v(yl) + v(yh)) * self.wy
        t = t + (v(xl) + v(xh)) * self.wx
        return (t - self.rhs[pts]) * self.w0


def emulate_grid(u, rhs, ns, resident, seed=0, sum_before_black=False, fold_reversed=False):
    """The grid route with ``resident`` blocks (the grid is min(resident,
    vblocks)); the keyword mutations break the design on purpose."""
    lv = _Level(tuple(u.shape), rhs)
    n, nvb = lv.n, zc.mean_blocks(lv.n)
    G = nvb * SUM_THREADS
    grid = min(resident, nvb)
    nf = float(np.float32(n))
    rng = np.random.default_rng(seed)
    src0 = u.reshape(-1)
    out = torch.full((n,), float("nan"))
    # virtual block vb: its threads' indices, row j = the j-th of each thread
    rows = -(-n // G)
    idx = {vb: vb * SUM_THREADS + torch.arange(SUM_THREADS)[None, :]
           + G * torch.arange(rows)[:, None] for vb in range(nvb)}
    mine = {b: list(range(b, nvb, grid)) for b in range(grid)}
    m = torch.zeros((), dtype=torch.float32)
    for k in range(ns):
        for b in rng.permutation(grid):  # R: any order of blocks
            for vb in mine[b]:
                p = idx[vb][idx[vb] < n]
                p = p[lv.red[p]]
                out[p] = lv.update(p, (lambda q: out[q] - m) if k else (lambda q: src0[q]))
        partials = torch.full((nvb,), float("nan"))
        for b in rng.permutation(grid):  # barrier, then B+S
            for vb in mine[b]:
                q = idx[vb]
                valid = q < n
                qc = torch.where(valid, q, 0)
                black = valid & ~lv.red[qc]
                before = out[qc].clone()
                out[q[black]] = lv.update(q[black], lambda r: out[r])
                vals = before if sum_before_black else out[qc]
                acc = torch.zeros(SUM_THREADS, dtype=torch.float32)
                for j in range(rows):  # each virtual thread, its indices in order
                    acc = torch.where(valid[j], acc + vals[j], acc)
                partials[vb] = warp_tree(acc)
        # barrier, then every block folds the partials itself
        ms = [fold(partials, nf, fold_reversed) for _ in range(grid)]
        assert all(torch.equal(x, ms[0]) for x in ms)
        m = ms[0]
    final = out.clone()
    for b in range(grid):
        for vb in mine[b]:
            p = idx[vb][idx[vb] < n]
            final[p] = out[p] - m
    return final.reshape(u.shape)


def emulate_block(u, rhs, ns):
    """The block route: the level in one block, the halves over all points
    of a colour, the sums one warp a virtual block (one index a virtual
    thread: G >= N)."""
    lv = _Level(tuple(u.shape), rhs)
    n, nvb = lv.n, zc.mean_blocks(lv.n)
    assert nvb <= 32 and nvb * SUM_THREADS >= n
    nf = float(np.float32(n))
    U = u.reshape(-1).clone()
    red = torch.nonzero(lv.red)[:, 0]
    black = torch.nonzero(~lv.red)[:, 0]
    m = torch.zeros((), dtype=torch.float32)
    for k in range(ns):
        U[red] = lv.update(red, (lambda q: U[q] - m) if k else (lambda q: U[q]))
        U[black] = lv.update(black, lambda q: U[q])
        padded = torch.zeros(nvb * SUM_THREADS, dtype=torch.float32)
        padded[:n] = 0.0 + U
        partials = torch.stack([warp_tree(padded[vb * SUM_THREADS:(vb + 1) * SUM_THREADS])
                                for vb in range(nvb)])
        m = fold(partials, nf)
    return (U - m).reshape(u.shape)


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
                 for _ in range(2))


# ----------------------------------------------------------------------
# (a) the plan, (b) the warp's fold
# ----------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 2, 2), (7, 9, 11), (13, 17, 19), (30, 31, 31),
                                   (31, 31, 31), (33, 33, 33), (66, 66, 61), (128, 128, 128),
                                   (256, 256, 256), (220, 220, 220)])
def test_mean_plan_invariants(shape):
    p = zc.mean_plan(shape)
    n = int(np.prod(shape))
    assert p.vblocks == zc.mean_blocks(n) == min(zc.MEAN_MAX_BLOCKS, -(-n // SUM_THREADS))
    fits = (2 * n + zc.MEAN_BLOCK_EXTRA) * 4 <= zc.MAX_SMEM
    assert p.route == ("block" if fits else "grid")
    if fits:
        assert p.smem_bytes == (2 * n + zc.MEAN_BLOCK_EXTRA) * 4 <= zc.MAX_SMEM
        assert p.vblocks <= 32 and p.vblocks * SUM_THREADS >= n
    else:
        assert p.smem_bytes == 0


def test_warp_tree_is_the_block_tree():
    rng = np.random.default_rng(3)
    for _ in range(4):
        x = torch.as_tensor(rng.standard_normal(SUM_THREADS).astype(np.float32))
        assert torch.equal(warp_tree(x), strided_block_sum(x)[0])


# ----------------------------------------------------------------------
# (c) the emulations against the plain version
# ----------------------------------------------------------------------


# (shape, resident blocks of the grid route): N < 1024, N not a multiple of
# 1024 (fewer and more resident blocks than virtual ones), block route at
# its largest, N > 256 * 1024 (two indices a virtual thread) at the H100's
# 132 resident blocks
GRID_CASES = [((7, 9, 11), 132), ((13, 17, 19), 3), ((13, 17, 19), 132), ((30, 31, 31), 7),
              ((66, 66, 61), 132)]


@pytest.mark.parametrize("shape,resident", GRID_CASES)
def test_emulated_grid_route_is_the_plain_version(shape, resident):
    u, rhs = _data(shape, sum(shape))
    for ns in (1, 2, 5):
        want = zc.zc_smooth_mean_3d_plain(u, rhs, DQ, ALL_N, ns)
        got = emulate_grid(u, rhs, ns, resident, seed=ns)
        assert torch.equal(got, want), f"ns={ns}"


@pytest.mark.parametrize("shape", [(7, 9, 11), (13, 17, 19), (30, 31, 31), (2, 3, 5)])
def test_emulated_block_route_is_the_plain_version(shape):
    assert zc.mean_plan(shape).route == "block"
    u, rhs = _data(shape, 7)
    for ns in (1, 2, 5):
        want = zc.zc_smooth_mean_3d_plain(u, rhs, DQ, ALL_N, ns)
        assert torch.equal(emulate_block(u, rhs, ns), want), f"ns={ns}"
