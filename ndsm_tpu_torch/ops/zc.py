"""Red-black smoother kernels for float32 3D levels (port of
``ndsm_tpu/ops/pallas_zc.py``: ``zc_smooth_3d``, ``zc_smooth_residual_3d``,
``zc_smooth_cor_3d`` and ``zc_smooth_mean_3d``).

Each wrapper takes the level's tensors and its static configuration (dq,
bcs, number of sweeps):

  * on a CUDA tensor it launches the hand-written kernels and adds one to
    its ``launches`` count, or raises.  The sweeps, with the residual
    fused into the last pass, are one-lane calls of the multi-sweep pass
    kernel of ``csrc/fused_smooth.cu`` (launched by :func:`sweeps_cuda`,
    which ops/fused.py calls with B lanes); the mean form launches
    ``csrc/zc_smooth.cu``'s all-Neumann kernel once.  Built at first use;
  * on a CPU tensor it runs its plain PyTorch version below, built from
    ops/stencils.py.

The plain versions are the oracles the kernels are held to on the card
(bitwise: same expression order, no FMA contraction) and what the CPU tests
compare with the JAX kernels.  Nothing on the main path calls a plain
version for a CUDA tensor; ``plain_cuda_calls`` counts any that does.

Semantics (the JAX kernels'): ``nsweeps`` calls of ``rb_sweep``.  The
first three take a problem that is not all-Neumann; ``zc_smooth_mean_3d``
takes the all-Neumann one, where every sweep is followed by the
subtraction of the global mean ``m = f32(sum(u) / f32(N))`` (a division,
as in the JAX engine's ``_t_smooth_zc_mean``), the sum taken in the
kernels' fixed order (``reduce.strided_block_sum``).  The wrappers are
functional: inputs are never modified.

Kernel design (see the source notes in csrc/fused_smooth.cu and
csrc/zc_smooth.cu): the first three wrappers run ``ceil(nsweeps / w)``
launches of the multi-sweep pass, each running w sweeps over a
shared-memory ring of planes, out of place (ping-ponging between the
result and one scratch stack; the first pass adds ``cor`` on load, the
last writes the residual of its final state).  :func:`pass_plan` fixes w
and the tile from the shape alone, by a rule set from measurements on the
H100 (PERF.md §6).  The mean form is one launch of csrc/zc_smooth.cu
a call, on the route :func:`mean_plan` gives the shape: a cooperative grid
of co-resident blocks that runs every sweep, the mean's fixed-order sum
and its fold in one launch, grid-wide barriers between the phases, or one
block that holds a small level in shared memory.  A refused cooperative
launch raises.  Unlike the TPU kernels there is no shape gate and no
padded storage: every 3D shape with extents >= 2 is taken.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import stencils
from .reduce import SUM_THREADS, strided_block_sum

__all__ = [
    "zc_smooth_3d",
    "zc_smooth_residual_3d",
    "zc_smooth_cor_3d",
    "zc_smooth_3d_plain",
    "zc_smooth_residual_3d_plain",
    "zc_smooth_cor_3d_plain",
    "zc_smooth_mean_3d",
    "zc_smooth_mean_3d_plain",
    "dirichlet_mask",
    "mean_blocks",
    "MeanPlan",
    "mean_plan",
    "sweeps_cuda",
    "residual_cuda",
    "PassTile",
    "pass_tile",
    "pass_plan",
    "run_passes",
    "shard_pass_tile",
    "shard_pass_plan",
]

#: Most blocks of the first pass of the mean's reduction.
MEAN_MAX_BLOCKS = 256


def dirichlet_mask(bcs) -> int:
    """6-bit face mask of csrc/stencil.cuh: bit 2*ax lower, 2*ax+1 upper."""
    m = 0
    for ax, (lo, hi) in enumerate(bcs):
        if lo == "D":
            m |= 1 << (2 * ax)
        if hi == "D":
            m |= 1 << (2 * ax + 1)
    return m


def check_level(name: str, tensors, dtype: torch.dtype, shape=None, ndim: int = 3,
                lanes: bool = False) -> None:
    """Raise unless every tensor is a contiguous ``dtype`` tensor of one
    shape (``shape`` if given) on one device: ``ndim`` spatial axes of
    extent >= 2, after one leading lane axis when ``lanes`` allows it."""
    t0 = tensors[0]
    shape = tuple(t0.shape) if shape is None else tuple(shape)
    ranks = (ndim, ndim + 1) if lanes else (ndim,)
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected torch.Tensor, got {type(t).__name__}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape or len(shape) not in ranks or min(shape[-ndim:]) < 2:
            raise ValueError(
                f"{name}: expected one {ndim}D shape{' (with lanes)' if lanes else ''} "
                f"with extents >= 2, got {tuple(t.shape)} (expected {shape})"
            )
        if t.device != t0.device:
            raise ValueError(f"{name}: tensors on {t0.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")
    if t0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t0.device}")


def check_config(name: str, dq, bcs, nsweeps: int, all_neumann: bool = False):
    bcs = stencils.validate_bcs(bcs, 3)
    if stencils.is_all_neumann(bcs) != all_neumann:
        raise ValueError(
            f"{name}: all-Neumann BCs need the per-sweep mean (zc_smooth_mean_3d)"
            if not all_neumann else f"{name}: takes all-Neumann BCs only, got {bcs}"
        )
    if int(nsweeps) < 1:
        raise ValueError(f"{name}: nsweeps must be >= 1, got {nsweeps}")
    if len(dq) != 3:
        raise ValueError(f"{name}: dq must have 3 entries")
    return bcs


def mean_blocks(n: int) -> int:
    """Blocks of the first reduction pass over ``n`` points."""
    return min(MEAN_MAX_BLOCKS, -(-int(n) // SUM_THREADS))


def count_plain(fn, u: torch.Tensor) -> None:
    if u.device.type == "cuda":
        fn.plain_cuda_calls += 1


# ----------------------------------------------------------------------
# Plain PyTorch versions (oracles; CPU path)
# ----------------------------------------------------------------------


def zc_smooth_3d_plain(u, rhs, dq, bcs, nsweeps: int) -> torch.Tensor:
    """``nsweeps`` calls of ``stencils.rb_sweep``."""
    count_plain(zc_smooth_3d_plain, u)
    for _ in range(int(nsweeps)):
        u = stencils.rb_sweep(u, rhs, dq, bcs)
    return u


def zc_smooth_residual_3d_plain(u, rhs, dq, bcs, nsweeps: int):
    """(u', r): ``nsweeps`` sweeps, then ``poisson_residual`` of u'."""
    count_plain(zc_smooth_residual_3d_plain, u)
    for _ in range(int(nsweeps)):
        u = stencils.rb_sweep(u, rhs, dq, bcs)
    return u, stencils.poisson_residual(u, rhs, dq, bcs)


def zc_smooth_cor_3d_plain(u, cor, rhs, dq, bcs, nsweeps: int) -> torch.Tensor:
    """``nsweeps`` sweeps on ``u + cor``."""
    count_plain(zc_smooth_cor_3d_plain, u)
    u = u + cor
    for _ in range(int(nsweeps)):
        u = stencils.rb_sweep(u, rhs, dq, bcs)
    return u


def _global_mean(u: torch.Tensor) -> torch.Tensor:
    """0-d ``f32(sum(u) / f32(N))``: per-block sums, then one block's sum
    of those, then a true division (by a device tensor: PyTorch turns a
    division by a host scalar into a multiply by its reciprocal)."""
    n = u.numel()
    parts = strided_block_sum(u.reshape(-1), mean_blocks(n))
    total = strided_block_sum(parts)[0]
    return total / torch.full((), float(np.float32(n)), dtype=u.dtype, device=u.device)


def zc_smooth_mean_3d_plain(u, rhs, dq, bcs, nsweeps: int) -> torch.Tensor:
    """``nsweeps`` times: the two half-updates, then ``u - mean``."""
    count_plain(zc_smooth_mean_3d_plain, u)
    for _ in range(int(nsweeps)):
        u = stencils.red_black(u, rhs, dq, bcs)
        u = u - _global_mean(u)
    return u


for _f in (zc_smooth_3d_plain, zc_smooth_residual_3d_plain, zc_smooth_cor_3d_plain,
           zc_smooth_mean_3d_plain):
    _f.plain_cuda_calls = 0


# ----------------------------------------------------------------------
# CUDA launches
# ----------------------------------------------------------------------


def _lane_args(bcs_list, active):
    """Each lane's first colour, Dirichlet mask and active flag, as the C
    int arrays the lane kernels take."""
    arr = ctypes.c_int * len(bcs_list)
    return (
        arr(*(stencils.first_color_parity(b) for b in bcs_list)),
        arr(*(dirichlet_mask(b) for b in bcs_list)),
        arr(*(1 if a else 0 for a in active)),
    )


# The pass plan.  Constants of the kernel and the H100 (csrc/fused_smooth.cu:
# kMaxSmem, kAhead, kRows * kPassThreads / 32; 132 SMs) and of the rule, set
# from the widths, tiles and chunks measured on the card (PERF.md §6).
MAX_SMEM = 232448
SMS = 132
#: Planes a block copies ahead of the one its step needs.
PASS_AHEAD = 1
#: The largest window in y and in x (a lane owns two columns of it, a
#: warp four rows).
PASS_WINDOW = 64
#: Sweeps a pass: a smoothing call of ns sweeps is ceil(ns / w) passes.
PASS_WIDTH = 2
#: Shared memory the default tile may take (one block an SM).
PASS_SMEM = 226 * 1024
#: Most points of a lane that the plan gives a resident pass (one block a
#: lane is faster than marching tiles only on the smallest levels).
PASS_RESIDENT = 16 ** 3


def _chunk(nz: int, blocks_per_chunk: int, halo: int, width: int) -> int:
    """Planes of a z chunk: the fewest block-steps on the most loaded SM.
    A block marches cz + 2 * halo planes and 2 * width + 1 steps more;
    ceil(nz / cz) chunks of ``blocks_per_chunk`` blocks run in waves of
    SMS blocks (one block an SM: kernel's launch bounds)."""
    def cost(cz):
        waves = -(-(-(-nz // cz) * blocks_per_chunk) // SMS)
        return waves * (cz + 2 * halo + 2 * width + 1)
    return min(range(min(nz, 4), nz + 1), key=lambda cz: (cost(cz), -cz))


class PassTile(NamedTuple):
    """One launch of the pass: ``width`` sweeps; the residual of the final
    state when ``residual``; ``halo`` = 2 * width (+1 with the residual);
    the output ``tile`` (cz, ty, tx) of a block; the largest ``window``
    (tile + 2 * halo along each axis, clamped to the shape); the planes of
    each ``ring`` (2 * width + 2 + PASS_AHEAD, +1 with the residual); the
    shared memory of a block (the rings of u and rhs; cor goes through
    registers); the ``grid`` (tiles in y times x, z chunks, lanes); whether
    the pass is ``resident``: one tile holds the whole lane and all its
    planes of u and rhs fit in shared memory, so there is no march
    (``ring`` = nz)."""

    width: int
    residual: bool
    halo: int
    tile: Tuple[int, int, int]
    window: Tuple[int, int, int]
    ring: int
    smem_bytes: int
    grid: Tuple[int, int, int]
    resident: bool


def pass_tile(shape, width: int, residual: bool = False, nb: int = 1,
              tile: Optional[Tuple[int, int, int]] = None) -> PassTile:
    """The geometry of one pass of ``width`` sweeps over an (nb,) + shape
    stack: the default tile, or ``tile`` (cz, ty, tx), cut to the shape."""
    nz, ny, nx = (int(n) for n in shape)
    width = int(width)
    halo = 2 * width + (1 if residual else 0)
    ring = 2 * width + 2 + PASS_AHEAD + (1 if residual else 0)
    if tile is None:
        tx = min(nx, PASS_WINDOW - 2 * halo)
        while True:  # the widest rows that leave room for a tile row
            sx = -(-min(nx, tx + 2 * halo) // 2) * 2
            rows = PASS_SMEM // (2 * ring * sx * 4)
            if rows > 2 * halo or tx <= 2:
                break
            tx -= 2
        ty = min(ny, PASS_WINDOW - 2 * halo, max(1, rows - 2 * halo))
        tile = (_chunk(nz, -(-ny // ty) * -(-nx // tx) * int(nb), halo, width), ty, tx)
    cz, ty, tx = (min(int(t), n) for t, n in zip(tile, (nz, ny, nx)))
    window = tuple(min(n, t + 2 * halo) for t, n in zip((cz, ty, tx), (nz, ny, nx)))
    grid = (-(-ny // ty) * -(-nx // tx), -(-nz // cz), int(nb))
    # a shared row holds the even columns, then the odd ones
    plane = window[1] * (-(-window[2] // 2) * 2) * 4
    resident = (cz, ty, tx) == (nz, ny, nx) and 2 * nz * plane <= MAX_SMEM
    if resident:
        ring = nz
    smem = 2 * ring * plane
    return PassTile(width, bool(residual), halo, (cz, ty, tx), window, ring, smem, grid,
                    resident)


def _resident(shape) -> bool:
    """Whether a lane of ``shape`` takes a resident pass: small enough, and
    u and rhs fit shared memory whole within the largest window."""
    nz, ny, nx = shape
    return (nz * ny * nx <= PASS_RESIDENT and ny <= PASS_WINDOW and nx <= PASS_WINDOW
            and 2 * nz * ny * (-(-nx // 2) * 2) * 4 <= MAX_SMEM)


def pass_plan(shape, nsweeps: int, nb: int = 1, residual: bool = False
              ) -> Tuple[PassTile, ...]:
    """The passes of a smoothing call of ``nsweeps`` sweeps: one resident
    pass of all of them when a lane fits shared memory whole (the small
    levels), else widths of ``PASS_WIDTH`` and a last narrower one for the
    remainder; the last pass writes the residual when ``residual``.
    Memoised (it runs on every smoothing call)."""
    return _plan(tuple(int(s) for s in shape), int(nsweeps), int(nb), bool(residual),
                 PASS_WIDTH)


@functools.lru_cache(maxsize=256)
def _plan(shape, ns, nb, residual, width):
    if _resident(shape):
        return (pass_tile(shape, ns, residual, nb, shape),)
    widths = [width] * (ns // width) + ([ns % width] if ns % width else [])
    last = len(widths) - 1
    return tuple(pass_tile(shape, w, residual and i == last, nb) for i, w in enumerate(widths))


def shard_pass_tile(ext_shape, halos, width: int, residual: bool = False,
                    tile: Optional[Tuple[int, int, int]] = None) -> PassTile:
    """The pass of ``width`` sweeps over one shard's halo-extended block
    ``ext_shape`` = (nz + 2Hz, ny + 2Hy, nx), ``halos`` = (Hz, Hy) (Hy = 0
    on a z mesh), in the kernel's shard form (csrc/lane_pass.cuh): the
    tiles cover the real (nz, ny, nx) block, by :func:`pass_tile`'s default
    rule for it or as ``tile``; a window is the tile grown by the halo
    2 * width (+1), clamped to the extended block; never resident."""
    nze, nye, nx = (int(n) for n in ext_shape)
    hz, hy = (int(h) for h in halos)
    real = (nze - 2 * hz, nye - 2 * hy, nx)
    p = pass_tile(real, width, residual, 1, tile)
    window = tuple(min(n, t + 2 * p.halo) for t, n in zip(p.tile, (nze, nye, nx)))
    ring = 2 * p.width + 2 + PASS_AHEAD + (1 if residual else 0)
    smem = 2 * ring * window[1] * (-(-window[2] // 2) * 2) * 4
    return p._replace(window=window, ring=ring, smem_bytes=smem, resident=False)


def shard_pass_plan(ext_shape, halos, nsweeps: int, residual: bool = False) -> PassTile:
    """The one pass of a per-shard smoothing call (ops/zc_sharded.py): all
    ``nsweeps`` sweeps (w = nsweeps), the residual in it when ``residual``.
    Raises when its window cannot fit a block's shared memory (the engine's
    calls take w = 1 or 2).  Memoised."""
    p = _shard_plan(tuple(int(n) for n in ext_shape), tuple(int(h) for h in halos),
                    int(nsweeps), bool(residual))
    if p.smem_bytes > MAX_SMEM or p.window[1] > PASS_WINDOW or p.window[2] > PASS_WINDOW:
        raise ValueError(
            f"per-shard pass of {nsweeps} sweeps over {tuple(ext_shape)}: a window of "
            f"{p.window} needs {p.smem_bytes} B of shared memory (the kernel takes "
            f"<= {MAX_SMEM} B and <= {PASS_WINDOW} x {PASS_WINDOW} points in (y, x))")
    return p


@functools.lru_cache(maxsize=256)
def _shard_plan(ext_shape, halos, ns, residual):
    return shard_pass_tile(ext_shape, halos, ns, residual)


@functools.lru_cache(maxsize=256)
def call_args(dq, bcs):
    """((wz, wy, wx), w0, first colour, Dirichlet mask) of a one-level call
    of dq (a tuple of floats) and bcs, kept per configuration (the wrappers'
    host time is part of every call)."""
    return stencils.stencil_weights(dq, torch.float32) + (stencils.first_color_parity(bcs),
                                                          dirichlet_mask(bcs))


@functools.lru_cache(maxsize=256)
def _pass_args(dq, bcs_list, active):
    """The weights and the lanes' C arrays of a pass launch, kept per
    configuration: they are built on the host, and the smoothing calls of
    a solve repeat a few configurations many times."""
    return stencils.stencil_weights(dq, torch.float32) + _lane_args(bcs_list, active)


def run_passes(u, cor, rhs, dq, bcs_list, active, what: str, plan):
    """Launch the passes of ``plan`` over a (B, nz, ny, nx) stack, lane b
    with ``bcs_list[b]``, out of place: the first reads u + cor when cor
    is given, each later one the previous pass's output, ping-ponging so
    that the last writes the returned stack.  Returns (u', r), r None
    unless the last pass writes the residual.  ``sweeps_cuda.passes``
    counts the launches."""
    from ..utils import cuda_build

    lib = cuda_build.kernels()
    nb, nz, ny, nx = (int(s) for s in u.shape)
    (wz, wy, wx), w0, color, dmask, act = _pass_args(
        tuple(float(q) for q in dq), tuple(bcs_list), tuple(bool(a) for a in active))
    out = torch.empty_like(u)
    tmp = torch.empty_like(u) if len(plan) > 1 else None
    r = torch.empty_like(u) if plan[-1].residual else None
    src = u
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        for i, p in enumerate(plan):
            dst = out if (len(plan) - 1 - i) % 2 == 0 else tmp
            rc = lib.ndsm_lane_pass_f32(
                src.data_ptr(), cor.data_ptr() if i == 0 and cor is not None else None,
                rhs.data_ptr(), dst.data_ptr(), r.data_ptr() if p.residual else None,
                nb, nz, ny, nx, color, dmask, act, p.width, *p.tile, wz, wy, wx, w0, stream,
            )
            cuda_build.check(rc, what)
            sweeps_cuda.passes += 1
            src = dst
    return out, r


def sweeps_cuda(u, cor, rhs, dq, bcs_list, nsweeps: int, active, what: str,
                residual: bool = False):
    """``nsweeps`` sweeps of a (B, nz, ny, nx) stack, lane b with
    ``bcs_list[b]``, reading u + cor when cor is given: the passes of
    :func:`pass_plan`.  Returns u', or (u', r) with ``residual``."""
    plan = pass_plan(u.shape[1:], nsweeps, int(u.shape[0]), residual)
    out, r = run_passes(u, cor, rhs, dq, bcs_list, active, what, plan)
    return (out, r) if residual else out


sweeps_cuda.passes = 0


def residual_cuda(u, rhs, dq, bcs_list, active, what: str) -> torch.Tensor:
    """One residual launch over a (B, nz, ny, nx) stack; zero on each
    lane's Dirichlet faces and on the lanes ``active`` does not mark (the
    colour-split route's residual, ops/compact.py)."""
    from ..utils import cuda_build

    lib = cuda_build.kernels()
    nb, nz, ny, nx = (int(s) for s in u.shape)
    (wz, wy, wx), _ = stencils.stencil_weights(dq, torch.float32)
    _, dmask, act = _lane_args(bcs_list, active)
    r = torch.empty_like(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = lib.ndsm_lane_residual_f32(
            u.data_ptr(), rhs.data_ptr(), r.data_ptr(), nb, nz, ny, nx, dmask, act,
            wz, wy, wx, stream,
        )
        cuda_build.check(rc, what)
    return r


# The all-Neumann smoother's plan (csrc/zc_smooth.cu: kBlockExtra).
#: Shared words of the block route after u and rhs (partials and m).
MEAN_BLOCK_EXTRA = 64


class MeanPlan(NamedTuple):
    """How a ``zc_smooth_mean_3d`` call runs: the ``route`` ("block": one
    block holds u and rhs in shared memory; "grid": a cooperative grid of
    co-resident blocks with grid-wide barriers, the device's resident
    blocks, at most ``vblocks``), the ``vblocks`` of the sum's fixed order
    (``mean_blocks(N)``, each of ``SUM_THREADS`` virtual threads) and the
    ``smem_bytes`` the block route takes (0 on the grid route: its blocks
    use static shared memory)."""

    route: str
    vblocks: int
    smem_bytes: int


def mean_plan(shape) -> MeanPlan:
    """The route of a level: "block" where u, rhs and the block's extra
    words fit one block's shared memory (then at most 32 virtual blocks,
    one a warp), else "grid"."""
    n = int(np.prod([int(s) for s in shape]))
    vb = mean_blocks(n)
    smem = (2 * n + MEAN_BLOCK_EXTRA) * 4
    if smem <= MAX_SMEM:
        return MeanPlan("block", vb, smem)
    return MeanPlan("grid", vb, 0)


#: Each stream's two words of the grid route's barrier (0 when the first
#: launch on the stream starts; a launch leaves them 0 again).  Kept, not
#: allocated a call: zeroing new words would be a second launch a call.
_BARRIERS: dict = {}


def _barrier(device, stream: int) -> torch.Tensor:
    key = (str(device), stream)
    bar = _BARRIERS.get(key)
    if bar is None:
        bar = _BARRIERS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return bar


def _mean_sweeps_cuda(u, rhs, dq, bcs, nsweeps: int, plan: Optional[MeanPlan] = None,
                      previous: bool = False) -> torch.Tensor:
    """One launch of csrc/zc_smooth.cu's all-Neumann kernel on the route of
    ``plan`` (default :func:`mean_plan`'s; chip_smoke.py also runs the grid
    route where the plan takes the block route).  ``previous``: the first
    design instead (chip_smoke.py times it beside the kernel), 4 * nsweeps
    + 1 launches: per sweep an out-of-place half-sweep that subtracts the
    previous mean on load, an in-place half-sweep (one-lane calls of
    fused_smooth.cu's half-sweep kernels) and the two reduction passes into
    the device scalar ``m``; at the end the last mean subtracted in place."""
    from ..utils import cuda_build

    lib = cuda_build.kernels()
    nz, ny, nx = (int(s) for s in u.shape)
    n = u.numel()
    nblocks = mean_blocks(n)
    (wz, wy, wx), w0, first, _ = call_args(tuple(float(q) for q in dq), bcs)
    nf = float(np.float32(n))
    if not previous:
        plan = mean_plan(u.shape) if plan is None else plan
        out = torch.empty_like(u)
        with torch.cuda.device(u.device):
            stream = torch.cuda.current_stream(u.device).cuda_stream
            grid = plan.route == "grid"
            parts = torch.empty(nblocks, dtype=torch.float32, device=u.device) if grid else None
            bar = _barrier(u.device, stream) if grid else None
            cuda_build.check(lib.ndsm_mean_smooth_f32(
                u.data_ptr(), rhs.data_ptr(), out.data_ptr(),
                parts.data_ptr() if grid else None, bar.data_ptr() if grid else None,
                nz, ny, nx, nblocks, int(nsweeps), first,
                0 if grid else 1, wz, wy, wx, w0, nf, stream), "zc_smooth_mean_3d")
        return out
    color, dmask, act = _lane_args((bcs,), (True,))
    bufs = [torch.empty_like(u) for _ in range(min(2, int(nsweeps)))]
    parts = torch.empty(nblocks, dtype=torch.float32, device=u.device)
    m = torch.empty(1, dtype=torch.float32, device=u.device)
    src, sub = u, None
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        for k in range(int(nsweeps)):
            dst = bufs[k % 2]
            rcs = (
                lib.ndsm_lane_half_oop_f32(
                    src.data_ptr(), None, sub, rhs.data_ptr(), dst.data_ptr(),
                    1, nz, ny, nx, color, dmask, act, wz, wy, wx, w0, stream),
                lib.ndsm_lane_half_inplace_f32(
                    dst.data_ptr(), rhs.data_ptr(), 1, nz, ny, nx, color, dmask, act, 1,
                    wz, wy, wx, w0, stream),
                lib.ndsm_sum_partials_f32(dst.data_ptr(), n, parts.data_ptr(), nblocks, stream),
                lib.ndsm_sum_final_f32(parts.data_ptr(), nblocks, nf, m.data_ptr(), stream),
            )
            for rc in rcs:
                cuda_build.check(rc, "zc_smooth_mean_3d")
            src, sub = dst, m.data_ptr()
        cuda_build.check(lib.ndsm_sub_scalar_f32(src.data_ptr(), m.data_ptr(), n, stream),
                         "zc_smooth_mean_3d")
    return src


# ----------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------


def zc_smooth_3d(u, rhs, dq, bcs, nsweeps: int) -> torch.Tensor:
    """``nsweeps`` red-black sweeps of ``laplace(u) = rhs`` (float32, 3D).
    Replaces ndsm_tpu/ops/pallas_zc.py:zc_smooth_3d."""
    check_level("zc_smooth_3d", (u, rhs), torch.float32)
    bcs = check_config("zc_smooth_3d", dq, bcs, nsweeps)
    if u.device.type == "cpu":
        return zc_smooth_3d_plain(u, rhs, dq, bcs, nsweeps)
    out = sweeps_cuda(u[None], None, rhs[None], dq, (bcs,), nsweeps, (True,),
                      "zc_smooth_3d")[0]
    zc_smooth_3d.launches += 1
    return out


def zc_smooth_residual_3d(u, rhs, dq, bcs, nsweeps: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u', r): ``nsweeps`` sweeps, then the residual of the swept state.
    Replaces ndsm_tpu/ops/pallas_zc.py:zc_smooth_residual_3d."""
    check_level("zc_smooth_residual_3d", (u, rhs), torch.float32)
    bcs = check_config("zc_smooth_residual_3d", dq, bcs, nsweeps)
    if u.device.type == "cpu":
        return zc_smooth_residual_3d_plain(u, rhs, dq, bcs, nsweeps)
    out, r = sweeps_cuda(u[None], None, rhs[None], dq, (bcs,), nsweeps, (True,),
                         "zc_smooth_residual_3d", residual=True)
    zc_smooth_residual_3d.launches += 1
    return out[0], r[0]


def zc_smooth_cor_3d(u, cor, rhs, dq, bcs, nsweeps: int) -> torch.Tensor:
    """``nsweeps`` sweeps on ``u + cor`` (the V-cycle ascent's
    correct-then-relax).  Replaces ndsm_tpu/ops/pallas_zc.py:zc_smooth_cor_3d."""
    check_level("zc_smooth_cor_3d", (u, cor, rhs), torch.float32)
    bcs = check_config("zc_smooth_cor_3d", dq, bcs, nsweeps)
    if u.device.type == "cpu":
        return zc_smooth_cor_3d_plain(u, cor, rhs, dq, bcs, nsweeps)
    out = sweeps_cuda(u[None], cor[None], rhs[None], dq, (bcs,), nsweeps, (True,),
                      "zc_smooth_cor_3d")[0]
    zc_smooth_cor_3d.launches += 1
    return out


def zc_smooth_mean_3d(u, rhs, dq, bcs, nsweeps: int) -> torch.Tensor:
    """``nsweeps`` sweeps of an all-Neumann level, each followed by the
    subtraction of the global mean (float32, 3D).  Replaces
    ndsm_tpu/ops/pallas_zc.py:zc_smooth_mean_3d together with the JAX
    engine's composition of its passes (mg/engine.py:_t_smooth_zc_mean)."""
    check_level("zc_smooth_mean_3d", (u, rhs), torch.float32)
    bcs = check_config("zc_smooth_mean_3d", dq, bcs, nsweeps, all_neumann=True)
    if u.device.type == "cpu":
        return zc_smooth_mean_3d_plain(u, rhs, dq, bcs, nsweeps)
    out = _mean_sweeps_cuda(u, rhs, dq, bcs, nsweeps)
    zc_smooth_mean_3d.launches += 1
    return out


for _f in (zc_smooth_3d, zc_smooth_residual_3d, zc_smooth_cor_3d, zc_smooth_mean_3d):
    _f.launches = 0
del _f
