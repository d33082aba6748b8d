"""Red-black smoother kernels for float32 3D levels (port of
``ndsm_tpu/ops/pallas_zc.py``: ``zc_smooth_3d``, ``zc_smooth_residual_3d``,
``zc_smooth_cor_3d`` and ``zc_smooth_mean_3d``).

Each wrapper takes the level's tensors and its static configuration (dq,
bcs, number of sweeps):

  * on a CUDA tensor it launches the hand-written kernels and adds one to
    its ``launches`` count, or raises.  The red-black half-sweeps and the
    residual are one-lane calls of the lane kernels of
    ``csrc/fused_smooth.cu`` (launched by :func:`sweeps_cuda` and
    :func:`residual_cuda`, which ops/fused.py calls with B lanes); the
    mean's reduction passes are ``csrc/zc_smooth.cu``.  Built at first use;
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
csrc/zc_smooth.cu): one launch per half-sweep, 2*nsweeps launches per
call.  The first half-sweep runs out of place (into a new tensor, adding
``cor`` on load for the correction form), the rest in place on that
tensor; the residual form adds one residual launch.  The mean form runs
each sweep out of place, ping-ponging between two buffers: its first
half-sweep subtracts the previous sweep's mean on load (read from a device
scalar, never from the host), and two launches per sweep reduce the swept
state into the next mean.  Unlike the TPU kernels there is no shape gate,
no pass width and no padded storage: every 3D shape with extents >= 2 is
taken.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

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
    "sweeps_cuda",
    "residual_cuda",
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


def sweeps_cuda(u, cor, rhs, dq, bcs_list, nsweeps: int, active, what: str) -> torch.Tensor:
    """2*nsweeps half-sweep launches over a (B, nz, ny, nx) stack, lane b
    with ``bcs_list[b]``: the first out of place into a new stack (reading
    u + cor when cor is given), the rest in place on it, each over the
    lanes ``active`` marks only."""
    from ..utils import cuda_build

    lib = cuda_build.kernels()
    nb, nz, ny, nx = (int(s) for s in u.shape)
    (wz, wy, wx), w0 = stencils.stencil_weights(dq, torch.float32)
    color, dmask, act = _lane_args(bcs_list, active)
    out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = lib.ndsm_lane_half_oop_f32(
            u.data_ptr(), None if cor is None else cor.data_ptr(), None, rhs.data_ptr(),
            out.data_ptr(), nb, nz, ny, nx, color, dmask, act, wz, wy, wx, w0, stream,
        )
        cuda_build.check(rc, what)
        for k in range(1, 2 * int(nsweeps)):
            rc = lib.ndsm_lane_half_inplace_f32(
                out.data_ptr(), rhs.data_ptr(), nb, nz, ny, nx, color, dmask, act,
                k % 2, wz, wy, wx, w0, stream,
            )
            cuda_build.check(rc, what)
    return out


def residual_cuda(u, rhs, dq, bcs_list, active, what: str) -> torch.Tensor:
    """One residual launch over a (B, nz, ny, nx) stack; zero on each
    lane's Dirichlet faces and on the lanes ``active`` does not mark."""
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


def _mean_sweeps_cuda(u, rhs, dq, bcs, nsweeps: int) -> torch.Tensor:
    """4*nsweeps + 1 launches: per sweep an out-of-place half-sweep that
    subtracts the previous mean on load, an in-place half-sweep (both
    one-lane calls of the lane kernels) and the two reduction passes into
    the device scalar ``m``; at the end the last mean is subtracted in
    place."""
    from ..utils import cuda_build

    lib = cuda_build.kernels()
    nz, ny, nx = (int(s) for s in u.shape)
    n = u.numel()
    nblocks = mean_blocks(n)
    (wz, wy, wx), w0 = stencils.stencil_weights(dq, torch.float32)
    color, dmask, act = _lane_args((bcs,), (True,))
    bufs = [torch.empty_like(u) for _ in range(min(2, int(nsweeps)))]
    parts = torch.empty(nblocks, dtype=torch.float32, device=u.device)
    m = torch.empty(1, dtype=torch.float32, device=u.device)
    nf = float(np.float32(n))
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
    name = "zc_smooth_residual_3d"
    out = sweeps_cuda(u[None], None, rhs[None], dq, (bcs,), nsweeps, (True,), name)
    r = residual_cuda(out, rhs[None], dq, (bcs,), (True,), name)
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
