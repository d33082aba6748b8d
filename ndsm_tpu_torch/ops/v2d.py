"""Multi-sweep red-black smoother for float32 2D levels (port of
``ndsm_tpu/ops/pallas_v2d.py``: ``v2d_smooth``, ``v2d_smooth_residual``,
``v2d_smooth_cor`` and their lane-batched form).

These smooth the chi faces of the vector-potential pipeline: six
all-Neumann 2D solves, lane-batched in ``PoissonBVP.solve_batch``.  Each
wrapper takes a ``(ny, nx)`` level or a lane stack ``(B, ny, nx)`` and its
static configuration (dq, bcs, number of sweeps):

  * on a CUDA tensor it launches one kernel of ``csrc/v2d_smooth.cu``
    (built at first use) on the route :func:`v2d_plan` gives the shape,
    and adds one to its ``launches`` count, or raises.  The routes:
    "block", one block a lane holds the lane in shared memory for the
    whole call; "cluster", a thread-block cluster of C blocks a lane, each
    holding a band of rows and one halo row a side, exchanged through the
    cluster's distributed shared memory; "global", for lanes that not even
    16 blocks hold, one block a lane sweeps in global memory (the first
    design).  ``ROUTE_LAUNCHES`` counts the launches of each route;
  * on a CPU tensor it runs its plain PyTorch version below.

Semantics (the JAX kernel's ``_sweep_body``): ``nsweeps`` times the red
then black half-update of ``stencils.red_black``; after each sweep of an
all-Neumann level, ``u - sum(u) * inv_n`` with ``inv_n = f32(1/(ny*nx))``
(a multiply by the rounded reciprocal, not ``torch.mean``).  The sum is
taken per lane in the kernel's fixed order (``reduce.strided_block_sum``),
so the kernel equals its plain version bit for bit.  The correction form
adds ``cor`` on load; the residual form returns ``poisson_residual`` of the
swept state.  Dirichlet faces are frozen.  The wrappers are functional:
inputs are never modified; each lane's result does not depend on B.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import stencils
from .reduce import SUM_THREADS, strided_block_sum
from .zc import MAX_SMEM, check_level, count_plain, dirichlet_mask

__all__ = [
    "V2dPlan",
    "v2d_plan",
    "lane_smem",
    "band",
    "ROUTE_LAUNCHES",
    "v2d_smooth",
    "v2d_smooth_residual",
    "v2d_smooth_cor",
    "v2d_smooth_plain",
    "v2d_smooth_residual_plain",
    "v2d_smooth_cor_plain",
]


def _check(name: str, tensors, dq, bcs, nsweeps: int):
    """Raise unless the tensors are contiguous float32 ``(ny, nx)`` or
    ``(B, ny, nx)`` levels of one shape on one device; returns the
    validated bcs."""
    check_level(name, tensors, torch.float32, ndim=2, lanes=True)
    if int(nsweeps) < 1:
        raise ValueError(f"{name}: nsweeps must be >= 1, got {nsweeps}")
    if len(dq) != 2:
        raise ValueError(f"{name}: dq must have 2 entries")
    return stencils.validate_bcs(bcs, 2)


def _inv_n(shape) -> float:
    return float(np.float32(1.0 / (int(shape[-2]) * int(shape[-1]))))


# ----------------------------------------------------------------------
# Plain PyTorch versions (oracles; CPU path)
# ----------------------------------------------------------------------


def _sweeps_plain(u, rhs, dq, bcs, nsweeps: int) -> torch.Tensor:
    all_neumann = stencils.is_all_neumann(bcs)
    inv_n = _inv_n(u.shape)
    lanes = tuple(u.shape[:-2])
    for _ in range(int(nsweeps)):
        u = stencils.red_black(u, rhs, dq, bcs)
        if all_neumann:
            s = strided_block_sum(u.reshape(lanes + (-1,)))  # (..., 1)
            u = u - (s * inv_n).reshape(lanes + (1, 1))
    return u


def v2d_smooth_plain(u, rhs, dq, bcs, nsweeps: int) -> torch.Tensor:
    """``nsweeps`` sweeps (with the per-sweep mean when all-Neumann)."""
    count_plain(v2d_smooth_plain, u)
    return _sweeps_plain(u, rhs, dq, bcs, nsweeps)


def v2d_smooth_residual_plain(u, rhs, dq, bcs, nsweeps: int):
    """(u', r): the sweeps, then ``poisson_residual`` of u'."""
    count_plain(v2d_smooth_residual_plain, u)
    u = _sweeps_plain(u, rhs, dq, bcs, nsweeps)
    return u, stencils.poisson_residual(u, rhs, dq, bcs)


def v2d_smooth_cor_plain(u, cor, rhs, dq, bcs, nsweeps: int) -> torch.Tensor:
    """The sweeps on ``u + cor``."""
    count_plain(v2d_smooth_cor_plain, u)
    return _sweeps_plain(u + cor, rhs, dq, bcs, nsweeps)


for _f in (v2d_smooth_plain, v2d_smooth_residual_plain, v2d_smooth_cor_plain):
    _f.plain_cuda_calls = 0


# ----------------------------------------------------------------------
# The plan (csrc/v2d_smooth.cu: kMaxSmem, kMaxCluster, kSlotWords,
# band_of, lane_smem; MAX_SMEM is the H100's 227 KB a block)
# ----------------------------------------------------------------------

#: Most blocks of a cluster (a non-portable size on the H100).
MAX_CLUSTER = 16
#: Threads of a block of the lane kernel (each keeps two sum slots).
LANE_THREADS = 512
#: Words after a block's rows: the slot partials a block hands on, the
#: tree's words, the mean (padded).
SLOT_WORDS = SUM_THREADS + LANE_THREADS + 4


class V2dPlan(NamedTuple):
    """How a ``(lanes, ny, nx)`` call runs: the ``route`` ("block",
    "cluster" or "global"), the ``cluster`` size C (blocks a lane; 1 off
    the cluster route), the most ``rows`` a block owns (its band), the
    ``row_words`` of a shared row (the even columns, then the odd ones),
    the ``smem_bytes`` of a block (0 on the global route) and the ``grid``
    (blocks a lane, lanes)."""

    route: str
    cluster: int
    rows: int
    row_words: int
    smem_bytes: int
    grid: Tuple[int, int]


def band(k: int, c: int, ny: int) -> Tuple[int, int]:
    """Rows ``[r0, r1)`` that block ``k`` of a cluster of ``c`` owns."""
    return k * ny // c, (k + 1) * ny // c


def area_rows(ny: int, c: int) -> int:
    """Rows of each row area of a block: the most rows a band has, and a
    halo row a side when c > 1."""
    return -(-int(ny) // int(c)) + (2 if c > 1 else 0)


def lane_smem(ny: int, nx: int, c: int) -> int:
    """Shared bytes of a block of the lane kernel with ``c`` blocks a lane:
    the u rows (band and halos), the rhs area of as many rows (it stages
    cor on load), the sum slots and the tree."""
    return 2 * area_rows(ny, c) * 2 * (-(-int(nx) // 2)) * 4 + SLOT_WORDS * 4


def v2d_plan(lanes: int, ny: int, nx: int, cluster: Optional[int] = None) -> V2dPlan:
    """The route of a call: the fewest blocks a lane, up to MAX_CLUSTER
    (and ny), whose bands fit shared memory; the global route past that.
    ``cluster`` forces C (clipped to ny; the tests' emulation and
    chip_smoke's measurements).  Memoised (it runs on every call)."""
    return _v2d_plan(int(lanes), int(ny), int(nx), None if cluster is None else int(cluster))


@functools.lru_cache(maxsize=256)
def _v2d_plan(lanes, ny, nx, cluster):
    words = 2 * (-(-nx // 2))
    if cluster is not None:
        sizes = [max(1, min(cluster, ny))]
    else:
        sizes = [c for c in range(1, min(MAX_CLUSTER, ny) + 1)
                 if lane_smem(ny, nx, c) <= MAX_SMEM][:1]
    if not sizes:
        return V2dPlan("global", 1, ny, 0, 0, (1, lanes))
    c = sizes[0]
    return V2dPlan("block" if c == 1 else "cluster", c, -(-ny // c), words,
                   lane_smem(ny, nx, c), (c, lanes))


#: Launches of each route on the card (the wrappers add one per call).
ROUTE_LAUNCHES = {"block": 0, "cluster": 0, "global": 0}


# ----------------------------------------------------------------------
# CUDA launch
# ----------------------------------------------------------------------


def _v2d_cuda(u, cor, rhs, dq, bcs, nsweeps: int, residual: bool, what: str,
              plan: Optional[V2dPlan] = None):
    """One launch of the route of ``plan`` (default: :func:`v2d_plan`)."""
    from ..utils import cuda_build

    lib = cuda_build.kernels()
    ny, nx = (int(s) for s in u.shape[-2:])
    lanes = int(np.prod(u.shape[:-2], dtype=np.int64))
    plan = v2d_plan(lanes, ny, nx) if plan is None else plan
    (wy, wx), w0 = stencils.stencil_weights(dq, torch.float32)
    out = torch.empty_like(u)
    res = torch.empty_like(u) if residual else None
    args = (lanes, ny, nx) + ((plan.cluster,) if plan.route != "global" else ()) + (
        int(nsweeps), stencils.first_color_parity(bcs), dirichlet_mask(bcs),
        int(stencils.is_all_neumann(bcs)), wy, wx, w0, _inv_n(u.shape))
    launch = lib.ndsm_v2d_smooth_f32 if plan.route == "global" else lib.ndsm_v2d_lane_f32
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = launch(u.data_ptr(), None if cor is None else cor.data_ptr(), rhs.data_ptr(),
                    out.data_ptr(), None if res is None else res.data_ptr(), *args, stream)
        cuda_build.check(rc, f"{what} ({plan.route} route, {plan.cluster} block(s) a lane)")
    return out, res, plan.route


# ----------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------


def v2d_smooth(u, rhs, dq, bcs, nsweeps: int) -> torch.Tensor:
    """``nsweeps`` red-black sweeps of ``laplace(u) = rhs`` on a float32 2D
    level (per lane).  Replaces ndsm_tpu/ops/pallas_v2d.py:v2d_smooth."""
    bcs = _check("v2d_smooth", (u, rhs), dq, bcs, nsweeps)
    if u.device.type == "cpu":
        return v2d_smooth_plain(u, rhs, dq, bcs, nsweeps)
    out, _, route = _v2d_cuda(u, None, rhs, dq, bcs, nsweeps, False, "v2d_smooth")
    v2d_smooth.launches += 1
    ROUTE_LAUNCHES[route] += 1
    return out


def v2d_smooth_residual(u, rhs, dq, bcs, nsweeps: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u', r): the sweeps, then the residual of the swept state.  Replaces
    ndsm_tpu/ops/pallas_v2d.py:v2d_smooth_residual."""
    bcs = _check("v2d_smooth_residual", (u, rhs), dq, bcs, nsweeps)
    if u.device.type == "cpu":
        return v2d_smooth_residual_plain(u, rhs, dq, bcs, nsweeps)
    out, res, route = _v2d_cuda(u, None, rhs, dq, bcs, nsweeps, True, "v2d_smooth_residual")
    v2d_smooth_residual.launches += 1
    ROUTE_LAUNCHES[route] += 1
    return out, res


def v2d_smooth_cor(u, cor, rhs, dq, bcs, nsweeps: int) -> torch.Tensor:
    """The sweeps on ``u + cor`` (the V-cycle ascent's correct-then-relax).
    Replaces ndsm_tpu/ops/pallas_v2d.py:v2d_smooth_cor."""
    bcs = _check("v2d_smooth_cor", (u, cor, rhs), dq, bcs, nsweeps)
    if u.device.type == "cpu":
        return v2d_smooth_cor_plain(u, cor, rhs, dq, bcs, nsweeps)
    out, _, route = _v2d_cuda(u, cor, rhs, dq, bcs, nsweeps, False, "v2d_smooth_cor")
    v2d_smooth_cor.launches += 1
    ROUTE_LAUNCHES[route] += 1
    return out


for _f in (v2d_smooth, v2d_smooth_residual, v2d_smooth_cor):
    _f.launches = 0
del _f
