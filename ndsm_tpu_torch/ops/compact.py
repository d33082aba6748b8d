"""Colour-split red-black smoother kernels for float32 3D levels (port of
``ndsm_tpu/ops/pallas_compact.py``: ``compact_smooth_3d``), with the split
and merge passes around them.

The state is the pair of colour halves of ops/stencils_compact.py: ``R``
and ``B`` (and ``rhs_R``, ``rhs_B``), each ``(nz, ny, ceil(nx/2))``, or
``(B, nz, ny, ceil(nx/2))`` for a stack of B <= 8 lanes that share the
grid and dq but not their boundary conditions.  A half-sweep reads the
other colour's half and its own rhs half and writes its own half, all
contiguous: half the bytes of a dense half-sweep (ops/zc.py, ops/fused.py).

  * :func:`compact_smooth_3d` is the TPU kernel's interface: ``nsweeps``
    sweeps of ``(R, B, rhs_R, rhs_B)`` -> ``(R, B)``, equal to ``nsweeps``
    calls of ``stencils_compact.rb_sweep_compact``, ghosts included.
    :func:`compact_smooth_3d_batched` is its lane form (lane b sweeps with
    ``bcs_list[b]``; ``active`` freezes lanes as in ops/fused.py: a frozen
    lane comes back unchanged and costs no sweep work, and an active lane
    does not depend on which lanes are active).  Lane b of the lane form
    equals the one-lane call on lane b bit for bit.
  * :func:`split_colors_3d` (``u`` or ``u + cor`` -> ``R, B``) and
    :func:`merge_colors_3d` (``R, B`` -> ``u``) are one pass each; with or
    without a lane axis.
  * :func:`smooth_dense` and :func:`smooth_residual_dense` are what the
    multigrid engines call, on a level or a stack: split ``u (+ cor)`` and
    ``rhs``, sweep, merge (then the dense residual launch of ops/zc.py).
    Merged, the result equals the dense sweeps of ops/zc.py bit for bit
    (the problems here are never all-Neumann).

Each wrapper, like ops/zc.py's: on a CUDA tensor launches the hand-written
kernels of ``csrc/compact_smooth.cu`` (built at first use) and adds one to
its launch counter (``zc.count_launch``), or raises; on a CPU tensor runs
its plain PyTorch version below, built from ops/stencils_compact.py
(``zc.count_plain`` counts any call of a plain version on a CUDA tensor).  The wrappers are
functional: inputs are never modified.

The sweeps are ``ceil(nsweeps / w)`` launches of the halves form of the
multi-sweep pass (``csrc/lane_pass.cuh``, flag C), each running w sweeps
of every lane over a shared-memory ring of planes, out of place,
ping-ponging between the result and one scratch pair of halves;
:func:`compact_plan` is ops/zc.py's ``pass_plan`` (one resident pass of
all sweeps on the smallest levels; the shared rows are the dense pass's)
with an even tile width (a window starts on an even column, where both
colours of a row start at k = wx0 / 2).  The counter ``zc.PASSES +
"compact"`` counts the launches (``ops.compact_pass_launches()``).

Unlike the TPU kernel there is no tile search, no sweep limit and no gate
on even extents or 128-wide rows: every shape with nz, ny >= 2 and nx >= 4
is taken.  All-Neumann problems are refused, as by the TPU kernel (their
per-sweep mean is ops/zc.py's ``zc_smooth_mean_3d``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..utils import profiling
from . import stencils
from . import stencils_compact as sc
from . import zc
from .fused import MAX_LANES, check_lanes, lane_masks, lane_residual
from .zc import check_config, check_level, count_launch, count_plain, residual_cuda

__all__ = [
    "compact_smooth_3d",
    "compact_smooth_3d_batched",
    "split_colors_3d",
    "merge_colors_3d",
    "smooth_dense",
    "smooth_residual_dense",
    "compact_smooth_3d_plain",
    "compact_smooth_3d_batched_plain",
    "split_colors_3d_plain",
    "merge_colors_3d_plain",
    "compact_tile",
    "compact_plan",
]

# ----------------------------------------------------------------------
# Plain PyTorch versions (oracles; CPU path)
# ----------------------------------------------------------------------


def compact_smooth_3d_plain(R, B, rhs_R, rhs_B, dq, bcs, nsweeps: int, nx: int):
    """``nsweeps`` calls of ``stencils_compact.rb_sweep_compact``."""
    count_plain(compact_smooth_3d_plain, R)
    for _ in range(int(nsweeps)):
        R, B = sc.rb_sweep_compact(R, B, rhs_R, rhs_B, dq, bcs, nx)
    return R, B


def compact_smooth_3d_batched_plain(R, B, rhs_R, rhs_B, dq, bcs_list, nsweeps: int, nx: int,
                                    active=None):
    """Per lane: the sweeps with the lane's BCs; a frozen lane unchanged."""
    count_plain(compact_smooth_3d_batched_plain, R)
    outs = []
    for b, bcs in enumerate(bcs_list):
        Rb, Bb = R[b], B[b]
        if active is None or active[b]:
            for _ in range(int(nsweeps)):
                Rb, Bb = sc.rb_sweep_compact(Rb, Bb, rhs_R[b], rhs_B[b], dq, bcs, nx)
        outs.append((Rb, Bb))
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _spatial_parity(u: torch.Tensor) -> torch.Tensor:
    """Row parity of the (nz, ny) axes; broadcasts over a lane axis."""
    return sc.row_parity(u.shape[-3:-1], u.device)


def split_colors_3d_plain(u, cor=None, active=None):
    """``split_colors`` of ``u`` (``u + cor`` on the active lanes)."""
    count_plain(split_colors_3d_plain, u)
    if cor is not None:
        v = u + cor
        if active is not None and not all(active):
            sel = torch.tensor([bool(a) for a in active], device=u.device).view(-1, 1, 1, 1)
            v = torch.where(sel, v, u)
        u = v
    return sc.split_colors_p(u, _spatial_parity(u))


def merge_colors_3d_plain(R, B, nx: int):
    """``merge_colors`` of the halves."""
    count_plain(merge_colors_3d_plain, R)
    return sc.merge_colors_p(R, B, nx, _spatial_parity(R))


# ----------------------------------------------------------------------
# CUDA launches
# ----------------------------------------------------------------------


def _int_array(values):
    return (ctypes.c_int * len(values))(*values)


def compact_tile(shape, width: int, nb: int = 1,
                 tile: Optional[Tuple[int, int, int]] = None) -> zc.PassTile:
    """The geometry of one pass of ``width`` sweeps over the halves of an
    (nb,) + shape stack (``shape`` the dense (nz, ny, nx)): ops/zc.py's
    ``pass_tile`` without the residual (its default tile, whose width is
    even or spans nx, or ``tile``).  Raises on a tile width that is odd and
    does not span nx: a window must start on an even column."""
    p = zc.pass_tile(shape, width, False, nb, tile)
    if p.tile[2] % 2 and p.tile[2] < int(shape[2]):
        raise ValueError(f"compact pass over {tuple(shape)}: tile width {p.tile[2]} is odd "
                         "and does not span nx (a window must start on an even column)")
    return p


def compact_plan(shape, nsweeps: int, nb: int = 1) -> Tuple[zc.PassTile, ...]:
    """The passes of a call of ``nsweeps`` sweeps on the halves of an (nb,)
    + shape stack: ops/zc.py's ``pass_plan`` (one resident pass of all of
    them on the smallest levels, else widths of ``zc.PASS_WIDTH`` and a
    last narrower one), each pass's tile held to :func:`compact_tile`'s
    rule.  Memoised."""
    return _compact_plan(tuple(int(s) for s in shape), int(nsweeps), int(nb))


@functools.lru_cache(maxsize=256)
def _compact_plan(shape, ns, nb):
    plan = zc.pass_plan(shape, ns, nb)
    for p in plan:
        compact_tile(shape, p.width, nb, p.tile)
    return plan


def _sweeps_cuda(R, B, rhs_R, rhs_B, dq, bcs_list, nsweeps: int, nx: int, active, what: str,
                 plan=None):
    """``nsweeps`` sweeps of (B, nz, ny, hx) halves: the passes of ``plan``
    (default :func:`compact_plan`'s), out of place, ping-ponging so that
    the last writes the returned halves."""
    from ..utils import cuda_build

    lib = cuda_build.kernels()
    nb, nz, ny, _ = (int(s) for s in R.shape)
    plan = compact_plan((nz, ny, nx), nsweeps, nb) if plan is None else plan
    (wz, wy, wx), w0, color, dmask, act = zc._pass_args(
        tuple(float(q) for q in dq), tuple(bcs_list), tuple(bool(a) for a in active))
    out = (torch.empty_like(R), torch.empty_like(B))
    tmp = (torch.empty_like(R), torch.empty_like(B)) if len(plan) > 1 else None
    src = (R, B)
    with torch.cuda.device(R.device):
        stream = torch.cuda.current_stream(R.device).cuda_stream
        for i, p in enumerate(plan):
            dst = out if (len(plan) - 1 - i) % 2 == 0 else tmp
            rc = lib.ndsm_compact_pass_f32(
                src[0].data_ptr(), src[1].data_ptr(), rhs_R.data_ptr(), rhs_B.data_ptr(),
                dst[0].data_ptr(), dst[1].data_ptr(), nb, nz, ny, int(nx), color, dmask, act,
                p.width, *p.tile, wz, wy, wx, w0, stream)
            cuda_build.check(rc, what)
            profiling.count(zc.PASSES + "compact")
            src = dst
    return out


def _split_cuda(u, cor, active):
    from ..utils import cuda_build

    lib = cuda_build.kernels()
    nb, nz, ny, nx = (int(s) for s in u.shape)
    half = (nb, nz, ny, (nx + 1) // 2)
    R = torch.empty(half, dtype=u.dtype, device=u.device)
    B = torch.empty(half, dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        rc = lib.ndsm_compact_split_f32(
            u.data_ptr(), None if cor is None else cor.data_ptr(), R.data_ptr(), B.data_ptr(),
            nb, nz, ny, nx, _int_array([1 if a else 0 for a in active]),
            torch.cuda.current_stream(u.device).cuda_stream)
        cuda_build.check(rc, "split_colors_3d")
    return R, B


def _merge_cuda(R, B, nx: int):
    from ..utils import cuda_build

    lib = cuda_build.kernels()
    nb, nz, ny, _ = (int(s) for s in R.shape)
    u = torch.empty((nb, nz, ny, int(nx)), dtype=R.dtype, device=R.device)
    with torch.cuda.device(R.device):
        rc = lib.ndsm_compact_merge_f32(
            R.data_ptr(), B.data_ptr(), u.data_ptr(), nb, nz, ny, int(nx),
            torch.cuda.current_stream(R.device).cuda_stream)
        cuda_build.check(rc, "merge_colors_3d")
    return u


# ----------------------------------------------------------------------
# Wrappers
# ----------------------------------------------------------------------


def _check_halves(name: str, halves, nx: int, ndim: Optional[int] = None) -> None:
    """Raise unless ``halves`` are float32 colour halves (``ceil(nx/2)``
    entries a row) of one level or stack of last extent ``nx >= 4``
    (of ``ndim`` axes when given)."""
    check_level(name, halves, torch.float32, lanes=True)
    shape = tuple(halves[0].shape)
    if ndim is not None and len(shape) != ndim:
        raise ValueError(f"{name}: expected halves of {ndim} axes, got {shape}")
    if int(nx) < 4 or shape[-1] != (int(nx) + 1) // 2:
        raise ValueError(f"{name}: halves of last extent {shape[-1]} do not split nx = {nx} "
                         "(nx >= 4, ceil(nx/2) entries a row)")
    if len(shape) == 4 and not 1 <= shape[0] <= MAX_LANES:
        raise ValueError(f"{name}: takes 1 to {MAX_LANES} lanes, got {shape[0]}")


def compact_smooth_3d(R, B, rhs_R, rhs_B, dq, bcs, nsweeps: int, nx: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``nsweeps`` red-black sweeps on the colour halves of one float32
    (nz, ny, nx) level.  Replaces ndsm_tpu/ops/pallas_compact.py:compact_smooth_3d."""
    _check_halves("compact_smooth_3d", (R, B, rhs_R, rhs_B), nx, ndim=3)
    bcs = check_config("compact_smooth_3d", dq, bcs, nsweeps)
    if R.device.type == "cpu":
        return compact_smooth_3d_plain(R, B, rhs_R, rhs_B, dq, bcs, nsweeps, nx)
    Ro, Bo = _sweeps_cuda(R[None], B[None], rhs_R[None], rhs_B[None], dq, (bcs,), nsweeps, nx,
                          (True,), "compact_smooth_3d")
    count_launch(compact_smooth_3d)
    return Ro[0], Bo[0]


def compact_smooth_3d_batched(R, B, rhs_R, rhs_B, dq, bcs_list, nsweeps: int, nx: int,
                              active=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lane form: ``nsweeps`` sweeps on the halves of every lane of a
    (B, nz, ny, nx) stack, lane b with ``bcs_list[b]``; the lanes ``active``
    does not mark come back unchanged."""
    name = "compact_smooth_3d_batched"
    bcs_list, active = check_lanes(name, (R, B, rhs_R, rhs_B), dq, bcs_list, nsweeps, active)
    _check_halves(name, (R, B), nx)
    if R.device.type == "cpu":
        return compact_smooth_3d_batched_plain(R, B, rhs_R, rhs_B, dq, bcs_list, nsweeps, nx,
                                               active)
    out = _sweeps_cuda(R, B, rhs_R, rhs_B, dq, bcs_list, nsweeps, nx, active, name)
    count_launch(compact_smooth_3d_batched)
    return out


def split_colors_3d(u, cor=None, active=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The colour halves of a float32 (nz, ny, nx) level or (B, nz, ny, nx)
    stack: of ``u``, or of ``u + cor`` (on a stack: on the lanes ``active``
    marks; the others split ``u`` alone).  Replaces the ``split_colors`` the
    JAX engine runs around its kernel (ndsm_tpu/ops/stencils_compact.py)."""
    name = "split_colors_3d"
    check_level(name, (u,) if cor is None else (u, cor), torch.float32, lanes=True)
    if not sc.compact_supported(tuple(u.shape[-3:])):
        raise ValueError(f"{name}: nx >= 4 is needed, got {tuple(u.shape)}")
    lanes = u.ndim == 4
    nb = int(u.shape[0]) if lanes else 1
    if not 1 <= nb <= MAX_LANES:
        raise ValueError(f"{name}: takes 1 to {MAX_LANES} lanes, got {nb}")
    active = [True] * nb if active is None else [bool(a) for a in active]
    if len(active) != nb:
        raise ValueError(f"{name}: {len(active)} active flags for {nb} lanes")
    if u.device.type == "cpu":
        return split_colors_3d_plain(u, cor, active if lanes else None)
    if lanes:
        R, B = _split_cuda(u, cor, active)
    else:
        R, B = (h[0] for h in _split_cuda(u[None], None if cor is None else cor[None], active))
    count_launch(split_colors_3d)
    return R, B


def merge_colors_3d(R, B, nx: int) -> torch.Tensor:
    """The dense level (or stack) of last extent ``nx`` from its colour
    halves.  Replaces ``merge_colors`` (ndsm_tpu/ops/stencils_compact.py)."""
    _check_halves("merge_colors_3d", (R, B), nx)
    if R.device.type == "cpu":
        return merge_colors_3d_plain(R, B, nx)
    u = _merge_cuda(R, B, nx) if R.ndim == 4 else _merge_cuda(R[None], B[None], nx)[0]
    count_launch(merge_colors_3d)
    return u



# ----------------------------------------------------------------------
# The dense interface of the multigrid engines
# ----------------------------------------------------------------------


def smooth_dense(u, rhs, dq, bcs, nsweeps: int, cor=None, active=None) -> torch.Tensor:
    """``nsweeps`` sweeps of a dense (nz, ny, nx) level with ``bcs``, or of
    a (B, nz, ny, nx) stack with one BC set a lane in ``bcs``, on
    colour-split state: split ``u`` (``u + cor`` when ``cor`` is given) and
    ``rhs``, sweep, merge.  A frozen lane of a stack ignores its ``cor``
    and comes back unchanged (its split and merge are an exact round trip)."""
    nx = int(u.shape[-1])
    R, B = split_colors_3d(u, cor, active)
    rhs_R, rhs_B = split_colors_3d(rhs)
    if u.ndim == 4:
        R, B = compact_smooth_3d_batched(R, B, rhs_R, rhs_B, dq, bcs, nsweeps, nx, active)
    else:
        R, B = compact_smooth_3d(R, B, rhs_R, rhs_B, dq, bcs, nsweeps, nx)
    return merge_colors_3d(R, B, nx)


def smooth_residual_dense(u, rhs, dq, bcs, nsweeps: int, active=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u', r): :func:`smooth_dense`, then the residual of the merged state
    (zero on Dirichlet faces and on frozen lanes): on a CUDA tensor the
    residual launch of the dense kernel family (``zc.residual_cuda``, as in
    ``zc_smooth_residual_3d``), on a CPU tensor the plain residual.  The
    TPU kernel has no residual form either."""
    u = smooth_dense(u, rhs, dq, bcs, nsweeps, None, active)
    lanes = u.ndim == 4
    if u.device.type == "cpu":
        if not lanes:
            return u, stencils.poisson_residual(u, rhs, dq, bcs)
        return u, lane_residual(u, rhs, dq, lane_masks(u.shape[1:], bcs, u.device), active)
    name = "smooth_residual_dense"
    if not lanes:
        return u, residual_cuda(u[None], rhs[None], dq, (bcs,), (True,), name)[0]
    act = [True] * len(bcs) if active is None else active
    return u, residual_cuda(u, rhs, dq, bcs, act, name)
