"""Sharded multigrid solver on a single-controller shard mesh (port of
``ndsm_tpu/parallel/sm_engine.py: ShardedPoissonBVP``), on a mesh that
partitions array axis 0 (z), or axes 0 and 1 (z, y).

The JAX engine runs the whole solve as one ``shard_map`` program: one
process drives every device, each holding one block.  Here one Python
process drives the mesh too: a sharded level is a list of blocks, block
``i`` on the ``i``-th device of the engine's mesh (the mesh of the
partitioned axes, ``Mesh.submesh``; blocks in its row-major order, each
leading array axis cut into equal blocks along its mesh axis), and the
collectives of ``parallel/collectives.py`` take the place of
``ppermute``, ``psum``, ``pmax`` and ``all_gather``.  An exchange along
one partitioned axis runs on each line of the mesh along that axis.

Level plan (as in JAX): a level is sharded while every partitioned extent
divides its mesh axis with at least ``min_rows_per_shard`` rows a shard;
the first level that does not (the seam), and every coarser one, is
replicated.  At the seam the fine residual is gathered once and everything
below runs on the root device (the first device of the mesh) through the
single-device engine (mg/engine.py, its kernels on every float32 level);
the prolonged correction is scattered back.  Between two sharded levels
the transfers multiply each partitioned axis by per-shard blocks of its
1-D matrix over an H-plane halo (``_axis_blocks``), z then y, then the
other axes by their full matrices.

Smoothing of a sharded level, fixed by its shape and dtype:

  * float32 3D, not all-Neumann, blocks of >= 4 points along every
    partitioned axis: passes of the per-shard kernel
    ``ops/zc_sharded.py`` on halo-extended blocks (B10 on a z mesh, its
    ``_zy`` form B10y on a (z, y) mesh, where the blocks are extended in z
    and then in y, so the corners hold the diagonal neighbours' values), 2
    sweeps a pass (1 when a block has < 6 points along a partitioned axis:
    the residual pass of width w needs 2w + 2), a remainder pass, and the
    V-cycle descent's residual fused into its last pass.  The width
    changes the exchanges, never the bits;
  * otherwise (float64 levels, 2D levels, 3D all-Neumann levels, smaller
    blocks): the plain sharded half-sweep, one boundary-plane exchange a
    partitioned axis a half-sweep, as JAX's XLA route; ``PLAIN_ROUTES``
    counts each run on a CUDA tensor.  On levels that are not all-Neumann
    it gives the bits of JAX's colour-compact sharded smoother too; on
    all-Neumann levels JAX's compact route sums the mean over the two
    colour halves, in another order (ulp level).

``Options.smoother`` keeps JAX's sharded meaning: the sharded kernel
whatever it says; replicated levels use the dense kernels.

Precision modes (as PoissonBVP): fp64, fp32, and mixed -- float32
V-cycles inside a float64 defect correction.  For a 3D problem that is
not all-Neumann with ``mixed_defect`` "auto"/"df32" the defect runs per
shard in ``ops/df_sharded.py`` (B11, or B11y on a (z, y) mesh) on the
iterate carried halo-extended across defect groups, each group exchanging
only its pending correction; otherwise the scaled float64 defect of
``_mixed_group`` with the plain sharded residual.

The loops run on the host and read each V-cycle's metric (one device
synchronisation), as PoissonBVP does.  ``make_sharded_sweep`` and
``make_sharded_residual`` give the plain sharded sweep and residual of one
level on their own, over the same primitives (``ShardStencil``).
``solve_checkpointed`` runs the strict sibling's loops in chunks and
writes the gathered iterate between them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..grids import GridHierarchy
from ..mg.poisson import PoissonBVP, _cached_engine, read_checkpoint, write_checkpoint
from ..ops import df_sharded, stencils, zc_sharded
from ..ops.transfer import (
    apply_axis_matrices,
    full_f32_matmul,
    interp_matrix_1d,
    restrict_matrix_1d,
)
from ..options import IERR_COVFAIL, IERR_SUCCESS, Options, SolveInfo
from ..utils.device import resolve_device
from . import collectives as C
from .shard import Mesh

__all__ = ["ShardedPoissonBVP", "ShardStencil", "make_sharded_sweep", "make_sharded_residual",
           "seam_of", "PLAIN_ROUTES", "plain_route_counts", "reset_plain_route_counts"]

_EPS32 = 32.0 * float(np.finfo(np.float32).eps)

#: Runs of the plain sharded routes on CUDA tensors, by kind and dimension.
PLAIN_ROUTES = {"half_sweep_3d": 0, "residual_3d": 0, "half_sweep_2d": 0, "residual_2d": 0}


def plain_route_counts() -> dict:
    return dict(PLAIN_ROUTES)


def reset_plain_route_counts() -> None:
    for k in PLAIN_ROUTES:
        PLAIN_ROUTES[k] = 0


def _axis_blocks(M: np.ndarray, ndev: int) -> Tuple[np.ndarray, int]:
    """Split an (n_out, n_in) transfer matrix into per-shard blocks.

    Returns (blocks, H): blocks has shape (ndev, n_out/ndev, bi + 2H)
    where bi = n_in/ndev and H is the halo depth covering every shard's
    actual column support; blocks[i] acts on the shard's local input
    extended by H planes per side (zero-padded beyond the global ends).
    """
    n_out, n_in = M.shape
    bo, bi = n_out // ndev, n_in // ndev
    H = 0
    for i in range(ndev):
        rows = M[i * bo : (i + 1) * bo]
        cols = np.flatnonzero(np.any(rows != 0.0, axis=0))
        if cols.size:
            H = max(H, i * bi - int(cols[0]), int(cols[-1]) + 1 - (i + 1) * bi)
    W = bi + 2 * H
    blocks = np.zeros((ndev, bo, W), dtype=np.float64)
    for i in range(ndev):
        lo = i * bi - H
        for w in range(W):
            c = lo + w
            if 0 <= c < n_in:
                blocks[i, :, w] = M[i * bo : (i + 1) * bo, c]
    return blocks, H


def seam_of(hierarchy: GridHierarchy, ndev, min_rows_per_shard: int) -> int:
    """The level plan: the number of leading levels that are sharded (each
    partitioned extent divisible by its shard count, ``ndev``: one count,
    for axis 0, or one per partitioned leading axis, with >=
    ``min_rows_per_shard`` rows a shard); the coarsest level is always
    replicated.  0: not partitionable."""
    counts = (int(ndev),) if np.ndim(ndev) == 0 else tuple(int(n) for n in ndev)
    seam = 0
    for shape in hierarchy.shapes[: hierarchy.ngrids - 1]:
        if any(shape[ax] % n or shape[ax] < n * min_rows_per_shard
               for ax, n in enumerate(counts)):
            break
        seam += 1
    return seam


def _apply_axis(x: torch.Tensor, m: torch.Tensor, ax: int) -> torch.Tensor:
    xt = x.movedim(ax, 0)
    y = torch.matmul(m, xt.reshape(xt.shape[0], -1))
    return y.reshape((m.shape[0],) + tuple(xt.shape[1:])).movedim(0, ax)


class ShardStencil:
    """Blocks of the levels of a grid cut over a shard mesh, and the plain
    sharded red-black sweep and residual on them: what the engine and
    ``make_sharded_sweep`` / ``make_sharded_residual`` share (JAX
    ``ShardStencilKernels``), so there is one halo implementation.

    ``shapes`` and ``dq``: each level's global shape and spacings; ``mesh``
    and ``axis_names`` as for ``ShardedPoissonBVP``.  Block i of a level
    lies on ``devices[i]``, at ``_coords[i]`` of the mesh of the partitioned
    axes; ``_lines[ax]`` are that mesh's lines along partitioned axis ax.
    """

    def __init__(self, shapes, dq, bcs, mesh: Mesh, axis_names: Sequence[str]):
        ndim = len(shapes[0])
        names = tuple(axis_names)
        if not names or len(names) >= ndim:
            raise ValueError(f"axis_names {names}: partition 1 to {ndim - 1} leading "
                             "array axes (the last array axis cannot be partitioned)")
        sub = mesh.submesh(names)  # (ValueError for a name the mesh lacks)
        self.bcs = stencils.validate_bcs(bcs, ndim)
        self.ndim = ndim
        self._all_neumann = stencils.is_all_neumann(self.bcs)
        self._shapes = [tuple(sh) for sh in shapes]
        self._dq = [tuple(float(v) for v in d) for d in dq]
        self.mesh = mesh
        self.names = names
        #: shards along each partitioned axis, by mesh axis name
        self.ndev: Dict[str, int] = dict(zip(names, sub.shape))
        self.grid: Tuple[int, ...] = tuple(sub.shape)
        self._coords = [sub.coords(i) for i in range(len(sub.devices))]
        self._lines = [sub.lines(nm) for nm in names]
        # (an unindexed "cuda" is the current device, so that it equals the
        # device of the tensors made on it)
        self.devices = tuple(
            torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d
            for d in (resolve_device(d) for d in sub.devices)
        )
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"a mesh on devices of several types: {self.devices}")
        self.device = self.devices[0]

    # ------------------------------------------------------------------
    # Geometry
    # ------------------------------------------------------------------

    def _local(self, level: int) -> Tuple[int, ...]:
        """The block shape of a sharded level."""
        shape = list(self._shapes[level])
        for ax, n in enumerate(self.grid):
            shape[ax] //= n
        return tuple(shape)

    def _offsets(self, level: int, i: int) -> Tuple[int, ...]:
        """Global index of block i's first point along each partitioned axis."""
        local = self._local(level)
        return tuple(c * local[ax] for ax, c in enumerate(self._coords[i]))

    def _extents(self, level: int) -> Tuple[int, ...]:
        return tuple(self._shapes[level][: len(self.grid)])

    def _pax(self, x: torch.Tensor) -> int:
        """The first partitioned axis of ``x`` (after its lane axes)."""
        return x.ndim - self.ndim

    def _sdims(self, x: torch.Tensor) -> Tuple[int, ...]:
        return tuple(range(x.ndim - self.ndim, x.ndim))

    def _shard_masks(self, level: int, i: int, device):
        """(red, black, interior) of shard i's block at a sharded level."""
        return stencils.shard_masks(self._local(level), self._offsets(level, i),
                                    self._extents(level), self.bcs, device)

    def _extend(self, xs, H: int):
        """The blocks extended by H planes a side along every partitioned
        axis, z first, then y on the z-extended blocks (JAX
        ``_extend_block``: the corners hold the diagonal neighbours')."""
        pax = self._pax(xs[0])
        for ax, line in enumerate(self._lines):
            xs = C.extend_block(xs, self.devices, pax + ax, H, line)
        return xs

    def _unextend(self, xs, H: int):
        pax = self._pax(xs[0])
        for ax in range(len(self.grid)):
            xs = C.unextend_block(xs, pax + ax, H)
        return xs

    # ------------------------------------------------------------------
    # Sharded level primitives (lists of blocks)
    # ------------------------------------------------------------------

    def _count_plain(self, x: torch.Tensor, kind: str) -> None:
        if x.device.type == "cuda":
            PLAIN_ROUTES[f"{kind}_{self.ndim}d"] += 1

    def _lead_pair(self, us, ax: int):
        """(lower, upper) neighbour blocks along partitioned axis ``ax``:
        one plane from each neighbour shard of its line, index reflection
        at the global ends."""
        a = self._pax(us[0]) + ax
        fp, fn = C.exchange_planes(us, self.devices, a, 1, self._lines[ax])
        los, his = [], []
        for p, u, q in zip(fp, us, fn):
            n = u.shape[a]
            first = p if p is not None else u.narrow(a, 1, 1)
            last = q if q is not None else u.narrow(a, n - 2, 1)
            los.append(torch.cat([first, u.narrow(a, 0, n - 1)], dim=a))
            his.append(torch.cat([u.narrow(a, 1, n - 1), last], dim=a))
        return los, his

    def _stencil_pairs(self, us):
        """Per block: (i, u, pairs) with the (lower, upper) neighbours of u
        along every spatial axis, exchanged along the partitioned axes and
        reflected along the rest."""
        pax, k = self._pax(us[0]), len(self.grid)
        lead = [self._lead_pair(us, ax) for ax in range(k)]
        for i, u in enumerate(us):
            yield i, u, [(lead[ax][0][i], lead[ax][1][i]) if ax < k
                         else stencils._neighbors(u, pax + ax) for ax in range(self.ndim)]

    def _sh_half(self, us, rhss, level: int, which: int, w, w0):
        self._count_plain(us[0], "half_sweep")
        out = []
        for i, u, pairs in self._stencil_pairs(us):
            total = None
            for ax, (lo, hi) in enumerate(pairs):
                term = (lo + hi) * w[ax]
                total = term if total is None else total + term
            unew = (total - rhss[i]) * w0
            out.append(torch.where(self._shard_masks(level, i, u.device)[which], unew, u))
        return out

    def _sh_sweep(self, us, rhss, level: int):
        """One red-black sweep of the plain sharded route (JAX
        ``_sharded_sweep``); all-Neumann levels subtract the global mean."""
        w, w0 = stencils.stencil_weights(self._dq[level], us[0].dtype)
        us = self._sh_half(us, rhss, level, 0, w, w0)
        us = self._sh_half(us, rhss, level, 1, w, w0)
        if self._all_neumann:
            sd = self._sdims(us[0])
            total = C.psum([torch.sum(u, dim=sd) for u in us], self.devices)
            mean = total / float(np.prod(self._shapes[level]))
            us = [u - m for u, m in zip(us, self._bc(mean))]
        return us

    def _sh_residual(self, us, rhss, level: int):
        """``rhs - L[u]`` of the plain sharded route (JAX
        ``_sharded_residual``), zero on Dirichlet points."""
        self._count_plain(us[0], "residual")
        w, _ = stencils.stencil_weights(self._dq[level], us[0].dtype)
        out = []
        for i, u, pairs in self._stencil_pairs(us):
            lap = None
            for ax, (lo, hi) in enumerate(pairs):
                term = (lo - 2.0 * u + hi) * w[ax]
                lap = term if lap is None else lap + term
            r = rhss[i] - lap
            out.append(r.masked_fill(~self._shard_masks(level, i, u.device)[2], 0.0))
        return out

    def _bc(self, x: torch.Tensor):
        """A per-lane root value on every shard, broadcastable over a level."""
        return [v.reshape(tuple(v.shape) + (1,) * self.ndim)
                for v in C.broadcast(x, self.devices)]


class ShardedPoissonBVP(ShardStencil):
    """Poisson solve with the levels above the seam block-partitioned along
    the leading array axes over ``mesh`` (see module docstring).

    Parameters:
      hierarchy, bcs, options: as for PoissonBVP.
      mesh: a ``Mesh`` holding every name of ``axis_names``; with more axes
        the engine runs on its sub-mesh of those names, at index 0 of the
        others (``Mesh.submesh``).
      axis_names: the mesh axis of each partitioned array axis, from axis
        0: ``("z",)`` or ``("z", "y")``.  The last array axis cannot be
        partitioned.
      min_rows_per_shard: replicate levels with fewer rows a shard (>= 2).
    """

    def __init__(
        self,
        hierarchy: GridHierarchy,
        bcs: Sequence[Sequence[str]],
        options: Options = Options(),
        *,
        mesh: Mesh,
        axis_names: Sequence[str] = ("z",),
        min_rows_per_shard: int = 4,
    ):
        if int(min_rows_per_shard) < 2:
            raise ValueError("min_rows_per_shard must be >= 2 (a global end reflects "
                             "its shard's second plane)")
        ShardStencil.__init__(self, hierarchy.shapes, hierarchy.dq, bcs, mesh, axis_names)
        self.h = hierarchy
        self.options = options
        self.min_rows_per_shard = int(min_rows_per_shard)
        self.mode = options.resolve_precision(self.device)
        if self.mode not in ("fp64", "mixed", "fp32"):
            raise ValueError(f"unknown precision mode {self.mode!r}")
        self.outer_dtype = torch.float32 if self.mode == "fp32" else torch.float64
        self.inner_dtype = torch.float64 if self.mode == "fp64" else torch.float32
        self._inner_max = max(1, int(options.mixed_inner_max)) if self.mode == "mixed" else 1

        self.seam = seam_of(hierarchy, self.grid, self.min_rows_per_shard)
        if self.seam == 0:
            raise ValueError(
                f"finest level {hierarchy.shapes[0]} cannot be partitioned over mesh axes "
                f"{self.ndev} (each partitioned extent must divide its mesh axis with >= "
                f"{self.min_rows_per_shard} rows a shard)"
            )

        # Replicated levels and the coarse solve: the single-device engine
        # on the root (direct coarse solve unless "relax", as the JAX
        # sharded engine; dense kernels whatever ``smoother`` says).
        self._rep = _cached_engine(
            hierarchy, self.bcs, options.ms, options.du_max, self.inner_dtype, self.device,
            options.coarse_solver != "relax", "auto",
        )
        self.coarse_direct = self._rep.coarse_direct

        # Per-shard transfer blocks of sharded -> sharded level pairs, per
        # partitioned axis (each shard's by its coordinate on that axis),
        # and the full matrices of the other axes on every device.
        k = len(self.names)
        self._blocks: List[Dict[str, tuple]] = []
        for l in range(self.seam - 1):
            fine, coarse = hierarchy.meshes[l], hierarchy.meshes[l + 1]
            pair = {}
            for kind, mats in (
                ("R", [restrict_matrix_1d(c, f) for f, c in zip(fine, coarse)]),
                ("P", [interp_matrix_1d(f, c) for f, c in zip(fine, coarse)]),
            ):
                per_axis = []
                for ax in range(k):
                    blocks, H = _axis_blocks(mats[ax], self.grid[ax])
                    per_axis.append(([self._t(blocks[c[ax]], d)
                                      for c, d in zip(self._coords, self.devices)], H))
                rest = {d: [self._t(m, d) for m in mats[k:]] for d in set(self.devices)}
                pair[kind] = (per_axis, rest)
            self._blocks.append(pair)

        #: True when the mixed 3D defect runs per shard in ops/df_sharded.py.
        self.df_defect = (
            self.mode == "mixed"
            and self.ndim == 3
            and not self._all_neumann
            and options.mixed_defect != "f64"
        )
        self._strict_bvp: Optional["ShardedPoissonBVP"] = None

    def _t(self, m: np.ndarray, device) -> torch.Tensor:
        return torch.as_tensor(m, dtype=self.inner_dtype, device=device)

    def _zeros(self, level: int, lanes, dtype):
        if level < self.seam:
            shape = tuple(lanes) + self._local(level)
            return [torch.zeros(shape, dtype=dtype, device=d) for d in self.devices]
        return torch.zeros(tuple(lanes) + tuple(self.h.shapes[level]), dtype=dtype,
                           device=self.device)

    def _pass_width(self, level: int, x: torch.Tensor) -> int:
        """Sweeps a pass of the per-shard kernel, or 0 for the plain route:
        from the smallest partitioned extent of a block."""
        if x.dtype != torch.float32 or self.ndim != 3 or self._all_neumann:
            return 0
        n = min(self._local(level)[: len(self.grid)])
        return 2 if n >= 6 else 1 if n >= 4 else 0

    def _kernel_pass(self, us, rhss, level: int, ns: int, rhs_ext: dict, residual=False):
        """One pass of ``ns`` sweeps of the per-shard kernel (+ the
        residual), over a halo of 2*ns (+1) points along every partitioned
        axis; ``rhs_ext`` caches the extended rhs of the calling smoother
        by depth."""
        H = 2 * ns + (1 if residual else 0)
        if H not in rhs_ext:
            rhs_ext[H] = self._extend(rhss, H)
        ue = self._extend(us, H)
        dq, ext = self._dq[level], self._extents(level)
        if len(self.grid) == 1:
            fn = zc_sharded.zc_smooth_residual_sharded_3d if residual else \
                zc_sharded.zc_smooth_sharded_3d
            return [fn(u, r, dq, self.bcs, ns, self._offsets(level, i)[0], ext[0], H)
                    for i, (u, r) in enumerate(zip(ue, rhs_ext[H]))]
        fn = zc_sharded.zc_smooth_residual_sharded_3d_zy if residual else \
            zc_sharded.zc_smooth_sharded_3d_zy
        return [fn(u, r, dq, self.bcs, ns, self._offsets(level, i), ext, (H, H))
                for i, (u, r) in enumerate(zip(ue, rhs_ext[H]))]

    def _sh_smooth(self, us, rhss, level: int, n: int):
        width = self._pass_width(level, us[0])
        if not width:
            for _ in range(n):
                us = self._sh_sweep(us, rhss, level)
            return us
        ns_star = min(n, width)
        q, rem = divmod(n, ns_star)
        rhs_ext: dict = {}
        for ns in [ns_star] * q + ([rem] if rem else []):
            us = self._kernel_pass(us, rhss, level, ns, rhs_ext)
        return us

    def _sh_smooth_residual(self, us, rhss, level: int, n: int):
        """n sweeps and the residual: width passes, then the residual pass
        of the last ``rem or width`` sweeps (JAX ``_smooth_residual_sh``)."""
        width = self._pass_width(level, us[0])
        if width and n >= 1:
            ns_star = min(n, width)
            last = n % ns_star or ns_star
            rhs_ext: dict = {}
            for _ in range((n - last) // ns_star):
                us = self._kernel_pass(us, rhss, level, ns_star, rhs_ext)
            out = self._kernel_pass(us, rhss, level, last, rhs_ext, residual=True)
            return [o[0] for o in out], [o[1] for o in out]
        us = self._sh_smooth(us, rhss, level, n)
        return us, self._sh_residual(us, rhss, level)

    def _apply_blocks(self, xs, per_axis, rest):
        """Contract each partitioned axis with each shard's block over an
        H-plane halo (z, then y), then the other axes with their full
        matrices."""
        full_f32_matmul()
        pax = self._pax(xs[0])
        for ax, ((blocks, H), line) in enumerate(zip(per_axis, self._lines)):
            ext = C.exchange_halo(xs, self.devices, pax + ax, H, line)
            xs = [_apply_axis(x, b, pax + ax) for x, b in zip(ext, blocks)]
        return [apply_axis_matrices(x, rest[x.device]) for x in xs]

    # ------------------------------------------------------------------
    # Level dispatch: sharded levels above the seam, replicated below
    # ------------------------------------------------------------------

    def _smooth(self, u, rhs, level: int):
        if level < self.seam:
            return self._sh_smooth(u, rhs, level, self.options.ms)
        return self._rep.t_smooth(u, rhs, level)

    def _smooth_residual(self, u, rhs, level: int):
        if level < self.seam:
            return self._sh_smooth_residual(u, rhs, level, self.options.ms)
        return self._rep.t_smooth_residual(u, rhs, level)

    def _smooth_cor(self, u, cor, rhs, level: int):
        if level < self.seam:
            return self._sh_smooth([a + b for a, b in zip(u, cor)], rhs, level,
                                   self.options.ms)
        return self._rep.t_smooth_cor(u, cor, rhs, level)

    def _restrict(self, r, level: int):
        """Level -> level + 1; the seam gathers the fine residual first."""
        if level + 1 < self.seam:
            return self._apply_blocks(r, *self._blocks[level]["R"])
        if level < self.seam:
            r = C.all_gather(r, self.devices, self._pax(r[0]), self.grid)
        return self._rep.t_restrict(r, level)

    def _prolong(self, uc, level: int):
        """Level + 1 -> level; the seam scatters the prolonged correction."""
        if level + 1 < self.seam:
            return self._apply_blocks(uc, *self._blocks[level]["P"])
        full = self._rep.t_prolong(uc, level)
        if level < self.seam:
            return C.scatter(full, self.devices, self._pax(full), self.grid)
        return full

    def _metric(self, a, b):
        """max or mean |a - b| over the finest level, one value per lane, on
        the root."""
        sd = self._sdims(a[0])
        if self.options.du_max:
            return C.pmax([torch.amax(torch.abs(x - y), dim=sd) for x, y in zip(a, b)],
                          self.devices)
        s = C.psum([torch.sum(torch.abs(x - y), dim=sd) for x, y in zip(a, b)], self.devices)
        return s / float(np.prod(self.h.shapes[0]))

    # ------------------------------------------------------------------
    # Cycles
    # ------------------------------------------------------------------

    def _vcycle(self, u, rhs, ex_tol, nmax_exact):
        """One V-cycle from level 0 (a list of blocks).  Returns
        ``(u, coarse_noconv)``."""
        L = self.h.ngrids
        lanes = tuple(u[0].shape[: self._pax(u[0])])
        us: list = [None] * L
        rhss: list = [None] * L
        us[0], rhss[0] = u, rhs
        for l in range(L - 1):
            ul, r = self._smooth_residual(us[l], rhss[l], l)
            rhss[l + 1] = self._restrict(r, l)
            us[l] = ul
            us[l + 1] = self._zeros(l + 1, lanes, u[0].dtype)
        if self.coarse_direct:
            us[L - 1], noconv = self._rep.t_coarse_solve_direct(rhss[L - 1]), False
        else:
            us[L - 1], noconv = self._rep.t_solve_exact(
                us[L - 1], rhss[L - 1], L - 1, ex_tol, nmax_exact)
        for l in range(L - 2, -1, -1):
            uc = self._smooth(us[l + 1], rhss[l + 1], l + 1)
            cor = self._prolong(uc, l)
            us[l] = self._smooth_cor(us[l], cor, rhss[l], l)
        return us[0], noconv

    def _vcycle_du(self, u, rhs, ex_tol, nmax_exact, u_ref):
        u_new, noconv = self._vcycle(u, rhs, ex_tol, nmax_exact)
        return u_new, noconv, self._metric(u_new, u_ref)

    def _mixed_group(self, u, rhs, ex_tol, nmax_exact, vc_tol, it, nmax):
        """One float64 defect, scaled to unit max, supporting up to
        ``inner_max`` float32 V-cycles (JAX ``_mixed_group``); per lane,
        a lane whose inner condition fails is frozen.  Returns (u_new,
        noconv, du, ncycles), the last three per lane on the root."""
        sd = self._sdims(u[0])
        r0 = self._sh_residual(u, rhs, 0)
        s = C.pmax([torch.amax(torch.abs(r), dim=sd) for r in r0], self.devices)
        pos = s > 0
        s_safe = torch.where(pos, s, torch.ones_like(s))
        r32 = [(r / sb).to(torch.float32) for r, sb in zip(r0, self._bc(s_safe))]
        ex_tol_eff = max(float(ex_tol), _EPS32)
        e = [torch.zeros_like(r) for r in r32]
        du_e = torch.full(s.shape, float(np.finfo(np.float32).max), dtype=torch.float32,
                          device=self.device)
        k = torch.zeros(s.shape, dtype=torch.long, device=self.device)
        nc = torch.zeros(s.shape, dtype=torch.bool, device=self.device)

        def du_of(du_e):
            d = s_safe * du_e.to(self.outer_dtype)
            return torch.where(pos, d, torch.zeros_like(d))

        while True:
            cond = (k == 0) | ((du_of(du_e) >= vc_tol) & (it + k < nmax)
                               & (k < self._inner_max))
            if not bool(cond.any()):
                break
            e_new, noconv, du_new = self._vcycle_du(e, r32, ex_tol_eff, nmax_exact, e)
            e = [torch.where(c, a, b) for c, a, b in zip(self._bc(cond), e_new, e)] \
                if cond.ndim else e_new
            du_e = torch.where(cond, du_new.to(torch.float32), du_e)
            k = k + cond.to(torch.long)
            nc = nc | (cond & noconv)
        u_new = []
        for ui, ei, sb, pb in zip(u, e, self._bc(s_safe), self._bc(pos)):
            e64 = ei.to(self.outer_dtype) * sb
            u_new.append(ui + torch.where(pb, e64, torch.zeros_like(e64)))
        if self._all_neumann:
            total = C.psum([torch.sum(x, dim=sd) for x in u_new], self.devices)
            mean = total / float(np.prod(self.h.shapes[0]))
            u_new = [x - m for x, m in zip(u_new, self._bc(mean))]
        return u_new, nc, du_of(du_e), k

    def _loop(self, u, rhs, vc_tol, ex_tol, nmax, nmax_exact):
        """Outer V-cycle loop, lane-masked when the blocks carry a lane axis
        (a lane whose du < vc_tol or whose cycles reach nmax is frozen)."""
        lanes = tuple(u[0].shape[: self._pax(u[0])])
        big = float(np.finfo(np.float32 if self.outer_dtype == torch.float32
                             else np.float64).max)
        du = torch.full(lanes, big, dtype=self.outer_dtype, device=self.device)
        it = torch.zeros(lanes, dtype=torch.long, device=self.device)
        flag = torch.zeros(lanes, dtype=torch.bool, device=self.device)
        while True:
            active = (it < nmax) & (du >= vc_tol)
            if not bool(active.any()):
                break
            if self.mode == "mixed":
                u_new, noconv, du_new, ncyc = self._mixed_group(
                    u, rhs, ex_tol, nmax_exact, vc_tol, it, nmax)
            else:
                u_new, nc, du_new = self._vcycle_du(u, rhs, ex_tol, nmax_exact, u)
                noconv = torch.full(lanes, bool(nc), device=self.device)
                ncyc = torch.ones(lanes, dtype=torch.long, device=self.device)
            u = [torch.where(a, x, y) for a, x, y in zip(self._bc(active), u_new, u)] \
                if lanes else u_new
            du = torch.where(active, du_new.to(self.outer_dtype), du)
            it = it + torch.where(active, ncyc, torch.zeros_like(ncyc))
            flag = flag | (noconv & active)
        ierr = torch.where(du < vc_tol, IERR_SUCCESS, IERR_COVFAIL)
        return u, du, it, ierr, flag

    def _defect(self, i: int, u_ext, rhs, e_ext=None):
        """The per-shard defect of block i at level 0 (B11 on a z mesh, B11y
        on a (z, y) mesh), applying ``e_ext`` first when given."""
        dq, off, ext = self._dq[0], self._offsets(0, i), self._extents(0)
        if len(self.grid) == 1:
            off, ext = off[0], ext[0]
            if e_ext is None:
                return df_sharded.df_residual_sharded_3d(u_ext, rhs, dq, self.bcs, off, ext)
            return df_sharded.df_update_residual_sharded_3d(u_ext, rhs, e_ext, dq, self.bcs,
                                                            off, ext)
        if e_ext is None:
            return df_sharded.df_residual_sharded_3d_zy(u_ext, rhs, dq, self.bcs, off, ext)
        return df_sharded.df_update_residual_sharded_3d_zy(u_ext, rhs, e_ext, dq, self.bcs,
                                                           off, ext)

    def _solve_df(self, u, rhs, vc_tol, ex_tol, nmax, nmax_exact):
        """3D mixed solve with the per-shard defect (JAX
        ``_local_solve_df_impl``, with PoissonBVP._solve_df's flow): the
        float64 iterate is carried extended by one halo plane; the first
        group's defect takes it as it is, each later group's applies the
        previous group's correction, extended (its one exchange); the
        final correction is applied on the real blocks after the loop.
        ``rhs=None`` is the zero-rhs form."""
        big = float(np.finfo(np.float64).max)
        if nmax < 1:  # reference DO-loop contract: no cycles, u0 back
            return u, big, 0, IERR_COVFAIL, False
        rhs = [None] * len(self.devices) if rhs is None else rhs
        u_ext = self._extend(u, 1)
        e = None
        it, flag = 0, False
        while True:
            if e is None:
                out = [self._defect(i, ue, r) for i, (ue, r) in enumerate(zip(u_ext, rhs))]
            else:
                out = [self._defect(i, ue, r, ee)
                       for i, (ue, r, ee) in enumerate(zip(u_ext, rhs, self._extend(e, 1)))]
                u_ext = [o[2] for o in out]
            r32 = [o[0] for o in out]
            mx = C.pmax([o[1] for o in out], self.devices)
            ex_tol_eff = max(float(ex_tol), _EPS32 * float(mx))
            e = [torch.zeros_like(r) for r in r32]
            du_e, k = big, 0
            while k == 0 or (du_e >= vc_tol and it + k < nmax and k < self._inner_max):
                e, noconv, du_t = self._vcycle_du(e, r32, ex_tol_eff, nmax_exact, e)
                du_e = float(du_t)
                flag = flag or noconv
                k += 1
            it += k
            if not (it < nmax and du_e >= vc_tol):
                break
        u = [a + b.to(torch.float64) for a, b in zip(self._unextend(u_ext, 1), e)]
        ierr = IERR_SUCCESS if du_e < vc_tol else IERR_COVFAIL
        return u, du_e, it, ierr, flag

    # ------------------------------------------------------------------
    # Public entry points
    # ------------------------------------------------------------------

    def _split(self, x, what: str, lanes: int = 0):
        t = torch.as_tensor(x, dtype=self.outer_dtype, device=self.device)
        if tuple(t.shape[lanes:]) != tuple(self.h.fine_shape):
            raise ValueError(f"{what} shape {tuple(t.shape)} != fine grid {self.h.fine_shape}")
        return C.shard(t, self.devices, lanes, self.grid)

    def _limits(self):
        o = self.options
        npdt = np.float32 if self.outer_dtype == torch.float32 else np.float64
        return float(npdt(o.vc_tol)), float(o.ex_tol), int(o.ncycles_max), int(o.niterex_max)

    def _sync(self) -> None:
        for d in set(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def solve(self, u0, rhs, *, name: str = "", zero_rhs: bool = False,
              output_dtype=None) -> Tuple[torch.Tensor, SolveInfo]:
        """Sharded solve of ``laplace(u) = rhs`` from ``u0`` (numpy arrays
        or tensors of the fine shape), with the tolerances and limits of
        ``options``.  ``zero_rhs`` ignores ``rhs``; ``output_dtype`` casts
        the solution.  Returns (u, SolveInfo) with u gathered on the root
        device."""
        vc_tol, ex_tol, nmax, nmax_exact = self._limits()
        u = self._split(u0, "u0")
        t0 = time.perf_counter()
        if self.df_defect:
            r = None if zero_rhs else self._split(rhs, "rhs")
            u, du, it, ierr, flag = self._solve_df(u, r, vc_tol, ex_tol, nmax, nmax_exact)
        else:
            r = [torch.zeros_like(b) for b in u] if zero_rhs else self._split(rhs, "rhs")
            u, du, it, ierr, flag = self._loop(u, r, vc_tol, ex_tol, nmax, nmax_exact)
        u = C.unshard(u, self.devices, 0, self.grid)
        if output_dtype is not None:
            u = u.to(getattr(torch, output_dtype) if isinstance(output_dtype, str)
                     else output_dtype)
        self._sync()
        info = SolveInfo(ierr=int(ierr), du_last=float(du), cycles=int(it), name=name,
                         wall_time=time.perf_counter() - t0, coarse_noconv=bool(flag))
        PoissonBVP._post_warnings([info])
        return u, info

    def _strict_sibling(self) -> "ShardedPoissonBVP":
        """This configuration with ``mixed_inner_max=1`` (one V-cycle a
        defect), on the same mesh, axes and ``min_rows_per_shard``, built
        once; ``self`` when the solve is not mixed or is strict already.
        Its iterate sequence does not depend on where a checkpoint chunk
        ends (JAX ``_strict_sibling``)."""
        if self.mode != "mixed" or self._inner_max == 1:
            return self
        if self._strict_bvp is None:
            self._strict_bvp = ShardedPoissonBVP(
                self.h, self.bcs, dataclasses.replace(self.options, mixed_inner_max=1),
                mesh=self.mesh, axis_names=self.names,
                min_rows_per_shard=self.min_rows_per_shard,
            )
        return self._strict_bvp

    def solve_checkpointed(self, u0, rhs, *, checkpoint_path: str, checkpoint_every: int = 32,
                           name: str = "") -> Tuple[torch.Tensor, SolveInfo]:
        """Resumable sharded solve (JAX ``ShardedPoissonBVP.
        solve_checkpointed``): V-cycles run in chunks of
        ``checkpoint_every`` through the strict sibling's loops, and
        between chunks the global iterate is gathered and written
        atomically to ``checkpoint_path`` (``mg.poisson.write_checkpoint``:
        ``u``, ``cycles``, ``du``, ``shape``); a solve that finds a file of
        its fine shape there resumes from it.  The iterates do not depend
        on ``checkpoint_every``.  Returns (u, SolveInfo) with u gathered
        on the root device.

        One process drives the mesh, so it gathers and writes; the
        multi-process form (a global array built from per-process files,
        and process 0 writing) waits for the multi-process layer."""
        if int(checkpoint_every) < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
        sb = self._strict_sibling()
        vc_tol, ex_tol, nmax, nmax_exact = sb._limits()
        shape = sb.h.fine_shape
        u, cycles, du = u0, 0, float("inf")
        ck = read_checkpoint(checkpoint_path, shape)
        if ck is not None:
            u, cycles, du = ck
        u = sb._split(u, "u0")
        r = sb._split(rhs, "rhs")
        loop = sb._solve_df if sb.df_defect else sb._loop
        t0 = time.perf_counter()
        flag = False
        while cycles < nmax and not du < vc_tol:
            chunk = min(int(checkpoint_every), nmax - cycles)
            u, du_j, it, _, noconv = loop(u, r, vc_tol, ex_tol, chunk, nmax_exact)
            du, cycles, flag = float(du_j), cycles + int(it), flag or bool(noconv)
            write_checkpoint(checkpoint_path, C.unshard(u, sb.devices, 0, sb.grid).cpu().numpy(),
                             cycles, du, shape)
        u = C.unshard(u, sb.devices, 0, sb.grid)
        sb._sync()
        info = SolveInfo(ierr=IERR_SUCCESS if du < vc_tol else IERR_COVFAIL, du_last=du,
                         cycles=cycles, name=name, wall_time=time.perf_counter() - t0,
                         coarse_noconv=flag)
        PoissonBVP._post_warnings([info])
        return u, info

    def solve_batch(self, u0s, rhss, *, names: Optional[Sequence[str]] = None):
        """Solve B same-configuration problems.  With a direct coarse solve
        on a 2D problem the lanes run together, lane-masked (a converged
        lane is frozen, so each follows its standalone iterate sequence);
        otherwise one ``solve`` per lane (JAX runs relax-coarse batches
        lane by lane; the port's 3D kernels take one lane).  Returns (list
        of u, list of SolveInfo)."""
        names = list(names) if names is not None else [""] * len(u0s)
        if not self.coarse_direct or self.ndim == 3:
            out = [self.solve(u0, r, name=nm) for u0, r, nm in zip(u0s, rhss, names)]
            return [u for u, _ in out], [i for _, i in out]
        vc_tol, ex_tol, nmax, nmax_exact = self._limits()
        stack = [torch.as_tensor(a, dtype=self.outer_dtype, device=self.device)
                 for a in u0s]
        u = self._split(torch.stack(stack), "u0", lanes=1)
        rhs = self._split(torch.stack([torch.as_tensor(a, dtype=self.outer_dtype,
                                                       device=self.device) for a in rhss]),
                          "rhs", lanes=1)
        t0 = time.perf_counter()
        u, du, it, ierr, flag = self._loop(u, rhs, vc_tol, ex_tol, nmax, nmax_exact)
        u = C.unshard(u, self.devices, 1, self.grid)
        self._sync()
        wall = time.perf_counter() - t0
        infos = [
            SolveInfo(ierr=int(ierr[k]), du_last=float(du[k]), cycles=int(it[k]),
                      name=names[k], wall_time=wall, coarse_noconv=bool(flag[k]),
                      batch_size=len(u0s))
            for k in range(len(u0s))
        ]
        PoissonBVP._post_warnings(infos)
        return list(u.unbind(0)), infos


# ----------------------------------------------------------------------
# One level on its own (JAX make_sharded_sweep / make_sharded_residual):
# the plain sharded sweep and residual of ShardStencil, axis 0 partitioned
# over one mesh axis.
# ----------------------------------------------------------------------


def _single_level(global_shape, bcs, dq, mesh: Mesh, axis_name: str, dtype):
    shape = tuple(int(n) for n in global_shape)
    ops = ShardStencil([shape], [dq], bcs, mesh, (axis_name,))
    if shape[0] % ops.grid[0]:
        raise ValueError(f"axis 0 ({shape[0]}) must divide over {ops.grid[0]} devices")

    def place(x) -> List[torch.Tensor]:
        """An array of ``global_shape`` as the mesh's blocks (``dtype``)."""
        t = torch.as_tensor(x, dtype=dtype, device=ops.device)
        if tuple(t.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
        return C.shard(t, ops.devices, 0)

    return ops, place


def make_sharded_sweep(global_shape, bcs, dq, mesh: Mesh, axis_name: str = "z",
                       dtype=torch.float32):
    """A red-black sweep over arrays block-partitioned along axis 0 of
    ``mesh``, with the semantics of ``ops.stencils.rb_sweep`` (the global
    mean subtracted on an all-Neumann box).  Returns ``(f, place)``:
    ``f(u_blocks, rhs_blocks) -> u_blocks`` and ``place(x)``, the blocks of
    an array of ``global_shape`` on the mesh; ``collectives.unshard``
    gathers them."""
    ops, place = _single_level(global_shape, bcs, dq, mesh, axis_name, dtype)
    return (lambda u, rhs: ops._sh_sweep(list(u), list(rhs), 0)), place


def make_sharded_residual(global_shape, bcs, dq, mesh: Mesh, axis_name: str = "z",
                          dtype=torch.float32):
    """The residual ``rhs - L[u]`` over arrays block-partitioned along axis 0
    of ``mesh`` (one boundary-plane exchange), as ``make_sharded_sweep``."""
    ops, place = _single_level(global_shape, bcs, dq, mesh, axis_name, dtype)
    return (lambda u, rhs: ops._sh_residual(list(u), list(rhs), 0)), place
