"""Collectives of the single-controller shard mesh (the counterparts of the
``lax.ppermute``, ``psum``, ``pmax`` and ``all_gather`` calls of
``ndsm_tpu/parallel/sm_engine.py``).

A sharded array is a list of blocks, block ``i`` on ``devices[i]``, cut
along one array axis (``axis``; leading lane axes come before it) or, on
a mesh of two partitioned axes, along ``axis`` and ``axis + 1`` (``grid``
= the mesh shape; blocks in row-major order, as the mesh's positions).  A
chain operation (``exchange_planes``, ``edge_planes``, ``extend_block``,
``exchange_halo``) runs along one mesh axis: independently on each of its
``lines`` (``Mesh.lines``; None = one chain over every block).  A
replicated array is one tensor on ``devices[0]``, the root: replicated
levels are computed once there instead of once per device, so the seam's
all-gather goes to the root only, and the slice after it is a scatter from
the root.  ``psum`` and ``pmax`` reduce over every block in mesh order, on
the root.

Every block that goes from one mesh position to another is one message:
``COUNTS`` adds one message and the block's bytes, whether or not the two
positions share a device (the counterpart of the kernels' launch
counters).  Copies are ``Tensor.to(device, non_blocking=True)``: device
to device, no host synchronisation.  ``shard`` and ``unshard`` place a
solve's inputs and gather its result, like JAX's ``put_global`` /
``device_get``, and are not counted.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "COUNTS", "counts", "reset_counts", "exchange_planes", "edge_planes",
    "extend_block", "unextend_block", "exchange_halo", "psum", "pmax",
    "broadcast", "all_gather", "scatter", "shard", "unshard",
]

Blocks = List[torch.Tensor]

#: Messages and bytes moved between mesh positions since the last reset.
COUNTS = {"messages": 0, "bytes": 0}


def counts() -> dict:
    return dict(COUNTS)


def reset_counts() -> None:
    COUNTS["messages"] = 0
    COUNTS["bytes"] = 0


def _send(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    COUNTS["messages"] += 1
    COUNTS["bytes"] += t.numel() * t.element_size()
    return t.to(device, non_blocking=True)


def _chains(n: int, lines) -> List[List[int]]:
    return [list(range(n))] if lines is None else [list(line) for line in lines]


def exchange_planes(blocks: Blocks, devices, axis: int, depth: int = 1, lines=None
                    ) -> Tuple[List[Optional[torch.Tensor]], List[Optional[torch.Tensor]]]:
    """(from_prev, from_next): along each line, block i gets the last
    ``depth`` planes of the block before it and the first ``depth`` of the
    block after it; None beyond the line's ends.  2 (n - 1) messages a
    line of n blocks."""
    from_prev: List[Optional[torch.Tensor]] = [None] * len(blocks)
    from_next: List[Optional[torch.Tensor]] = [None] * len(blocks)
    for line in _chains(len(blocks), lines):
        for a, b in zip(line[:-1], line[1:]):
            v = blocks[a]
            from_prev[b] = _send(v.narrow(axis, v.shape[axis] - depth, depth), devices[b])
        for a, b in zip(line[:-1], line[1:]):
            from_next[a] = _send(blocks[b].narrow(axis, 0, depth), devices[a])
    return from_prev, from_next


def edge_planes(blocks: Blocks, devices, axis: int, depth: int, lines=None
                ) -> Tuple[Blocks, Blocks]:
    """(lo, hi) halo slabs of depth ``depth``: the neighbours' planes inside
    a line, node-mirror planes at its ends (``ext[-k] = v[k]``,
    ``ext[n-1+k] = v[n-1-k]``: the index reflection of a Neumann face,
    with the same red-black parity).  The mirror needs ``depth + 1``
    planes of the block."""
    n = blocks[0].shape[axis]
    if n < depth + 1:
        raise ValueError(f"a halo of depth {depth} needs blocks of >= {depth + 1} planes, "
                         f"got {n}")
    from_prev, from_next = exchange_planes(blocks, devices, axis, depth, lines)
    lo = [p if p is not None else b.narrow(axis, 1, depth).flip(axis)
          for p, b in zip(from_prev, blocks)]
    hi = [q if q is not None else b.narrow(axis, n - depth - 1, depth).flip(axis)
          for q, b in zip(from_next, blocks)]
    return lo, hi


def extend_block(blocks: Blocks, devices, axis: int, depth: int, lines=None) -> Blocks:
    """Each block extended by ``depth`` planes on both sides of ``axis``
    (see ``edge_planes`` for the halo content).  On a mesh of two
    partitioned axes the engine extends z first, then y on the z-extended
    blocks, so that the corner regions hold the diagonal neighbours'
    values (or their mirrors): the index reflection of the whole level."""
    if depth == 0:
        return list(blocks)
    lo, hi = edge_planes(blocks, devices, axis, depth, lines)
    return [torch.cat([a, b, c], dim=axis) for a, b, c in zip(lo, blocks, hi)]


def unextend_block(blocks: Blocks, axis: int, depth: int) -> Blocks:
    """The real blocks of extended ones (views)."""
    return [b.narrow(axis, depth, b.shape[axis] - 2 * depth) for b in blocks]


def exchange_halo(blocks: Blocks, devices, axis: int, depth: int, lines=None) -> Blocks:
    """Each block extended by its line neighbours' ``depth`` planes, zeros
    beyond the line's ends (the halo of the per-shard transfer blocks)."""
    if depth == 0:
        return list(blocks)
    from_prev, from_next = exchange_planes(blocks, devices, axis, depth, lines)

    def edge(p, b):
        return p if p is not None else torch.zeros_like(b.narrow(axis, 0, depth))

    return [torch.cat([edge(p, b), b, edge(q, b)], dim=axis)
            for p, b, q in zip(from_prev, blocks, from_next)]


def psum(values: Sequence[torch.Tensor], devices) -> torch.Tensor:
    """Sum over the shards, in mesh order, on the root."""
    acc = values[0]
    for v in values[1:]:
        acc = acc + _send(v, devices[0])
    return acc


def pmax(values: Sequence[torch.Tensor], devices) -> torch.Tensor:
    """Elementwise max over the shards (NaN-propagating), on the root."""
    acc = values[0]
    for v in values[1:]:
        acc = torch.maximum(acc, _send(v, devices[0]))
    return acc


def broadcast(value: torch.Tensor, devices) -> Blocks:
    """A root value on every mesh position."""
    return [value] + [_send(value, d) for d in devices[1:]]


def _grid(devices, grid) -> Tuple[int, ...]:
    return (len(devices),) if grid is None else tuple(int(g) for g in grid)


def _cut(full: torch.Tensor, axis: int, grid, i: int) -> torch.Tensor:
    """Block i (row-major over ``grid``) of ``full`` cut along the axes
    ``axis``, ``axis + 1``, ... into ``grid`` equal parts."""
    for k, (c, g) in enumerate(zip(np.unravel_index(i, grid), grid)):
        blk = full.shape[axis + k] // g
        full = full.narrow(axis + k, int(c) * blk, blk)
    return full


def _join(blocks: Blocks, axis: int, grid) -> torch.Tensor:
    """The inverse of ``_cut``: blocks in row-major order over ``grid``."""
    if len(grid) == 1:
        return torch.cat(blocks, dim=axis)
    inner = int(np.prod(grid[1:]))
    return torch.cat([_join(blocks[i * inner:(i + 1) * inner], axis + 1, grid[1:])
                      for i in range(grid[0])], dim=axis)


def all_gather(blocks: Blocks, devices, axis: int, grid=None) -> torch.Tensor:
    """The blocks joined on the root: along ``axis`` alone, or, with the
    mesh shape ``grid`` of the partitioned axes, along ``axis``,
    ``axis + 1``, ..."""
    grid = _grid(devices, grid)
    return _join([blocks[0]] + [_send(b, devices[0]) for b in blocks[1:]], axis, grid)


def scatter(full: torch.Tensor, devices, axis: int, grid=None) -> Blocks:
    """A root array cut into equal blocks (as ``all_gather`` joins them),
    block i sent to mesh position i."""
    grid = _grid(devices, grid)
    return [_cut(full, axis, grid, 0).contiguous()] + [
        _send(_cut(full, axis, grid, i), d).contiguous()
        for i, d in enumerate(devices[1:], start=1)
    ]


def shard(full: torch.Tensor, devices, axis: int, grid=None) -> Blocks:
    """Place an array on the mesh (uncounted: a solve's input)."""
    grid = _grid(devices, grid)
    return [_cut(full, axis, grid, i).to(d).contiguous() for i, d in enumerate(devices)]


def unshard(blocks: Blocks, devices, axis: int, grid=None) -> torch.Tensor:
    """Gather a sharded array on the root (uncounted: a solve's result)."""
    return _join([b.to(devices[0]) for b in blocks], axis, _grid(devices, grid))
