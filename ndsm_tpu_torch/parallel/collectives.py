"""Collectives of the single-controller shard mesh (the counterparts of the
``lax.ppermute``, ``psum``, ``pmax`` and ``all_gather`` calls of
``ndsm_tpu/parallel/sm_engine.py``).

A sharded array is a list of blocks, block ``i`` on ``devices[i]``, cut
along one array axis (``axis``; leading lane axes come before it).  A
replicated array is one tensor on ``devices[0]``, the root: replicated
levels are computed once there instead of once per device, so the seam's
all-gather goes to the root only, and the slice after it is a scatter from
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


def exchange_planes(blocks: Blocks, devices, axis: int, depth: int = 1
                    ) -> Tuple[List[Optional[torch.Tensor]], List[Optional[torch.Tensor]]]:
    """(from_prev, from_next): block i gets the last ``depth`` planes of
    block i-1 and the first ``depth`` of block i+1; None beyond the chain
    ends.  2 (n - 1) messages."""
    from_prev = [None] + [
        _send(b.narrow(axis, b.shape[axis] - depth, depth), devices[i + 1])
        for i, b in enumerate(blocks[:-1])
    ]
    from_next = [_send(b.narrow(axis, 0, depth), devices[i])
                 for i, b in enumerate(blocks[1:])] + [None]
    return from_prev, from_next


def edge_planes(blocks: Blocks, devices, axis: int, depth: int) -> Tuple[Blocks, Blocks]:
    """(lo, hi) halo slabs of depth ``depth``: the neighbours' planes inside
    the chain, node-mirror planes at its ends (``ext[-k] = v[k]``,
    ``ext[n-1+k] = v[n-1-k]``: the index reflection of a Neumann face,
    with the same red-black parity).  The mirror needs ``depth + 1``
    planes of the block."""
    n = blocks[0].shape[axis]
    if n < depth + 1:
        raise ValueError(f"a halo of depth {depth} needs blocks of >= {depth + 1} planes, "
                         f"got {n}")
    from_prev, from_next = exchange_planes(blocks, devices, axis, depth)
    lo = [p if p is not None else b.narrow(axis, 1, depth).flip(axis)
          for p, b in zip(from_prev, blocks)]
    hi = [q if q is not None else b.narrow(axis, n - depth - 1, depth).flip(axis)
          for q, b in zip(from_next, blocks)]
    return lo, hi


def extend_block(blocks: Blocks, devices, axis: int, depth: int) -> Blocks:
    """Each block extended by ``depth`` planes on both sides of ``axis``
    (see ``edge_planes`` for the halo content)."""
    if depth == 0:
        return list(blocks)
    lo, hi = edge_planes(blocks, devices, axis, depth)
    return [torch.cat([a, b, c], dim=axis) for a, b, c in zip(lo, blocks, hi)]


def unextend_block(blocks: Blocks, axis: int, depth: int) -> Blocks:
    """The real blocks of extended ones (views)."""
    return [b.narrow(axis, depth, b.shape[axis] - 2 * depth) for b in blocks]


def exchange_halo(blocks: Blocks, devices, axis: int, depth: int) -> Blocks:
    """Each block extended by its neighbours' ``depth`` planes, zeros
    beyond the chain ends (the halo of the per-shard transfer blocks)."""
    if depth == 0:
        return list(blocks)
    from_prev, from_next = exchange_planes(blocks, devices, axis, depth)

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


def all_gather(blocks: Blocks, devices, axis: int) -> torch.Tensor:
    """The blocks concatenated along ``axis`` on the root."""
    return torch.cat([blocks[0]] + [_send(b, devices[0]) for b in blocks[1:]], dim=axis)


def scatter(full: torch.Tensor, devices, axis: int) -> Blocks:
    """A root array cut into equal blocks along ``axis``, block i sent to
    mesh position i."""
    blk = full.shape[axis] // len(devices)
    return [full.narrow(axis, 0, blk).contiguous()] + [
        _send(full.narrow(axis, i * blk, blk), d).contiguous()
        for i, d in enumerate(devices[1:], start=1)
    ]


def shard(full: torch.Tensor, devices, axis: int) -> Blocks:
    """Place an array on the mesh (uncounted: a solve's input)."""
    blk = full.shape[axis] // len(devices)
    return [full.narrow(axis, i * blk, blk).to(d).contiguous() for i, d in enumerate(devices)]


def unshard(blocks: Blocks, devices, axis: int) -> torch.Tensor:
    """Gather a sharded array on the root (uncounted: a solve's result)."""
    return torch.cat([b.to(devices[0]) for b in blocks], dim=axis)
