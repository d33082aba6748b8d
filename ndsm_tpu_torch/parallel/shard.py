"""Device meshes and the distribution request (port of
``ndsm_tpu/parallel/shard.py``: ``make_mesh``, ``make_mesh_nd`` and
``DistConfig``).

JAX's ``shard_map`` is single-controller: one process drives every device
of the mesh.  The port keeps that model.  A ``Mesh`` is an ordered tuple of
``torch.device``s with named axes; the sharded engine
(``parallel/sm_engine.py``) holds one block per mesh position, each on its
device, and moves edge planes between them (``parallel/collectives.py``).

A mesh position is a flat index into ``devices`` (row-major over
``shape``, as JAX's ``Mesh.devices``) or its coordinates, one per mesh
axis (``coords`` / ``index``).  The positions that share every coordinate
but one form a *line* along that axis (``lines``): the chain over which a
halo exchange of that axis runs.  ``submesh`` takes some of the axes, at
index 0 of the others: what an engine partitioning fewer array axes than
the mesh has runs on (the replicated axes' other positions hold copies,
which the single controller does not compute).

Shards share a device only when the caller says so by passing the devices,
e.g. ``make_mesh(4, devices=["cuda:0"] * 4)`` (four shards on one card) or
``devices=["cpu"] * 8`` (the counterpart of JAX's virtual CPU devices).
``make_mesh(n)`` alone takes the first ``n`` CUDA devices and raises when
there are fewer: nothing picks the CPU or shrinks the mesh on its own.

The GSPMD path's ``ShardSpec`` is not ported (ROADMAP.md Queue A).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "DistConfig", "make_mesh", "make_mesh_nd"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named device mesh: ``devices`` in row-major order over ``shape``,
    one name per mesh axis."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"mesh axes {self.axis_names} do not match shape {self.shape}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axis names repeat: {self.axis_names}")
        if int(np.prod(self.shape)) != len(self.devices) or min(self.shape, default=0) < 1:
            raise ValueError(f"{len(self.devices)} devices do not fill a mesh of shape "
                             f"{self.shape}")

    def axis(self, name: str) -> int:
        """The position of mesh axis ``name``; ValueError if there is none."""
        if name not in self.axis_names:
            raise ValueError(f"the mesh has no axis {name!r} (its axes: {self.axis_names})")
        return self.axis_names.index(name)

    def coords(self, i: int) -> Tuple[int, ...]:
        """The coordinates of flat position ``i``."""
        return tuple(int(c) for c in np.unravel_index(i, self.shape))

    def index(self, coords: Sequence[int]) -> int:
        """The flat position of ``coords``."""
        return int(np.ravel_multi_index(tuple(coords), self.shape))

    def lines(self, name: str) -> List[List[int]]:
        """The flat positions of every line along axis ``name``, each in
        increasing coordinate, lines in row-major order of the others."""
        ax = self.axis(name)
        grid = np.arange(len(self.devices)).reshape(self.shape)
        rows = np.moveaxis(grid, ax, -1).reshape(-1, self.shape[ax])
        return [list(map(int, row)) for row in rows]

    def submesh(self, names: Sequence[str]) -> "Mesh":
        """The mesh of axes ``names`` (in that order), taken at index 0 of
        every other axis."""
        axes = [self.axis(nm) for nm in names]
        if len(set(axes)) != len(axes):
            raise ValueError(f"axis names repeat: {tuple(names)}")
        grid = np.arange(len(self.devices)).reshape(self.shape)
        sub = grid[tuple(slice(None) if a in axes else 0 for a in range(len(self.shape)))]
        # the kept axes in mesh order; put them in the order of ``names``
        kept = sorted(axes)
        sub = np.transpose(sub, [kept.index(a) for a in axes])
        return Mesh(tuple(self.devices[int(i)] for i in sub.reshape(-1)), tuple(names),
                    tuple(self.shape[a] for a in axes))


def _devices(n: int, devices) -> Tuple[torch.device, ...]:
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a mesh of {n} devices needs {n} CUDA devices, torch sees {have}; "
                "pass devices=... to place several shards on one device"
            )
        return tuple(torch.device("cuda", i) for i in range(n))
    devs = tuple(torch.device(d) for d in devices)
    if len(devs) != n:
        raise ValueError(f"a mesh of {n} devices got {len(devs)} devices")
    return devs


def make_mesh(n_devices: int, axis_name: str = "z", devices=None) -> Mesh:
    """1-D mesh of ``n_devices`` shards: the first ``n_devices`` CUDA
    devices, or ``devices`` (which may repeat a device)."""
    n = int(n_devices)
    return Mesh(_devices(n, devices), (axis_name,), (n,))


def make_mesh_nd(shape: Sequence[int], axis_names: Sequence[str] = ("z", "y"),
                 devices=None) -> Mesh:
    """N-D mesh, e.g. ``make_mesh_nd((4, 2))`` for a 4 x 2 (z, y) layout."""
    shape = tuple(int(s) for s in shape)
    return Mesh(_devices(int(np.prod(shape)), devices), tuple(axis_names), shape)


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Distribution request for the pipelines: run every sub-solve on the
    sharded engine over ``mesh`` with the leading array axes partitioned
    per ``axis_names`` (a sub-problem of fewer dimensions takes the leading
    names, e.g. the 2D chi faces ``("z",)`` of a ``("z", "y")`` request; a
    sub-problem whose shapes cannot be partitioned runs on one device).
    Hashable, so it can key solver caches."""

    mesh: Mesh
    axis_names: Tuple[str, ...] = ("z",)
    min_rows_per_shard: int = 4

    def __hash__(self):
        return hash((self.mesh, tuple(self.axis_names), self.min_rows_per_shard))
