"""Distributed solves on a single-controller shard mesh (port of
``ndsm_tpu/parallel``): ``shard`` (meshes, ``DistConfig``),
``collectives`` (edge-plane exchanges and reductions between the blocks of
a sharded array) and ``sm_engine`` (``ShardedPoissonBVP``)."""

from .shard import DistConfig, Mesh, make_mesh, make_mesh_nd
from .sm_engine import ShardedPoissonBVP

__all__ = ["DistConfig", "Mesh", "make_mesh", "make_mesh_nd", "ShardedPoissonBVP"]
