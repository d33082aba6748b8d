"""Bounded LRU cache for engine/solver handles.

The reference allocates and frees an MG_HANDLE per solve
(ndsm_vector_potential.f90:352-363); here handles are cached for reuse of
their compiled programs, so a long-lived process solving many distinct
shapes needs an eviction policy to avoid unbounded growth of engines,
transfer matrices and pinned executables.

A miss on a key that the cache had evicted adds one to the registry's
``ndsm.rebuild`` counter (utils/profiling.py): the entry is about to be
built again.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable, Optional

from . import profiling

__all__ = ["BoundedCache"]

#: Evicted keys remembered (their hashes), a multiple of ``maxsize``.
_GONE_PER_SLOT = 4


class BoundedCache:
    """A minimal LRU mapping: ``get`` refreshes recency, ``put`` evicts the
    least-recently-used entry once ``maxsize`` is exceeded."""

    def __init__(self, maxsize: int = 64):
        self.maxsize = int(maxsize)
        self._d: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._gone: dict = {}  # hashes of evicted keys, oldest first

    def get(self, key: Hashable) -> Optional[Any]:
        try:
            self._d.move_to_end(key)
            return self._d[key]
        except KeyError:
            if self._gone and hash(key) in self._gone:
                profiling.count(profiling.REBUILD)
            return None

    def put(self, key: Hashable, value: Any) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        if self._gone:
            self._gone.pop(hash(key), None)
        while len(self._d) > self.maxsize:
            old, _ = self._d.popitem(last=False)
            self._gone[hash(old)] = None
            if len(self._gone) > _GONE_PER_SLOT * self.maxsize:
                del self._gone[next(iter(self._gone))]

    def __len__(self) -> int:
        return len(self._d)

    def clear(self) -> None:
        self._d.clear()
        self._gone.clear()
