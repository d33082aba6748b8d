"""Bounded LRU cache for engine/solver handles.

The reference allocates and frees an MG_HANDLE per solve
(ndsm_vector_potential.f90:352-363); here handles are cached for reuse of
their compiled programs, so a long-lived process solving many distinct
shapes needs an eviction policy to avoid unbounded growth of engines,
transfer matrices and pinned executables.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable, Optional

__all__ = ["BoundedCache"]


class BoundedCache:
    """A minimal LRU mapping: ``get`` refreshes recency, ``put`` evicts the
    least-recently-used entry once ``maxsize`` is exceeded."""

    def __init__(self, maxsize: int = 64):
        self.maxsize = int(maxsize)
        self._d: "OrderedDict[Hashable, Any]" = OrderedDict()

    def get(self, key: Hashable) -> Optional[Any]:
        try:
            self._d.move_to_end(key)
            return self._d[key]
        except KeyError:
            return None

    def put(self, key: Hashable, value: Any) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)

    def clear(self) -> None:
        self._d.clear()
