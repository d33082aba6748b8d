"""The one traffic generator: reads a mix's parameters (a ``traffic/<mix>.json``
file) and makes, from ``--seed`` alone, each size's pool of inputs and the
order of the calls.

Parameters of a mix:

  sizes            the box sizes (points an axis) the calls cycle through
  pool_per_size    distinct inputs made at set-up for each size
  warm_calls       untimed calls of each size before the window
  check_per_size   calls of each size whose answers are checked, drawn
                   from the window by a seeded reservoir
  trace_calls      whole calls under the profiler in a ``--trace 1`` run
  field            how an input is made (``kind`` and its parameters)

Every seed gets the same sizes and the same wave-number catalogue: the
seed orders the sizes, deals the catalogue out to the pool's members and
draws each mode's phases and amplitude, so the work of a window does not
depend on the seed beyond what the solver's cycle counts make of it.

The configuration's ``mesh`` names ``meshes/<mesh>.py`` (``mesh(n) -> (x,
y, z)``) and the mix's ``field.kind`` names ``fields/<kind>.py``
(``make(n, mesh, rng, field, count) -> [args, ...]``, each ``args`` the
keyword inputs of one call); a new mesh or kind is a new file.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np

from . import spec


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator of ``seed`` (any integer) and a stream number."""
    return np.random.default_rng([int(seed) % 2**64, *stream])


@dataclasses.dataclass
class Input:
    size: int
    member: int
    args: dict


class Traffic:
    """A mix's pools and call order for one seed."""

    def __init__(self, mix: dict, config: dict, seed: int):
        self.mix = mix
        self.sizes: Tuple[int, ...] = tuple(int(n) for n in mix["sizes"])
        order = rng_for(seed, 0).permutation(len(self.sizes))
        self.order = tuple(self.sizes[i] for i in order)
        mesh_of = spec.load("meshes", config["mesh"]).mesh
        make = spec.load("fields", mix["field"]["kind"]).make
        count = int(mix["pool_per_size"])
        self.pools: Dict[int, List[Input]] = {}
        for n in self.sizes:
            members = make(n, mesh_of(n), rng_for(seed, 1, n), mix["field"], count)
            self.pools[n] = [Input(n, j, args) for j, args in enumerate(members)]

    def calls(self) -> Iterator[Input]:
        """The calls of the window, without end: the sizes round-robin in the
        seeded order, each size's pool cycled."""
        seen = {n: 0 for n in self.sizes}
        while True:
            for n in self.order:
                pool = self.pools[n]
                yield pool[seen[n] % len(pool)]
                seen[n] += 1
