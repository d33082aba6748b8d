"""The import guard: the run's process may hold no JAX and no JAX package.
Modules are compared by their top-level name taken whole (the part before
the first dot), so ``ndsm_tpu_torch`` is not ``ndsm_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "ndsm_tpu")


def found() -> list:
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def check() -> None:
    """Exit non-zero, naming what was found, if a forbidden module is loaded."""
    bad = found()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr, flush=True)
        raise SystemExit(3)
