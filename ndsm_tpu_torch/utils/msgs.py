"""Host-side diagnostic message formatting.

The reference emits ``ERROR(sub):msg:eid`` / ``DEBUG(sub):msg`` lines to
ERROR_UNIT (fortran/ndsm_root.f90:476-503) and convergence warnings via
bare ``PRINT *`` (ndsm_poisson.f90:149; ndsm_multigrid_core.f90:797).
These helpers reproduce that observable behavior from the Python host —
they run after device results are fetched, so they work identically on
every platform (including runtimes without host-callback support, where
the previous in-graph ``jax.debug.print`` warnings were silently lost).
"""

from __future__ import annotations

import contextlib
import sys

__all__ = ["warn", "debug_msg", "error_msg", "suppress_warnings"]

_suppressed = False


@contextlib.contextmanager
def suppress_warnings():
    """Silence :func:`warn` inside the block.  For callers that run
    solves with deliberately unreachable tolerances (dryruns, smoke
    tests cap ncycles_max), where the reference's non-convergence
    warnings are expected noise rather than a diagnostic."""
    global _suppressed
    prev, _suppressed = _suppressed, True
    try:
        yield
    finally:
        _suppressed = prev


def warn(msg: str) -> None:
    """Bare warning line (reference: ``PRINT *``, ndsm_poisson.f90:149)."""
    if not _suppressed:
        print(msg, file=sys.stderr, flush=True)


def debug_msg(sub: str, msg: str) -> None:
    """``DEBUG(sub):msg`` trace line (reference: debug_msg,
    ndsm_root.f90:493-503)."""
    print(f"DEBUG({sub}):{msg}", file=sys.stderr, flush=True)


def error_msg(sub: str, msg: str, eid: int = 0) -> None:
    """``ERROR(sub):msg:eid`` line (reference: error_msg,
    ndsm_root.f90:476-491)."""
    print(f"ERROR({sub}):{msg}:{eid}", file=sys.stderr, flush=True)
