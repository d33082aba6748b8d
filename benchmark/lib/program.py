"""The program's own registry of spans and counters
(``ndsm_tpu_torch.utils.profiling``), read per call: each public call
(``vector_potential``, ``solve_poisson_bvp``) leaves a record of the spans
and counters that moved in it, ``{name: (count, inclusive s, self s)}``.
A run's calls come in order: warm-up, the window, the traced calls; the
window's records are the ``len(run["walls"])`` just before the last
``len(run["traced_calls"])``.  A program without the registry, or a ring
that holds too few records, gives None."""

from __future__ import annotations

from typing import List, Optional


def window_calls(run) -> Optional[List[dict]]:
    """The per-call records of the run's window, or None."""
    try:
        from ndsm_tpu_torch.utils import profiling

        recs = profiling.calls()
    except (ImportError, AttributeError):
        return None
    n, t = len(run["walls"]), len(run["traced_calls"])
    if n == 0 or len(recs) < n + t:
        return None
    return recs[len(recs) - t - n: len(recs) - t]


def mean(run, name: str, field: int, absent_is_zero: bool = False) -> Optional[float]:
    """The mean over the window's calls of field ``field`` (0 the count, 1
    the inclusive seconds, 2 the self seconds) of ``name``; None where no
    window call has it, unless ``absent_is_zero`` (a counter that reads 0
    when nothing happened)."""
    recs = window_calls(run)
    if recs is None:
        return None
    vals = [r["stats"][name][field] for r in recs if name in r["stats"]]
    if not vals and not absent_is_zero:
        return None
    return float(sum(vals)) / len(recs)
