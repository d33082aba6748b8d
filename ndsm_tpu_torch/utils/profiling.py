"""Profiling and phase-timing helpers (port of ``ndsm_tpu/utils/profiling.py``).

The reference's only instrumentation is one wall-clock timer around the
whole solve (ndsm_root.f90:521-536).  Every sub-solve reports its wall
time, cycles and last du in ``SolveInfo``; this module adds an opt-in
``torch.profiler`` trace of a block (CPU and, where there is a card, CUDA
activity, written as a Chrome trace that Perfetto and TensorBoard read)
and an accumulating phase timer.  The pipeline's ``record_function``
ranges (``ndsm.chi_phase``, ``ndsm.solve3d_phase``) appear in the trace.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch

__all__ = ["trace", "Timer"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block and write its Chrome trace into
    ``log_dir`` (``<host>_<pid>.<time>.pt.trace.json``).  Records CPU
    activity, and CUDA activity when ``torch.cuda.is_available()``.
    Yields the profiler, whose ``key_averages()`` the caller may read.

    Example:
        with ndsm_tpu_torch.utils.profiling.trace("ndsm-trace"):
            vector_potential(x, y, z, b)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


class Timer:
    """Accumulating named phase timer.

    Example:
        t = Timer()
        with t.phase("smooth", sync=u):
            u = smooth(u)
        print(t.report())
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[object] = None):
        """Time the enclosed block.  ``sync`` is a tensor or a sequence of
        tensors: before the clock is read, the device of each CUDA tensor
        among them is synchronised, so the phase holds the device work it
        queued."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                for t in (sync,) if isinstance(sync, torch.Tensor) else sync:
                    if isinstance(t, torch.Tensor) and t.is_cuda:
                        torch.cuda.synchronize(t.device)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [
            f"{name}: {total:.4f}s / {self.counts[name]} calls"
            for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)
