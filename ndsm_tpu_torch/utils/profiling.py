"""Profiling and phase-timing helpers (port of ``ndsm_tpu/utils/profiling.py``),
and the port's one registry of spans and counters.

The reference's only instrumentation is one wall-clock timer around the
whole solve (ndsm_root.f90:521-536).  Every sub-solve reports its wall
time, cycles and last du in ``SolveInfo``; this module adds an opt-in
``torch.profiler`` trace of a block (CPU and, where there is a card, CUDA
activity, written as a Chrome trace that Perfetto and TensorBoard read),
an accumulating phase timer, and the registry.

The registry (in memory; nothing is written out):

  * ``span(name)``: a context manager that adds one to the span's count
    and its host-clock seconds, inclusive and self (net of the spans
    nested in it, per thread).  While a profiler records it also opens
    ``torch.profiler.record_function(name)``, for the names in
    ``RANGES`` (and ``DETAIL_RANGES`` under ``trace(detail=True)``); with
    no profiler recording it reads one flag and never enters the
    dispatcher;
  * ``host_read(fn, *args)``: ``fn(*args)`` inside the ``ndsm.sync`` span;
  * ``count(name, n=1)``: adds ``n`` to a counter (the kernel wrappers'
    launch counters, ``ops.launch_counts()`` and its siblings, are views
    of these);
  * ``call(entry)``: delimits one public call (``vector_potential``,
    ``solve_poisson_bvp``; a nested entry opens none).  When it closes,
    even by an exception, the call's record joins ``calls()``, the last
    ``CALLS_KEPT`` records in order: ``{"index", "entry", "wall_s",
    "raised", "stats"}``, ``stats`` holding ``{name: (count, inclusive s,
    self s)}`` of every span and counter that moved in the call (a
    counter's seconds are 0);
  * ``withheld(prefixes)``: the counters with those prefixes that moved
    inside the block, taken back out of the totals and the open call (a
    graph capture's launches, which run only when it is replayed);
  * ``stats()``, ``counter(name)`` read the totals since the last
    ``reset()``.

The spans and counters of the program:

  ==================  =====================================================
  ``ndsm.upload``     host inputs copied to the device (``PoissonBVP``)
  ``ndsm.fetch``      A and B copied to the host (``api.vector_potential``)
  ``ndsm.faces_phase``, ``ndsm.chi_phase``, ``ndsm.solve3d_phase``,
  ``ndsm.post_phase`` the pipeline's phases
  ``ndsm.sync``       one host read of a device value, or one explicit
                      synchronise: the read alone, no reduction before it
  ``ndsm.vcycle``     the host issuing one V-cycle: its ops one by one, or
                      the replay of its captured graph (mg/graphs.py)
  ``ndsm.graph.captures``, ``ndsm.graph.replays``, ``ndsm.graph.failed``
                      counters: V-cycle graphs captured (one an engine and
                      lane shape, in ``ndsm.build``), replayed, and whose
                      capture raised (that key then runs eagerly)
  ``ndsm.build``      an engine, solver, handle or mask built on a cache miss
  ``ndsm.rebuild``    counter: a miss on a key the cache had evicted
  ``ndsm.fetch.chunks``, ``ndsm.fetch.bytes``
                      counters: the chunks and bytes of A and B that went
                      through the pinned ring (``api.to_host``)
  ``ndsm.fetch.ring_builds``
                      counter: pinned rings built (one a device a process)
  ``ndsm.fetch.recycled``
                      counter: host buffers of A and B taken from the pool
                      of freed ones, already paged in (``api.page_in``)
  ``ndsm.op.relax``, ``ndsm.op.residual``
                      ``MGEngine`` calling an injected operator's ``relax``
                      or ``residual`` (none without an operator)
  ``ndsm.op.terms``   counter: a level's face terms built
                      (``DiffusionOperator``, on a miss of its cache)
  ``ndsm.op.coarse_build``
                      ``DiffusionOperator.coarse_matrix`` assembling its
                      dense coarse matrix
                      (``coarse.build_coarse_matrix_from_operator``)
  ``ndsm.hostcurl``   ``Options.host_curl``'s copy of A and curl on the
                      host, the whole of ``_fetch_and_curl``; nested in it
                      ``ndsm.hostcurl.encode`` (split16 on the device, with
                      its read of the scale), ``ndsm.hostcurl.fetch`` (the
                      first slab's wait until every slab is on the host and
                      rebuilt) and ``ndsm.hostcurl.curl`` (the wait on the
                      curls left after the last slab); all on the calling
                      thread, none in the pool's
  ``ndsm.hostcurl.slabs``, ``ndsm.hostcurl.wire_bytes``,
  ``ndsm.hostcurl.fresh_bytes``
                      counters: the slab copies enqueued, the bytes that
                      crossed (6 a point under split16), and the bytes of
                      host arrays allocated fresh for A and B
  ==================  =====================================================

Only the ranges in ``RANGES`` reach a profiler by default: each lies
outside the solve phases or encloses no kernel (the ``ndsm.hostcurl``
spans, after the phases, enclose only split16's kernels and the slab
copies), so a trace that gives a kernel to its innermost range still
gives every solve kernel to ``ndsm.chi_phase`` or ``ndsm.solve3d_phase``.
``ndsm.vcycle``, ``ndsm.build`` and the ``ndsm.op.*`` spans enclose
kernels inside those phases and open ranges only under
``trace(log_dir, detail=True)``.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Iterator, Optional

import torch
import torch.autograd.profiler as _ap

__all__ = ["trace", "Timer", "span", "count", "withheld", "host_read", "call", "calls",
           "stats", "counter", "reset"]

UPLOAD = "ndsm.upload"
FETCH = "ndsm.fetch"
FACES = "ndsm.faces_phase"
CHI = "ndsm.chi_phase"
SOLVE3D = "ndsm.solve3d_phase"
POST = "ndsm.post_phase"
SYNC = "ndsm.sync"
VCYCLE = "ndsm.vcycle"
BUILD = "ndsm.build"
REBUILD = "ndsm.rebuild"
FETCH_CHUNKS = "ndsm.fetch.chunks"
FETCH_BYTES = "ndsm.fetch.bytes"
FETCH_RING_BUILDS = "ndsm.fetch.ring_builds"
FETCH_RECYCLED = "ndsm.fetch.recycled"
OP_RELAX = "ndsm.op.relax"
OP_RESIDUAL = "ndsm.op.residual"
OP_TERMS = "ndsm.op.terms"
OP_COARSE_BUILD = "ndsm.op.coarse_build"
GRAPH_CAPTURES = "ndsm.graph.captures"
GRAPH_REPLAYS = "ndsm.graph.replays"
GRAPH_FAILED = "ndsm.graph.failed"
HOSTCURL = "ndsm.hostcurl"
HOSTCURL_ENCODE = "ndsm.hostcurl.encode"
HOSTCURL_FETCH = "ndsm.hostcurl.fetch"
HOSTCURL_CURL = "ndsm.hostcurl.curl"
HOSTCURL_SLABS = "ndsm.hostcurl.slabs"
HOSTCURL_WIRE_BYTES = "ndsm.hostcurl.wire_bytes"
HOSTCURL_FRESH_BYTES = "ndsm.hostcurl.fresh_bytes"

#: Spans that open a profiler range whenever a profiler records.
RANGES = frozenset({UPLOAD, FETCH, FACES, CHI, SOLVE3D, POST, SYNC, HOSTCURL, HOSTCURL_ENCODE,
                    HOSTCURL_FETCH, HOSTCURL_CURL})
#: Spans that open one only under ``trace(detail=True)``.
DETAIL_RANGES = frozenset({VCYCLE, BUILD, OP_RELAX, OP_RESIDUAL, OP_COARSE_BUILD})
#: Per-call records ``calls()`` keeps.
CALLS_KEPT = 4096

_perf = time.perf_counter
_ranges = set(RANGES)


@contextlib.contextmanager
def trace(log_dir: str, detail: bool = False) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block and write its Chrome trace into
    ``log_dir`` (``<host>_<pid>.<time>.pt.trace.json``).  Records CPU
    activity, and CUDA activity when ``torch.cuda.is_available()``.
    Yields the profiler, whose ``key_averages()`` the caller may read.
    ``detail=True`` also opens a range for every span of
    ``DETAIL_RANGES`` (``ndsm.vcycle``, ``ndsm.build``, ``ndsm.op.*``): a
    view per V-cycle and per operator call, whose ranges take the kernels
    they enclose from the phase ranges.

    Example:
        with ndsm_tpu_torch.utils.profiling.trace("ndsm-trace"):
            vector_potential(x, y, z, b)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    added = (DETAIL_RANGES - _ranges) if detail else frozenset()
    _ranges.update(added)
    try:
        with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
        ) as prof:
            yield prof
    finally:
        _ranges.difference_update(added)


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


class _Registry:
    """``{name: [count, inclusive s, self s]}``; a counter has no seconds."""

    def __init__(self):
        self.d: dict = {}

    def slot(self, name: str) -> list:
        v = self.d.get(name)
        if v is None:
            v = self.d[name] = [0, 0.0, 0.0]
        return v

    def stats(self) -> dict:
        return {name: tuple(v) for name, v in self.d.items() if v[0]}


class _Local(threading.local):
    def __init__(self):
        self.stack: list = []  # [start, seconds of the nested spans, range]


_REG = _Registry()
_CALLS: "collections.deque[dict]" = collections.deque(maxlen=CALLS_KEPT)
_tls = _Local()
_open = None  # the open call's _Registry
_index = 0


class _Span:
    __slots__ = ("name", "total")

    def __init__(self, name: str):
        self.name = name
        self.total = _REG.slot(name)

    def __enter__(self):
        rf = None
        # the flag torch.profiler sets while it records: no dispatcher call
        if _ap._is_profiler_enabled and self.name in _ranges:
            rf = torch.profiler.record_function(self.name)
            rf.__enter__()
        _tls.stack.append([_perf(), 0.0, rf])
        return self

    def __exit__(self, *exc):
        t1 = _perf()
        stack = _tls.stack
        t0, nested, rf = stack.pop()
        dt = t1 - t0
        own = dt - nested
        if stack:
            stack[-1][1] += dt
        v = self.total
        v[0] += 1
        v[1] += dt
        v[2] += own
        if _open is not None:
            v = _open.slot(self.name)
            v[0] += 1
            v[1] += dt
            v[2] += own
        if rf is not None:
            rf.__exit__(None, None, None)
        return False


_SPANS: dict = {}


def span(name: str) -> _Span:
    """The span ``name`` (a reusable context manager; module docstring)."""
    s = _SPANS.get(name)
    if s is None:
        s = _SPANS[name] = _Span(name)
    return s


_SYNC = span(SYNC)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _REG.slot(name)[0] += n
    if _open is not None:
        _open.slot(name)[0] += n


@contextlib.contextmanager
def withheld(prefixes: tuple) -> Iterator[dict]:
    """Yield a dict that, when the block ends (even by an exception),
    holds ``{name: n}`` of the counters whose names start with one of
    ``prefixes`` and moved inside it; those moves are taken back out of the
    totals and of the open call."""
    before = {name: v[0] for name, v in _REG.d.items() if name.startswith(prefixes)}
    moved: dict = {}
    try:
        yield moved
    finally:
        for name, v in _REG.d.items():
            if name.startswith(prefixes) and v[0] != before.get(name, 0):
                moved[name] = v[0] - before.get(name, 0)
        for name, n in moved.items():
            count(name, -n)


@contextlib.contextmanager
def call(entry: str):
    """Delimit one public call of ``entry``; inside an open call, nothing."""
    global _open, _index
    if _open is not None:
        yield
        return
    rec = _open = _Registry()
    index, _index = _index, _index + 1
    t0, raised = _perf(), True
    try:
        yield
        raised = False
    finally:
        _open = None
        _CALLS.append({"index": index, "entry": entry, "wall_s": _perf() - t0,
                       "raised": raised, "stats": rec.stats()})


def host_read(fn, *args):
    """``fn(*args)`` inside the ``ndsm.sync`` span: one host read of a
    device value (``float``, ``bool``, ``int``, a ``tolist``) or one
    synchronise.  The arguments are computed before the span opens, so a
    reduction in them stays outside it."""
    with _SYNC:
        return fn(*args)


def calls() -> list:
    """The last ``CALLS_KEPT`` per-call records, oldest first."""
    return list(_CALLS)


def stats() -> dict:
    """``{name: (count, inclusive s, self s)}`` since the last reset."""
    return _REG.stats()


def counter(name: str) -> int:
    """The count of ``name`` since the last reset (0 if it never moved)."""
    v = _REG.d.get(name)
    return 0 if v is None else v[0]


def reset(prefix: Optional[str] = None) -> None:
    """Zero the registry and drop the per-call records; with ``prefix``,
    zero only the spans and counters whose names start with it."""
    for name, v in _REG.d.items():
        if prefix is None or name.startswith(prefix):
            v[:] = [0, 0.0, 0.0]
    if prefix is None:
        _CALLS.clear()
