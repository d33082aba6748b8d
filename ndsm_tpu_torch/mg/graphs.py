"""Captured CUDA graphs of a cycle function, one a key of its inputs.

A cycle function takes tensors and returns a tuple of new tensors.  It may
be captured when it reads nothing on the host, launches only on the current
stream, and keeps across calls only buffers that exist before the capture
(``prepare`` makes them for the capture stream).  ``CycleGraphs.get`` gives
for CUDA inputs:

  * the first time a key is seen, None: the caller runs the function
    eagerly, which warms everything it builds lazily (the kernel library,
    the pass plans, their caches, cuBLAS);
  * the second time, the function captured into a ``torch.cuda.CUDAGraph``
    on a stream of its own (``capture_error_mode="thread_local"``: host
    threads of the program may touch the card meanwhile), reading static
    copies of the inputs; later times, the same graph;
  * for a key whose capture raised, None for the life of the object (the
    counter ``ndsm.graph.failed``); the capture ran nothing, so the caller's
    eager run gives the eager result.

``_Graph.replay`` copies the inputs into the static ones, replays, and
returns clones of the static outputs, so a result the caller keeps is not
overwritten by the next replay.  The registry counters whose names start
with one of ``counters`` (the kernel wrappers' launch counters) move during
the capture as if the function ran; they are taken back out then and added
again at every replay, so they count the launches the card runs.  The
graphs and their memory pools belong to the object: they go with it.

Counters (utils/profiling.py): ``ndsm.graph.captures``,
``ndsm.graph.replays``, ``ndsm.graph.failed``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..utils import profiling

__all__ = ["CycleGraphs"]

#: A key whose capture raised.
_FAILED = "failed"


class _Graph:
    """One captured call: its static inputs and outputs, and the counts of
    ``counters`` that one call moves."""

    __slots__ = ("graph", "inputs", "outputs", "counts")

    def __init__(self, graph, inputs, outputs, counts):
        self.graph, self.inputs, self.outputs, self.counts = graph, inputs, outputs, counts

    def replay(self, *xs) -> tuple:
        """The function's outputs for ``xs`` (clones of the static outputs),
        on the current stream of the graph's device."""
        for s, x in zip(self.inputs, xs):
            s.copy_(x)
        self.graph.replay()
        out = tuple(o.clone() for o in self.outputs)
        for name, n in self.counts:
            profiling.count(name, n)
        profiling.count(profiling.GRAPH_REPLAYS)
        return out


class CycleGraphs:
    """The graphs of one cycle function (module docstring), keyed by the
    shape, dtype and device of each input.  ``prepare(device, stream)``
    makes what a captured launch keeps across calls for the capture stream;
    ``counters`` are the prefixes of the registry counters that the
    function moves.  The function is passed to each ``get``, so that an
    object holding its graphs in an attribute makes no reference cycle:
    the graphs' memory goes when that object does."""

    def __init__(self, counters: Sequence[str] = (), prepare: Optional[Callable] = None):
        self._counters = tuple(counters)
        self._prepare = prepare
        self._state: dict = {}  # key -> None (seen once), a _Graph or _FAILED
        self._streams: dict = {}  # device -> capture stream
        #: key -> the error its capture raised
        self.errors: dict = {}

    def get(self, fn: Callable, *xs) -> Optional[_Graph]:
        """The graph of ``fn`` for ``xs``, captured on the second call of
        their key; None where the caller runs ``fn`` eagerly (module
        docstring)."""
        if not all(x.is_cuda for x in xs):
            return None
        key = tuple((tuple(x.shape), x.dtype, x.device) for x in xs)
        if key not in self._state:
            self._state[key] = None
            return None
        g = self._state[key]
        if g is None:
            g = self._state[key] = self._capture(fn, key, xs)
        return None if g is _FAILED else g

    def _capture(self, fn, key, xs):
        device = xs[0].device
        cur = torch.cuda.current_stream(device)
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        with profiling.span(profiling.BUILD), torch.cuda.device(device):
            inputs = tuple(torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x)
                           for x in xs)
            stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                if self._prepare is not None:
                    self._prepare(device, stream.cuda_stream)
                # cuBLAS's workspace of this stream, outside the graph's pool
                w = torch.ones((2, 2), dtype=xs[0].dtype, device=device)
                torch.mm(w, w)
            cur.wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            # The one handler: a capture that raises (a CUDA error, or an op
            # the capture refuses) leaves the key to the same kernels run
            # eagerly; an error of theirs then raises there.
            try:
                with torch.cuda.stream(stream), profiling.withheld(self._counters) as moved:
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        outputs = fn(*inputs)
                    finally:
                        graph.capture_end()
            except RuntimeError as e:
                self.errors[key] = str(e.__context__ or e)
                profiling.count(profiling.GRAPH_FAILED)
                return _FAILED
        profiling.count(profiling.GRAPH_CAPTURES)
        return _Graph(graph, inputs, tuple(outputs), tuple(moved.items()))
