"""Captured CUDA graphs of a cycle function, one a key of its inputs.

A cycle function takes its state and other tensors and returns a tuple of
new tensors, the first its new state (the state's shape and dtype).  It may
be captured when it reads nothing on the host, launches only on the current
stream, modifies none of its inputs, and keeps across calls only buffers
that exist before the capture (``prepare`` makes them for the capture
stream).  ``CycleGraphs.get`` gives for CUDA inputs:

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

A key is the shape, dtype and device of each input, and the caller's
``tag`` where it gives one: a function whose launches depend on host values
other than its inputs (the lanes a ``MultiBCSolver`` cycle runs) names them
there, and gets a graph for each.  The graphs of one input key share their
static inputs.

``_Graph.replay`` copies the inputs into the static ones, replays, and
returns clones of the outputs, so a result the caller keeps is not
overwritten by the next replay.  The graph ends by writing the new state
into the static state input, and the replay returns a clone of that: the
state is then the tensor that input holds, and a next cycle on it copies
nothing in, while the graph keeps no output array of its own.  A replay
skips the copy of an input that is the tensor the static one last took
(held by a weak reference) at the same version (``Tensor._version``): a
tensor modified in place, by torch or by a kernel that calls
``torch.autograd.graph.increment_version``, is copied again.

The registry counters whose names start with one of ``counters`` (the
kernel wrappers' launch counters) move during the capture as if the
function ran; they are taken back out then and added again at every
replay, so they count the launches the card runs.  The graphs and their
memory pool belong to the object: they go with it.  All its graphs
allocate from one pool: sound because they replay one at a time on one
stream and a replay's outputs are cloned before the next replay, so one
graph's intermediates may overwrite another's freed ones.  No cyclic
garbage collection runs during a capture: a graph it freed there would
end the capture.

Counters (utils/profiling.py): ``ndsm.graph.captures``,
``ndsm.graph.replays``, ``ndsm.graph.failed``.
"""

from __future__ import annotations

import gc
import weakref
from typing import Callable, Hashable, Optional, Sequence

import torch

from ..utils import profiling

__all__ = ["CycleGraphs"]

#: A key whose capture raised.
_FAILED = "failed"


def _version(x: torch.Tensor) -> Optional[int]:
    """``x``'s version counter, None for an inference tensor (it has none)."""
    return None if x.is_inference() else x._version


class _Inputs:
    """The static inputs of one input key, and for each the tensor it last
    took (a weak reference) and that tensor's version then (None for an
    inference tensor, which has no version: always copied)."""

    __slots__ = ("tensors", "held")

    def __init__(self, xs, device):
        self.tensors = tuple(torch.empty(x.shape, dtype=x.dtype, device=device) for x in xs)
        self.held = [(None, None)] * len(xs)

    def fill(self, xs) -> None:
        """Copy each of ``xs`` into its static input, unless it is the
        tensor that input holds at the same version."""
        for i, (s, x) in enumerate(zip(self.tensors, xs)):
            ref, version = self.held[i]
            now = _version(x)
            if now is not None and version == now and ref() is x:
                continue
            s.copy_(x)
            self.held[i] = (weakref.ref(x), now)


class _Graph:
    """One captured call: its static inputs, its static outputs after the
    new state (which the graph writes into the state input), and the
    counts of ``counters`` that one call moves."""

    __slots__ = ("graph", "inputs", "outputs", "counts")

    def __init__(self, graph, inputs, outputs, counts):
        self.graph, self.inputs, self.outputs, self.counts = graph, inputs, outputs, counts

    def replay(self, *xs) -> tuple:
        """The function's outputs for ``xs`` (clones), on the current stream
        of the graph's device; the static state input then holds the new
        state, the first of them."""
        self.inputs.fill(xs)
        self.graph.replay()
        state = self.inputs.tensors[0].clone()
        self.inputs.held[0] = (weakref.ref(state), _version(state))
        out = (state,) + tuple(o.clone() for o in self.outputs)
        for name, n in self.counts:
            profiling.count(name, n)
        profiling.count(profiling.GRAPH_REPLAYS)
        return out


class CycleGraphs:
    """The graphs of one cycle function (module docstring), keyed by the
    shape, dtype and device of each input and an optional tag.
    ``prepare(device, stream)`` makes what a captured launch keeps across
    calls for the capture stream; ``counters`` are the prefixes of the
    registry counters that the function moves.  The function is passed to
    each ``get``, so that an object holding its graphs in an attribute
    makes no reference cycle: the graphs' memory goes when that object
    does."""

    def __init__(self, counters: Sequence[str] = (), prepare: Optional[Callable] = None):
        self._counters = tuple(counters)
        self._prepare = prepare
        self._pool = None  # the graphs' pool, made at the first capture
        self._state: dict = {}  # key -> None (seen once), a _Graph or _FAILED
        self._inputs: dict = {}  # input key (no tag) -> _Inputs
        self._streams: dict = {}  # device -> capture stream
        #: key -> the error its capture raised
        self.errors: dict = {}

    def get(self, fn: Callable, *xs, tag: Optional[Hashable] = None) -> Optional[_Graph]:
        """The graph of ``fn`` for ``xs`` (and ``tag``), captured on the
        second call of their key; None where the caller runs ``fn`` eagerly
        (module docstring)."""
        if not all(x.is_cuda for x in xs):
            return None
        key = tuple((tuple(x.shape), x.dtype, x.device) for x in xs)
        if tag is not None:
            key += (tag,)
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
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        with profiling.span(profiling.BUILD), torch.cuda.device(device):
            ikey = key[:len(xs)]
            inputs = self._inputs.get(ikey)
            if inputs is None:
                inputs = self._inputs[ikey] = _Inputs(xs, device)
            inputs.fill(xs)
            stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                if self._prepare is not None:
                    self._prepare(device, stream.cuda_stream)
                # cuBLAS's workspace of this stream, outside the graph's pool
                w = torch.ones((2, 2), dtype=xs[0].dtype, device=device)
                torch.mm(w, w)
            cur.wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            collecting = gc.isenabled()
            gc.disable()
            # The one handler: a capture that raises (a CUDA error, or an op
            # the capture refuses) leaves the key to the same kernels run
            # eagerly; an error of theirs then raises there.
            try:
                with torch.cuda.stream(stream), profiling.withheld(self._counters) as moved:
                    graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                    try:
                        outputs = fn(*inputs.tensors)
                        inputs.tensors[0].copy_(outputs[0])
                    finally:
                        graph.capture_end()
            except RuntimeError as e:
                self.errors[key] = str(e.__context__ or e)
                profiling.count(profiling.GRAPH_FAILED)
                return _FAILED
            finally:
                if collecting:
                    gc.enable()
        profiling.count(profiling.GRAPH_CAPTURES)
        return _Graph(graph, inputs, tuple(outputs[1:]), tuple(moved.items()))
