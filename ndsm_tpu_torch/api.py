"""User-facing API (port of ``ndsm_tpu/api.py``): the reference's
``ndsm.vector_potential`` signature (reference ndsm.py:66-210) and its
``(ierr, A, B)`` return with numpy arrays, plus one keyword-only
``device`` argument.

``device="cuda"`` (the default) runs on the CUDA device and raises when
there is none; ``device="cpu"`` runs the same pipeline on the CPU with the
kernels' plain PyTorch versions.  Nothing chooses the device for you.

How A and B reach the host: on a CUDA device each is copied, in chunks of
at most ``FETCH_BLOCK_BYTES`` of its flat storage, through a ring of
``FETCH_BLOCKS`` pinned host blocks on a side stream, and the host copies
each block, as its chunk lands, into a fresh numpy array (a copy on
torch's CPU threads) while the next chunk crosses.  The two arrays are
allocated when the call starts, and two worker threads write a byte of
each of their pages while the card computes, so the copy into them takes
no page faults.  Each array lies in a host buffer of its own, which goes
back to the process's pool when the last array or view on it is freed;
the pool keeps the ``HOST_KEEP`` buffers freed last, and a call whose
array has a kept buffer's size takes it, already paged in; a call of
another size lets them go before it allocates.  At 512^3 a fresh pair
is 1.6 million page faults, which can outlast the card's work.  The
ring is built once a device a process and reused by every call, so the
pinned memory the copy holds is ``FETCH_BLOCKS x
FETCH_BLOCK_BYTES`` (64 MiB a device), whatever the number of calls or of
results kept.  The arrays returned are the caller's own: no array is a
view of the ring, and a later call never writes into them.  On the CPU A
and B are the tensors' own memory (``Tensor.numpy()``, no copy).
"""

from __future__ import annotations

import concurrent.futures
import math
import mmap
import threading
import time
import weakref
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .options import Options
from .potential.vector_potential import compute_vector_potential
from .utils import profiling

__all__ = ["vector_potential"]

#: The pinned ring of the copy of A and B to the host (module docstring):
#: its blocks, and the bytes of each, which is the most a chunk holds.
FETCH_BLOCKS = 2
FETCH_BLOCK_BYTES = 32 << 20
#: Freed host buffers of A and B kept for later calls (module docstring);
#: 0 hands every freed buffer back to the system.
HOST_KEEP = 2


def chunk_plan(nbytes: int, block: int) -> List[Tuple[int, int]]:
    """The byte ranges ``[a, b)`` of the chunks of an ``nbytes`` copy: at
    most ``block`` bytes each, in order, covering every byte once."""
    return [(a, min(a + block, nbytes)) for a in range(0, nbytes, block)]


def run_ring(n: int, nblocks: int, enqueue: Callable[[int, int], object],
             land: Callable[[int, int], None]) -> None:
    """Pass ``n`` chunks through a ring of ``nblocks`` blocks, chunk i
    through block ``i % nblocks``: ``enqueue(i, block)`` starts its copy
    into the block and returns what to ``synchronize()`` on before
    ``land(i, block)`` copies it out on the host.  Chunk ``i + nblocks`` is
    enqueued only after chunk i has landed, so no block is refilled before
    its host copy is done, while the copies of the chunks between cross."""
    pending = [enqueue(i, i) for i in range(min(n, nblocks))]
    for i in range(n):
        slot = i % nblocks
        pending[slot].synchronize()
        land(i, slot)
        if i + nblocks < n:
            pending[slot] = enqueue(i + nblocks, slot)


def byte_chunks(tensors: Sequence[torch.Tensor], block: int,
                out: Optional[Sequence[np.ndarray]] = None):
    """The C-contiguous numpy arrays that receive the tensors, and the
    chunks that fill them: ``(source bytes, destination bytes, a, b)``,
    flat uint8 views of each tensor and of its array, tensor after tensor.
    An array of ``out`` receives its tensor where it has the tensor's shape
    and dtype; otherwise a fresh array does."""
    arrays, chunks = [], []
    for k, t in enumerate(tensors):
        t = t.contiguous()
        shape, dtype = tuple(t.shape), torch.empty((), dtype=t.dtype).numpy().dtype
        dst = None if out is None else out[k]
        if dst is None or dst.shape != shape or dst.dtype != dtype:
            dst = np.empty(shape, dtype=dtype)
        src_b = t.reshape(-1).view(torch.uint8)
        dst_b = torch.from_numpy(dst.reshape(-1).view(np.uint8))
        chunks += [(src_b, dst_b, a, b) for a, b in chunk_plan(src_b.numel(), block)]
        arrays.append(dst)
    return arrays, chunks


class _Lease:
    """A host buffer lent to one array: numpy keeps it as the array's base
    (``__array_interface__``), so it lives while any array or view on the
    buffer does, and its death gives the buffer back (``_give_back``)."""

    __slots__ = ("__array_interface__", "__weakref__")


_IDLE: List[np.ndarray] = []  # freed buffers (flat uint8 arrays), the newest last
_POOL_LOCK = threading.Lock()


def _give_back(buf: np.ndarray) -> None:
    """Keep a freed buffer (``_Lease``'s finalizer).  The cyclic collector
    may run a finalizer in a thread that holds the pool's lock, so one that
    finds the lock taken lets the buffer go instead of waiting."""
    if not _POOL_LOCK.acquire(blocking=False):
        return
    try:
        _IDLE.append(buf)
        del _IDLE[: max(len(_IDLE) - HOST_KEEP, 0)]
    finally:
        _POOL_LOCK.release()


def _take(nbytes: int) -> Optional[np.ndarray]:
    """The newest kept buffer of ``nbytes``, taken out of the pool; with
    none, the pool lets every buffer go, so that the fresh buffer of the
    new size may reuse their memory, already paged in."""
    with _POOL_LOCK:
        for i in range(len(_IDLE) - 1, -1, -1):
            if _IDLE[i].nbytes == nbytes:
                return _IDLE.pop(i)
        _IDLE.clear()
    return None


def _lend(buf: np.ndarray, shape: Tuple[int, ...], dtype: np.dtype) -> np.ndarray:
    """An array of ``shape`` and ``dtype`` on ``buf``, which goes back to
    the pool when the last array or view on it is freed."""
    lease = _Lease()
    lease.__array_interface__ = {"data": (buf.ctypes.data, False),
                                 "shape": tuple(shape), "typestr": dtype.str, "version": 3}
    a = np.asarray(lease)
    weakref.finalize(lease, _give_back, buf).atexit = False
    return a


def _paged_in(shape: Tuple[int, ...], dtype: np.dtype) -> np.ndarray:
    """An array on a fresh buffer with one byte of each page written: its
    pages are mapped, so the copy into it takes no page faults."""
    nbytes = math.prod(shape) * dtype.itemsize
    if nbytes == 0:
        return np.empty(shape, dtype=dtype)
    buf = np.empty(nbytes, dtype=np.uint8)
    buf[::mmap.PAGESIZE] = 0
    return _lend(buf, shape, dtype)


_PAGER: Optional[concurrent.futures.ThreadPoolExecutor] = None


def page_in(shape: Tuple[int, ...], dtype) -> list:
    """Futures of two arrays of ``shape`` and ``dtype`` for A and B, none
    sharing memory with a live array: each on a kept buffer of its size
    (done at once; counted ``ndsm.fetch.recycled``), or on a fresh one
    whose pages a worker thread maps while the caller goes on
    (``_paged_in``, a numpy write, which releases the interpreter lock)."""
    global _PAGER
    dtype = np.dtype(dtype)
    with _LOCK:
        if _PAGER is None:
            _PAGER = concurrent.futures.ThreadPoolExecutor(2, thread_name_prefix="ndsm-page-in")
    futures = []
    for _ in range(2):
        buf = _take(math.prod(shape) * dtype.itemsize)
        if buf is None:
            futures.append(_PAGER.submit(_paged_in, shape, dtype))
            continue
        profiling.count(profiling.FETCH_RECYCLED)
        done = concurrent.futures.Future()
        done.set_result(_lend(buf, shape, dtype))
        futures.append(done)
    return futures


class _Ring:
    """``FETCH_BLOCKS`` pinned host blocks of one device, with a side
    stream and an event a block; one fetch at a time holds ``lock``."""

    def __init__(self, device: torch.device):
        self.blocks = [torch.empty(FETCH_BLOCK_BYTES, dtype=torch.uint8, pin_memory=True)
                       for _ in range(FETCH_BLOCKS)]
        self.stream = torch.cuda.Stream(device)
        self.events = [torch.cuda.Event() for _ in range(FETCH_BLOCKS)]
        self.lock = threading.Lock()
        profiling.count(profiling.FETCH_RING_BUILDS)


_RINGS: dict = {}
_LOCK = threading.Lock()  # builds the rings and the page-in threads


def _ring(device: torch.device) -> _Ring:
    with _LOCK:
        ring = _RINGS.get(device)
        if ring is None:
            ring = _RINGS[device] = _Ring(device)
    return ring


def to_host(tensors: Sequence[torch.Tensor],
            out: Optional[Sequence[np.ndarray]] = None) -> List[np.ndarray]:
    """The tensors as numpy arrays on the host: on the CPU their own memory;
    on a CUDA device the arrays of ``out`` that match them (``byte_chunks``)
    or fresh ones, filled through the device's pinned ring (module
    docstring), the chunks' copies on a side stream that first waits for
    the current stream."""
    dev = tensors[0].device
    if dev.type != "cuda":
        return [t.numpy() for t in tensors]
    ring = _ring(dev)
    with ring.lock:
        out, chunks = byte_chunks(tensors, ring.blocks[0].numel(), out)
        blocks, events, stream = ring.blocks, ring.events, ring.stream

        def enqueue(i, slot):
            src, _, a, b = chunks[i]
            blocks[slot][: b - a].copy_(src[a:b], non_blocking=True)
            events[slot].record(stream)
            return events[slot]

        def land(i, slot):
            _, dst, a, b = chunks[i]
            dst[a:b].copy_(blocks[slot][: b - a])

        stream.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(stream):
                run_ring(len(chunks), len(blocks), enqueue, land)
        finally:
            stream.synchronize()  # no copy into a block outlives the lock
    profiling.count(profiling.FETCH_CHUNKS, len(chunks))
    profiling.count(profiling.FETCH_BYTES, sum(b - a for _, _, a, b in chunks))
    return out


def vector_potential(
    x,
    y,
    z,
    b,
    niterex_max: int = 10000,
    ncycles_max: int = 1024,
    ex_tol: float = 1e-13,
    vc_tol: float = 1e-10,
    ms: int = 5,
    mean: bool = False,
    libname: Optional[str] = None,  # accepted for reference compatibility
    libpath: Optional[str] = None,  # accepted for reference compatibility
    debug: bool = False,
    *,
    precision: str = "auto",
    options: Optional[Options] = None,
    full_output: bool = False,
    dist=None,
    device: str = "cuda",
):
    """Compute the potential magnetic field and Coulomb-gauge vector
    potential from boundary Bn (see ``ndsm_tpu.api.vector_potential``).

    Returns (ierr, A, B) with A, B numpy arrays of shape (3, nz, ny, nx)
    (float64 unless ``options.output_dtype`` says float32), plus the
    diagnostics record when ``full_output``; its ``phases`` gain a
    "fetch" entry, the copy of A and B to the host (with
    ``Options.host_curl``, the pipeline's own "host_alloc", "slab_split",
    "fetch" and "curl": A alone is copied and B is its curl taken on the
    host).  ``options`` carries
    what the signature does not name, such as ``batch_components`` and
    ``smoother`` ("compact": the component solves smooth on colour-split
    state, with the same iterates; see ``Options``).

    ``dist``: optional ``ndsm_tpu_torch.parallel.shard.DistConfig`` -- run
    every sub-solve on the sharded engine over a device mesh (spatial
    domain decomposition; sub-problems whose shapes cannot be partitioned
    run on one device).  Its mesh's devices must be of ``device``'s type,
    e.g. ``DistConfig(make_mesh(2, devices=["cuda:0"] * 2))`` on one card
    or ``make_mesh(4, devices=["cpu"] * 4)`` with ``device="cpu"``.  A 2-D
    (z, y) mesh, ``DistConfig(make_mesh_nd((2, 2), devices=["cuda:0"] *
    4), ("z", "y"))``, partitions the 3D component solves in z and y and
    the 2D chi faces in z.

    On a CUDA device A and B reach the host through the device's ring of
    ``FETCH_BLOCKS`` pinned blocks of ``FETCH_BLOCK_BYTES`` (64 MiB of
    pinned memory, fixed; module docstring), chunk by chunk, into fresh
    arrays paged in while the card computes.  The arrays are the caller's
    own: no array is a view of the ring, and a later call writes into none
    of them.

    One call of the registry (``utils.profiling.call``); the copy of A and
    B is its ``ndsm.fetch`` span, its chunks and bytes the counters
    ``ndsm.fetch.chunks`` and ``ndsm.fetch.bytes``.
    """
    with profiling.call("vector_potential"):
        if options is None:
            options = Options(
                ms=ms,
                ncycles_max=ncycles_max,
                niterex_max=niterex_max,
                ex_tol=ex_tol,
                vc_tol=vc_tol,
                mean=mean,
                debug=debug,
                precision=precision,
            )
        # the arrays A and B will land in, paged in while the card computes
        pages = None
        if torch.device(device).type == "cuda" and not options.host_curl:
            pages = page_in(np.shape(b), options.output_dtype)
        ierr, A, B, info = compute_vector_potential(
            (x, y, z), np.asarray(b), options, device=device, dist=dist
        )
        if isinstance(A, torch.Tensor):  # not the host-curl pipeline: copy A and B
            t0 = time.perf_counter()
            with profiling.span(profiling.FETCH):
                A, B = to_host((A, B), None if pages is None else [f.result() for f in pages])
            if info.phases is not None:
                info.phases["fetch"] = time.perf_counter() - t0
    if full_output:
        return ierr, A, B, info
    return ierr, A, B
