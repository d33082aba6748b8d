"""The copy of A and B to the host (``ndsm_tpu_torch.api``): the chunk plan,
the ring's handoff order under a stand-in copy engine, the whole chunked
copy emulated with host blocks, the pool of freed host buffers that later
calls take already paged in, and the CPU device's zero-copy arrays; on
a card (``-m cuda``), the ring's arrays bitwise ``.cpu().numpy()``'s, the
caller's own, and one ring a device however many calls.

The file imports neither JAX nor ``ndsm_tpu``, so its card tests also run
on a host without them: ``python -m pytest --noconftest
tests/test_torch_fetch.py -m cuda``."""

import math
import sys
import threading

import numpy as np
import pytest
import torch

from ndsm_tpu_torch import api, vector_potential
from ndsm_tpu_torch.options import Options
from ndsm_tpu_torch.utils import profiling as P

M = api.FETCH_BLOCK_BYTES


@pytest.mark.parametrize("nbytes, block", [
    (0, 64), (1, 64), (63, 64), (64, 64), (65, 64), (128, 64), (129, 64), (3 * 64 + 5, 64),
    (1001, 7), (1001, 1), (7, 1001),
    (M - 8, M), (M, M), (M + 8, M), (4 * M, M), (255_552_000, M), (31_944_000, M),
])
def test_chunk_plan_covers_every_byte_once_in_order(nbytes, block):
    plan = api.chunk_plan(nbytes, block)
    assert len(plan) == math.ceil(nbytes / block)
    pos = 0
    for a, b in plan:
        assert a == pos and 0 < b - a <= block
        pos = b
    assert pos == nbytes
    assert all(b - a == block for a, b in plan[:-1])  # only the last chunk is short


class _Engine:
    """A stand-in copy engine: an enqueued copy lands in its block only
    when the host synchronises on it (later copies stay in flight), and
    every step is checked against the ring's rules."""

    def __init__(self, n, nblocks):
        self.n, self.nblocks = n, nblocks
        self.block = [None] * nblocks  # (chunk, "in flight" | "arrived" | "landed")
        self.enqueued, self.landed = [], []

    def enqueue(self, i, slot):
        assert slot == i % self.nblocks
        assert i == len(self.enqueued), "chunks enqueued out of order"
        prev = self.block[slot]
        assert prev is None or prev[1] == "landed", f"block {slot} refilled before its host copy"
        self.block[slot] = (i, "in flight")
        self.enqueued.append(i)
        engine = self

        class _Done:
            def synchronize(self):
                assert engine.block[slot][0] == i
                engine.block[slot] = (i, "arrived")

        return _Done()

    def land(self, i, slot):
        assert self.block[slot] == (i, "arrived"), "a host copy before its chunk arrived"
        assert i == len(self.landed)
        # the copies of the chunks after it are already in flight
        assert len(self.enqueued) == min(self.n, i + self.nblocks)
        self.block[slot] = (i, "landed")
        self.landed.append(i)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 9, 33])
@pytest.mark.parametrize("nblocks", [1, 2, 4])
def test_ring_never_refills_a_block_before_its_host_copy(n, nblocks):
    eng = _Engine(n, nblocks)
    api.run_ring(n, nblocks, eng.enqueue, eng.land)
    assert eng.enqueued == eng.landed == list(range(n))


@pytest.mark.parametrize("shapes, dtype, block", [
    (((3, 22, 22, 22),) * 2, torch.float64, M),  # one chunk each
    (((3, 13, 27, 6),) * 2, torch.float32, 1000),  # odd sizes, a short last chunk
    (((3, 13, 27, 6),) * 2, torch.float64, 8 * 3 * 13 * 27),  # 0 remainder
    (((3, 9, 10, 11), (2, 5)), torch.float64, 777),  # a block boundary inside an element
])
def test_chunked_copy_through_host_blocks_is_bitwise(shapes, dtype, block):
    """``byte_chunks`` and ``run_ring`` with host blocks in place of the
    pinned ones: fresh C-contiguous arrays, each byte of A then B copied
    once, bitwise."""
    g = torch.Generator().manual_seed(3)
    src = [torch.randn(s, generator=g, dtype=torch.float64).to(dtype) for s in shapes]
    src[0] = src[0].transpose(1, 3)  # not contiguous: copied in its logical order
    out, chunks = api.byte_chunks(src, block)
    assert len(chunks) == sum(math.ceil(t.numel() * t.element_size() / block) for t in src)
    blocks = [torch.empty(block, dtype=torch.uint8) for _ in range(api.FETCH_BLOCKS)]

    class _Now:
        def synchronize(self):
            pass

    def enqueue(i, slot):
        s, _, a, b = chunks[i]
        blocks[slot][: b - a].copy_(s[a:b])
        return _Now()

    def land(i, slot):
        _, d, a, b = chunks[i]
        d[a:b].copy_(blocks[slot][: b - a])

    api.run_ring(len(chunks), len(blocks), enqueue, land)
    for t, arr in zip(src, out):
        ref = t.contiguous().numpy()
        assert arr.flags.c_contiguous and arr.dtype == ref.dtype and arr.shape == ref.shape
        assert arr.tobytes() == ref.tobytes()
        assert not np.shares_memory(arr, t.numpy())


@pytest.mark.parametrize("shape, dtype", [((3, 22, 22, 22), "float64"), ((3, 13, 27, 6), "float32"),
                                          ((3, 0, 4, 4), "float64")])
def test_page_in_gives_fresh_arrays_the_copy_takes(shape, dtype):
    """``page_in``'s arrays are fresh, C-contiguous and of the shape and
    dtype asked; ``byte_chunks`` fills such an array in place and replaces
    one of another shape or dtype by a fresh array."""
    first, second = (f.result(timeout=60) for f in api.page_in(shape, dtype))
    for a in (first, second):
        assert a.shape == shape and a.dtype == np.dtype(dtype) and a.flags.c_contiguous
    assert not np.shares_memory(first, second)
    t = torch.arange(math.prod(shape), dtype=getattr(torch, dtype)).reshape(shape)
    other = np.empty(shape, dtype="float32" if dtype == "float64" else "float64")
    out, chunks = api.byte_chunks((t, t), 1000, [first, other])
    assert out[0] is first and out[1] is not other
    for _, d, a, b in chunks:
        d[a:b].copy_(t.reshape(-1).view(torch.uint8)[a:b])
    assert first.tobytes() == out[1].tobytes() == t.numpy().tobytes()


def _pair(shape, dtype):
    return [f.result(timeout=60) for f in api.page_in(shape, dtype)]


@pytest.mark.parametrize("shape, dtype", [((3, 22, 22, 22), "float64"), ((3, 13, 27, 6), "float32")])
def test_freed_buffers_serve_the_next_call_paged_in(shape, dtype):
    """Once the caller frees a call's A and B, the next call of their size
    gets their buffers back (``ndsm.fetch.recycled``), already paged in;
    a size no kept buffer has gets fresh ones."""
    api._IDLE.clear()
    first = _pair(shape, dtype)
    ptrs = {a.ctypes.data for a in first}
    del first
    assert len(api._IDLE) == 2
    P.reset("ndsm.fetch.")
    again = _pair(shape, dtype)
    assert {a.ctypes.data for a in again} == ptrs and P.counter(P.FETCH_RECYCLED) == 2
    assert not api._IDLE
    for a in again:
        assert a.shape == shape and a.dtype == np.dtype(dtype) and a.flags.c_contiguous
        assert a.flags.writeable
    other = _pair((3, 5, 5, 5), dtype)
    assert P.counter(P.FETCH_RECYCLED) == 2 and not {a.ctypes.data for a in other} & ptrs


@pytest.mark.parametrize("keep", ["array", "view", "tensor"])
def test_a_buffer_stays_the_callers_while_anything_holds_it(keep):
    """An array, a view of it or a tensor on it keeps its buffer out of the
    pool: later calls never write into what the caller still holds."""
    api._IDLE.clear()
    shape = (3, 9, 10, 11)
    a, b = _pair(shape, "float64")
    a[:] = 7.0
    held = {"array": a, "view": a[1:], "tensor": torch.from_numpy(a)}[keep]
    del a, b
    assert len(api._IDLE) == 1
    for _ in range(3):
        for c in _pair(shape, "float64"):
            assert not np.shares_memory(c, np.asarray(held))
            c[:] = -1.0
    assert (np.asarray(held) == 7.0).all()
    del held
    assert len(api._IDLE) == api.HOST_KEEP


def test_pool_keeps_host_keep_buffers(monkeypatch):
    api._IDLE.clear()
    arrays = _pair((3, 8, 8, 8), "float64") + _pair((3, 8, 8, 8), "float64")
    del arrays
    assert len(api._IDLE) == api.HOST_KEEP == 2
    arrays = _pair((3, 9, 8, 8), "float64")  # another size: the kept ones are let go
    assert not api._IDLE
    del arrays
    monkeypatch.setattr(api, "HOST_KEEP", 0)
    arrays = _pair((3, 8, 8, 8), "float32")
    del arrays
    assert not api._IDLE


def _box(n, seed):
    x = np.linspace(0.0, 1.0, n)
    return x, np.random.default_rng(seed).standard_normal((3, n, n, n))


def test_cpu_device_keeps_the_zero_copy_arrays():
    t = [torch.arange(24, dtype=torch.float64).reshape(3, 2, 2, 2), torch.ones(3, 2, 2, 2)]
    for arr, ten in zip(api.to_host(t), t):
        assert np.shares_memory(arr, ten.numpy())
    P.reset("ndsm.fetch.")
    x, b = _box(8, 0)
    ierr, A, B, info = vector_potential(x, x, x, b, options=Options(precision="mixed"),
                                        device="cpu", full_output=True)
    assert ierr == 0
    assert isinstance(A, np.ndarray) and A.dtype == np.float64 and A.shape == (3, 8, 8, 8)
    assert isinstance(B, np.ndarray) and B.dtype == np.float64 and B.shape == (3, 8, 8, 8)
    assert set(info.phases) == {"faces", "chi", "solve3d", "post", "fetch"}
    rec = P.calls()[-1]
    assert rec["stats"][P.FETCH][0] == 1
    assert not any(k.startswith("ndsm.fetch.") for k in rec["stats"])  # no ring on the CPU


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _ring_arrays():
    return [blk.numpy() for ring in api._RINGS.values() for blk in ring.blocks]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(3, 22, 22, 22), (3, 13, 27, 6), (3, 150, 151, 149)])
def test_cuda_ring_bitwise_the_pageable_copy(card, dtype, shape):
    g = torch.Generator(device=card).manual_seed(11)
    A = torch.randn(shape, generator=g, device=card, dtype=torch.float64).to(dtype)
    B = torch.randn(shape, generator=g, device=card, dtype=torch.float64).to(dtype)
    got = api.to_host((A, B))
    for arr, t in zip(got, (A, B)):
        ref = t.cpu().numpy()
        assert arr.dtype == ref.dtype and arr.shape == ref.shape
        assert arr.tobytes() == ref.tobytes()
        assert arr.flags.c_contiguous and arr.flags.writeable
        assert not any(np.shares_memory(arr, r) for r in _ring_arrays())


@pytest.mark.cuda
def test_cuda_earlier_results_stay_the_callers(card):
    x, b1 = _box(22, 1)
    _, b2 = _box(22, 2)
    opts = Options(precision="mixed")
    ierr1, A1, B1 = vector_potential(x, x, x, b1, options=opts)
    keep = A1.copy(), B1.copy()
    ierr2, A2, B2 = vector_potential(x, x, x, b2, options=opts)
    assert ierr1 == ierr2 == 0
    assert np.array_equal(A1, keep[0]) and np.array_equal(B1, keep[1])
    assert not np.array_equal(A1, A2)
    for arr in (A1, B1, A2, B2):
        assert arr.flags.c_contiguous and arr.dtype == np.float64
        assert not any(np.shares_memory(arr, r) for r in _ring_arrays())


@pytest.mark.cuda
def test_cuda_one_ring_a_device_however_many_calls(card):
    api._RINGS.clear()
    P.reset("ndsm.fetch.")
    shapes = [(3, 22, 22, 22), (3, 13, 27, 6), (3, 110, 110, 110), (3, 150, 151, 149)]
    kept, chunks, nbytes = [], 0, 0
    for k in range(20):
        shape, dtype = shapes[k % 4], (torch.float64, torch.float32)[k // 4 % 2]
        A = torch.full(shape, float(k), device=card, dtype=dtype)
        kept.append(api.to_host((A, A + 1)))
        n = A.numel() * A.element_size()
        chunks += 2 * math.ceil(n / M)
        nbytes += 2 * n
    assert P.counter(P.FETCH_RING_BUILDS) == 1 and len(api._RINGS) == 1
    assert P.counter(P.FETCH_CHUNKS) == chunks and P.counter(P.FETCH_BYTES) == nbytes
    for k, (a, b) in enumerate(kept):  # every result still the caller's own
        assert (a == k).all() and (b == k + 1).all()


@pytest.mark.cuda
def test_cuda_threads_take_turns_on_the_ring(card):
    """Threads fetching at once (more than the host's cores, a short switch
    interval) each get their own tensors back bitwise: no two share a
    block mid-copy."""
    shape = (3, 150, 151, 149)  # three chunks: the ring wraps
    errors, switch = [], sys.getswitchinterval()

    def work(k):
        try:
            for r in range(2):
                A = torch.full(shape, float(k), device=card, dtype=torch.float64)
                B = torch.full(shape, float(-k - r), device=card, dtype=torch.float64)
                a, b = api.to_host((A, B))
                if not ((a == k).all() and (b == -k - r).all()):
                    errors.append(k)
        except Exception as e:  # reported below
            errors.append(repr(e))

    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
