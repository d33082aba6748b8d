"""The V-cycle's CUDA graphs (mg/graphs.py, ``MGEngine.t_vcycle_du``).

On the CPU: which engines hold graphs (none under an operator, with the
relaxed coarse solve or on one level), that a cycle asks for its graph only
when its du is measured against its own input and never captures on CPU
tensors, whose iterates stay the eager ones; the state of a key (eager,
captured, replayed, failed for good) with stand-in inputs; a replay's
clones and counters with a stand-in graph; ``profiling.withheld``; and
that an engine and its graphs make no reference cycle.

On a card (``-m cuda``): a whole solve with graphs bitwise the eager one
in ``u``, ``du_history`` and ``cycles`` on each kernel route (the 3D
kernels on Ax faces, the colour-split smoother, the all-Neumann smoother,
v2d on three lanes); replays with new inputs of one key; a second lane
count capturing its own graph; a kept output surviving later replays; the
graphs' memory freed with their engine; and a capture made to raise
running eagerly with the eager result.

The file imports neither JAX nor ``ndsm_tpu``, so its card tests also run
on a host without them: ``python -m pytest --noconftest
tests/test_torch_vcycle_graph.py -m cuda``."""

import gc
import weakref

import numpy as np
import pytest
import torch

from ndsm_tpu_torch import GridHierarchy, Options
from ndsm_tpu_torch.mg import graphs, poisson
from ndsm_tpu_torch.mg.engine import MGEngine
from ndsm_tpu_torch.mg.graphs import CycleGraphs
from ndsm_tpu_torch.mg.operator import HelmholtzOperator
from ndsm_tpu_torch.ops import zc
from ndsm_tpu_torch.utils import profiling as P
from ndsm_tpu_torch.utils.profiling import host_read

GRAPH = (P.GRAPH_CAPTURES, P.GRAPH_REPLAYS, P.GRAPH_FAILED)
AX = (("D", "D"), ("D", "D"), ("N", "N"))
NEUMANN = (("N", "N"),) * 3


def _mesh(n, ndim):
    return [np.linspace(0.0, 1.0, n)] * ndim


def _engine(n=17, ndim=3, bcs=AX, dtype=torch.float32, coarse_direct=True, ngrids=None,
            operator=None, device="cpu"):
    h = GridHierarchy.from_mesh(_mesh(n, ndim), ngrids=ngrids)
    return MGEngine(h, bcs, ms=2, du_max=True, dtype=dtype, device=device,
                    coarse_direct=coarse_direct, operator=operator)


def _fields(shape, seed, device="cpu", dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)
    rhs = torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)
    return u.to(device).contiguous(), rhs.to(device).contiguous()


def _eager(eng, u, rhs, u_ref):
    u_new, noconv = eng.t_vcycle(u, rhs, 1e-6, 50)
    return u_new, noconv, eng.t_metric(u_new, u_ref)


def _graph_counts():
    return tuple(P.counter(n) for n in GRAPH)


# ----------------------------------------------------------------------
# CPU: the gate
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["operator", "fp64_relax_coarse", "one_level"])
def test_engines_whose_cycle_reads_the_host_hold_no_graphs(kind):
    eng = {
        "operator": lambda: _engine(operator=HelmholtzOperator(1.9)),
        "fp64_relax_coarse": lambda: _engine(dtype=torch.float64, coarse_direct=False),
        "one_level": lambda: _engine(n=9, ngrids=1),
    }[kind]()
    assert eng._graphs is None
    assert _engine()._graphs is not None  # the direct coarse solve on levels: graphs


class _Recorder:
    """A stand-in for ``CycleGraphs`` that records each ``get`` and replays
    nothing."""

    def __init__(self):
        self.asked = 0

    def get(self, fn, *xs):
        self.asked += 1
        return None


@pytest.mark.parametrize("kind", ["cpu", "u_ref_not_u", "operator", "fp64_relax_coarse",
                                  "one_level", "lanes_2d"])
def test_cycles_that_cannot_replay_run_eagerly_with_the_eager_iterates(kind):
    """Four cycles of each engine through ``t_vcycle_du``: the eager
    ``t_vcycle`` and metric bit for bit, no graph counter moving, and
    ``CycleGraphs.get`` asked only where the du is against ``u`` itself."""
    eng = {
        "operator": lambda: _engine(operator=HelmholtzOperator(1.9)),
        "fp64_relax_coarse": lambda: _engine(dtype=torch.float64, coarse_direct=False),
        "one_level": lambda: _engine(n=9, ngrids=1),
        "lanes_2d": lambda: _engine(n=33, ndim=2, bcs=(("N", "N"), ("D", "D"))),
    }.get(kind, _engine)()
    shape = ((3,) if kind == "lanes_2d" else ()) + tuple(eng.h.fine_shape)
    u, rhs = _fields(shape, 5, dtype=eng.dtype)
    before = _graph_counts()
    real = eng._graphs
    rec = _Recorder() if real is not None else None
    for _ in range(4):
        u_ref = u.clone() if kind == "u_ref_not_u" else u
        want = _eager(eng, u, rhs, u_ref)
        if real is not None:
            assert real.get(eng._cycle_du, u, rhs) is None  # CPU tensors: no graph
            eng._graphs = rec
        got = eng.t_vcycle_du(u, rhs, 1e-6, 50, u_ref)
        eng._graphs = real
        assert torch.equal(got[0], want[0]) and got[1] == want[1]
        assert torch.equal(got[2], want[2])
        u = got[0]
    assert _graph_counts() == before
    if rec is not None:
        assert rec.asked == (0 if kind == "u_ref_not_u" else 4)
        assert real._state == {}


def test_an_engine_and_its_graphs_make_no_reference_cycle():
    """The graphs go with their engine when the last reference to it goes
    (a cache evicting it), not at a later garbage collection."""
    eng = _engine()
    u, rhs = _fields(tuple(eng.h.fine_shape), 1)
    eng.t_vcycle_du(u, rhs, 1e-6, 50, u)
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_a_cpu_solve_moves_no_graph_counter():
    P.reset()
    x = np.linspace(0.0, 1.0, 17)
    rhs = (np.sin(np.pi * x)[:, None, None] * np.cos(np.pi * x)[None, None, :]
           * np.ones((17,) * 3))
    u, info = poisson.solve_poisson_bvp(np.zeros_like(rhs), rhs, [x] * 3, AX,
                                        options=Options(precision="mixed"), device="cpu")
    assert info.ierr == 0 and info.cycles > 0
    rec = P.calls()[-1]["stats"]
    assert not any(k.startswith("ndsm.graph.") for k in rec)
    assert rec[P.VCYCLE][0] == info.cycles


# ----------------------------------------------------------------------
# CPU: a key's states, replays and the withheld counters
# ----------------------------------------------------------------------


class _Fake:
    """Stand-in CUDA input: what ``CycleGraphs.get`` reads of a tensor."""

    is_cuda = True
    dtype = torch.float32
    device = "cuda:0"

    def __init__(self, *shape):
        self.shape = shape


def test_a_key_runs_eagerly_then_captures_once_and_a_failed_key_stays_eager(monkeypatch):
    captured = []
    ok, bad = object(), graphs._FAILED

    def capture(self, fn, key, xs):
        captured.append(key)
        return bad if xs[0].shape[0] == 7 else ok

    monkeypatch.setattr(CycleGraphs, "_capture", capture)
    cg = CycleGraphs()
    fn = None
    a, b, c = (_Fake(2, 5), _Fake(2, 5)), (_Fake(3, 5), _Fake(3, 5)), (_Fake(7), _Fake(7))
    assert cg.get(fn, *a) is None and captured == []  # first sight: eager
    assert cg.get(fn, *a) is ok and len(captured) == 1  # second: captured
    assert cg.get(fn, *a) is ok and cg.get(fn, *a) is ok and len(captured) == 1
    assert cg.get(fn, *b) is None and cg.get(fn, *b) is ok and len(captured) == 2
    assert cg.get(fn, *c) is None and cg.get(fn, *c) is None and len(captured) == 3
    assert all(cg.get(fn, *c) is None for _ in range(3)) and len(captured) == 3
    # a CPU input never reaches a key
    assert cg.get(fn, torch.zeros(2, 5), torch.zeros(2, 5)) is None and len(captured) == 3


class _FakeGraph:
    """Replays a cycle, as a graph does: the new state ``2 * state`` written
    into the state input, ``amax`` of the other input into a fixed output."""

    def __init__(self, inputs, outputs):
        self.inputs, self.outputs = inputs, outputs
        self.replays = 0

    def replay(self):
        torch.mul(self.inputs[0], 2.0, out=self.inputs[0])
        torch.amax(self.inputs[1], dim=-1, out=self.outputs[0])
        self.replays += 1


def test_a_replay_copies_in_clones_out_and_counts(monkeypatch):
    P.reset()
    inputs = graphs._Inputs((torch.zeros(3, 4), torch.zeros(3, 4)), "cpu")
    outputs = (torch.zeros(3),)
    fg = _FakeGraph(inputs.tensors, outputs)
    counts = ((zc.LAUNCHES + "zc_smooth_3d", 5), (zc.PASSES + "zc", 9))
    g = graphs._Graph(fg, inputs, outputs, counts)
    with P.call("solve_poisson_bvp"):
        kept = g.replay(torch.ones(3, 4), torch.arange(12.0).reshape(3, 4))
        later = g.replay(torch.full((3, 4), 5.0), torch.zeros(3, 4))
        # the state a replay returned is what the state input holds: the
        # next cycle on it copies nothing in
        inputs.tensors[0].fill_(-1.0)
        then = g.replay(later[0], torch.zeros(3, 4))
    assert torch.equal(kept[0], torch.full((3, 4), 2.0))  # not overwritten
    assert torch.equal(kept[1], torch.tensor([3.0, 7.0, 11.0]))
    assert torch.equal(later[0], torch.full((3, 4), 10.0)) and fg.replays == 3
    assert torch.equal(then[0], torch.full((3, 4), -2.0))
    assert kept[0].data_ptr() != inputs.tensors[0].data_ptr()
    assert kept[1].data_ptr() != outputs[0].data_ptr()
    stats = P.calls()[-1]["stats"]
    assert stats[P.GRAPH_REPLAYS][0] == 3 and P.counter(P.GRAPH_REPLAYS) == 3
    assert stats[zc.LAUNCHES + "zc_smooth_3d"][0] == 15 and P.counter(zc.PASSES + "zc") == 27


def test_withheld_takes_the_moved_counters_back_out():
    P.reset()
    P.count(zc.LAUNCHES + "v2d_smooth", 4)
    with P.call("solve_poisson_bvp"):
        P.count(zc.PASSES + "zc", 1)
        with P.withheld(zc.COUNTERS) as moved:
            P.count(zc.LAUNCHES + "v2d_smooth", 3)
            P.count(zc.V2D_ROUTE + "cluster", 2)
            P.count(P.REBUILD)  # another prefix: stays
            with P.span(P.BUILD):
                pass
        assert moved == {zc.LAUNCHES + "v2d_smooth": 3, zc.V2D_ROUTE + "cluster": 2}
        with pytest.raises(ValueError), P.withheld(zc.COUNTERS) as moved2:
            P.count(zc.PASSES + "zc", 6)
            raise ValueError
        assert moved2 == {zc.PASSES + "zc": 6}
    assert P.counter(zc.LAUNCHES + "v2d_smooth") == 4 and P.counter(zc.V2D_ROUTE + "cluster") == 0
    assert P.counter(zc.PASSES + "zc") == 1 and P.counter(P.REBUILD) == 1
    stats = P.calls()[-1]["stats"]
    assert zc.LAUNCHES + "v2d_smooth" not in stats and zc.V2D_ROUTE + "cluster" not in stats
    assert stats[zc.PASSES + "zc"][0] == 1 and stats[P.BUILD][0] == 1


# ----------------------------------------------------------------------
# On a card
# ----------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    poisson._ENGINE_CACHE.clear()
    poisson._BVP_CACHE.clear()
    P.reset()
    yield torch.device("cuda", torch.cuda.current_device())
    poisson._ENGINE_CACHE.clear()
    poisson._BVP_CACHE.clear()


def _eager_only(monkeypatch):
    monkeypatch.setattr(CycleGraphs, "get", lambda self, fn, *xs: None)


def _case(route):
    """(hierarchy, bcs, options, u0s, rhss): one problem, or three lanes."""
    if route == "v2d":
        n, ndim, bcs = 220, 2, (("N", "N"), ("D", "D"))
    else:
        n, ndim = (65, 3)
        bcs = NEUMANN if route == "zc_mean" else AX
    x = np.linspace(0.0, 1.0, n)
    h = GridHierarchy.from_mesh([x] * ndim)
    opts = Options(precision="mixed", vc_tol=1e-10, ex_tol=1e-13, ms=5,
                   smoother="compact" if route == "compact" else "auto")
    rng = np.random.default_rng(3)
    lanes = 3 if route == "v2d" else 1
    rhss = []
    for _ in range(lanes):
        k = rng.integers(1, 4, size=ndim)
        f = np.ones(())
        for ax in range(ndim):
            shape = [1] * ndim
            shape[ax] = n
            f = f * np.cos(k[ax] * np.pi * x).reshape(shape)
        rhss.append(f - f.mean() if route == "zc_mean" else f)
    return h, bcs, opts, [np.zeros((n,) * ndim) for _ in range(lanes)], rhss


def _solve(route):
    h, bcs, opts, u0s, rhss = _case(route)
    bvp = poisson.get_poisson_bvp(h, bcs, opts, device="cuda")
    if route == "v2d":
        us, infos = bvp.solve_batch(u0s, rhss)
        return [u.cpu() for u in us], infos, bvp
    u, info = bvp.solve(u0s[0], rhss[0], history=True)
    return [u.cpu()], [info], bvp


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["zc", "compact", "zc_mean", "v2d"])
def test_cuda_graphed_solve_is_bitwise_the_eager_one(card, monkeypatch, route):
    us, infos, bvp = _solve(route)
    assert bvp._inner.kernel_route == route
    n_graph, cycles = _graph_counts(), P.stats()[P.VCYCLE][0]
    launches = {k: v for k, v in P.stats().items() if k.startswith(zc.COUNTERS)}
    errors = dict(bvp._inner._graphs.errors)
    poisson._ENGINE_CACHE.clear()
    poisson._BVP_CACHE.clear()
    P.reset()
    _eager_only(monkeypatch)
    us_e, infos_e, _ = _solve(route)
    assert n_graph[2] == 0, errors
    assert n_graph[0] == 1 and n_graph[1] == cycles - 1  # the first cycle ran eagerly
    assert _graph_counts() == (0, 0, 0)
    eager_launches = {k: v for k, v in P.stats().items() if k.startswith(zc.COUNTERS)}
    assert launches == eager_launches  # the replays count the launches the card ran
    for u, ue in zip(us, us_e):
        assert torch.equal(u, ue)
    for i, ie in zip(infos, infos_e):
        assert i.ierr == ie.ierr == 0
        assert i.cycles == ie.cycles and i.du_last == ie.du_last
        assert i.du_history == ie.du_history


def _direct_engine(card, ndim=3, n=65):
    bcs = AX if ndim == 3 else (("N", "N"), ("D", "D"))
    return _engine(n=n, ndim=ndim, bcs=bcs, device=card)


@pytest.mark.cuda
def test_cuda_replays_take_new_inputs_of_one_key(card):
    eng = _direct_engine(card)
    shape = tuple(eng.h.fine_shape)
    for seed in range(5):
        u, rhs = _fields(shape, seed, card)
        want = _eager(eng, u, rhs, u)
        got = eng.t_vcycle_du(u, rhs, 1e-6, 50, u)
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
        assert got[1] is False
    assert _graph_counts() == (1, 4, 0)  # seed 0 eager, 1 captured and replayed, 2-4 replayed


@pytest.mark.cuda
def test_cuda_a_second_lane_count_captures_its_own_graph(card):
    eng = _direct_engine(card, ndim=2, n=220)
    for lanes in (3, 3, 5, 5, 3, 5):
        u, rhs = _fields((lanes,) + tuple(eng.h.fine_shape), lanes, card)
        want = _eager(eng, u, rhs, u)
        got = eng.t_vcycle_du(u, rhs, 1e-6, 50, u)
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert _graph_counts() == (2, 4, 0) and len(eng._graphs._state) == 2


@pytest.mark.cuda
def test_cuda_a_kept_output_is_not_overwritten_by_later_replays(card):
    eng = _direct_engine(card)
    u, rhs = _fields(tuple(eng.h.fine_shape), 9, card)
    outs = []
    for _ in range(4):
        u_new, _, du = eng.t_vcycle_du(u, rhs, 1e-6, 50, u)
        outs.append((u_new, du, u_new.clone(), du.clone()))
        u = u_new
    for u_new, du, u_copy, du_copy in outs:
        assert torch.equal(u_new, u_copy) and torch.equal(du, du_copy)
    assert _graph_counts() == (1, 3, 0)


@pytest.mark.cuda
def test_cuda_graphs_and_their_memory_go_with_their_engine(card):
    eng = _direct_engine(card, n=129)
    u, rhs = _fields(tuple(eng.h.fine_shape), 2, card)
    for _ in range(3):
        eng.t_vcycle_du(u, rhs, 1e-6, 50, u)
    torch.cuda.synchronize()
    assert _graph_counts() == (1, 2, 0)  # eager, captured and replayed, replayed
    ref, alive = weakref.ref(eng), torch.cuda.memory_allocated()
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()
    # at least the static inputs (two fine arrays; the new state lives in
    # the first, the graph keeps no output array) are freed
    assert alive - torch.cuda.memory_allocated() >= 2 * u.numel() * u.element_size()


@pytest.mark.cuda
def test_cuda_a_capture_that_raises_runs_eagerly_with_the_eager_result(card, monkeypatch):
    real = MGEngine._cycle_du

    def reads_the_host(self, u, rhs):
        u_new, du = real(self, u, rhs)
        host_read(float, du)  # a host read: no stream capture takes it
        return u_new, du

    monkeypatch.setattr(MGEngine, "_cycle_du", reads_the_host)
    eng = _direct_engine(card)
    u, rhs = _fields(tuple(eng.h.fine_shape), 4, card)
    for _ in range(4):
        want = _eager(eng, u, rhs, u)
        got = eng.t_vcycle_du(u, rhs, 1e-6, 50, u)
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
        u = got[0]
    assert _graph_counts() == (0, 0, 1) and len(eng._graphs.errors) == 1
    assert P.counter(zc.LAUNCHES + "zc_smooth_residual_3d") == 2 * 4 * (eng.h.ngrids - 1)
