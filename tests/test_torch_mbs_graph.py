"""The 3D lane V-cycle's CUDA graphs (mg/graphs.py,
``MultiBCSolver._vcycle_du``).

On the CPU: which solvers hold graphs (none on the CPU); that a solver
asks for them from its second solve on; that a CPU solve
moves no graph counter and keeps the eager iterates, the plain levels'
lane freezing that of ``fused.lane_sweeps`` / ``lane_residual``; that a
key holds the pattern of active lanes (two patterns, two captures; one
pattern again, the same graph) and that the solver asks for its graph
with that pattern; the static inputs' copy skip (an unchanged input is not
copied, one modified in place or another tensor is); and that a solver and
its graphs make no reference cycle.

On a card (``-m cuda``): a ``MultiBCSolver.solve`` of three Ax/Ay/Az
lanes at 33^3 and 65^3 (a solver's first solve eager, its second
replayed) bitwise the eager one in ``u``, du, ``cycles`` and
``coarse_noconv`` on the fused and the colour-split route, with lanes
freezing at different cycles so that two patterns or more replay;
``vector_potential`` at 64^3, called twice, bitwise with graphs on and
off; the gate on a
card; two patterns replayed in turns sharing one pool; a kept output
surviving later replays; the graphs' memory freed with their solver; and a
capture made to raise running eagerly with the eager result.

The file imports neither JAX nor ``ndsm_tpu``, so its card tests also run
on a host without them: ``python -m pytest --noconftest
tests/test_torch_mbs_graph.py -m cuda``."""

import gc
import weakref

import numpy as np
import pytest
import torch

from ndsm_tpu_torch import GridHierarchy, Options, vector_potential
from ndsm_tpu_torch.mg import graphs, poisson
from ndsm_tpu_torch.mg.batched import MultiBCSolver
from ndsm_tpu_torch.mg.graphs import CycleGraphs
from ndsm_tpu_torch.ops import fused
from ndsm_tpu_torch.potential import vector_potential as vp_module
from ndsm_tpu_torch.utils import profiling as P
from ndsm_tpu_torch.utils.profiling import host_read
from ndsm_tpu_torch.utils.testing import potential_field_case

GRAPH = (P.GRAPH_CAPTURES, P.GRAPH_REPLAYS, P.GRAPH_FAILED)
#: The component lanes Ax, Ay, Az: Neumann on the faces normal to the
#: component, Dirichlet elsewhere.
COMPONENT_BCS = [
    tuple(("N", "N") if (2 - ax) == c else ("D", "D") for ax in range(3)) for c in range(3)
]
#: Each lane's amplitude of Dirichlet data: the lanes converge at
#: different cycles (at 33^3 and 65^3 the patterns (T, T, T), (F, T, T)
#: and (F, T, F) each come more than once).
AMPS = (1e-4, 1.0, 1e-2)


def _graph_counts():
    return tuple(P.counter(n) for n in GRAPH)


def _solver(n=17, device="cpu", **opts):
    x = np.linspace(0.0, 1.0, n)
    h = GridHierarchy.from_mesh([x] * 3, ngrids=opts.pop("ngrids", None))
    o = Options(**{"precision": "mixed", "vc_tol": 1e-10, "ex_tol": 1e-13, "ms": 5, **opts})
    return MultiBCSolver(h, COMPONENT_BCS, o, device=device)


def _u0(n, seed=3):
    """Random Dirichlet data on each component's Dirichlet faces, lane b
    scaled by ``AMPS[b]``."""
    rng = np.random.default_rng(seed)
    u0s = []
    for c, a in enumerate(AMPS):
        u0 = np.zeros((n, n, n))
        if c != 2:
            u0[0] = a * rng.standard_normal((n, n))
            u0[-1] = a * rng.standard_normal((n, n))
        if c != 1:
            u0[:, 0] = a * rng.standard_normal((n, n))
        if c != 0:
            u0[:, :, 0] = a * rng.standard_normal((n, n))
        u0s.append(u0)
    return np.stack(u0s)


def _fields(shape, seed, device="cpu", dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)
    rhs = torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)
    return u.to(device).contiguous(), rhs.to(device).contiguous()


def _eager(mbs, u, rhs, act):
    u_new, noconv = mbs._vcycle(u, rhs, 1e-13, 50, act)
    return u_new, noconv, mbs._metric(u_new, u, act)


class _Recorder:
    """A stand-in for ``CycleGraphs`` that records each ``get``'s tag and
    replays nothing."""

    def __init__(self):
        self.tags = []

    def get(self, fn, *xs, tag=None):
        self.tags.append(tag)
        return None


# ----------------------------------------------------------------------
# CPU: the gate, the eager iterates, the keys, the copy skip
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["direct", "relax_coarse", "one_level"])
def test_no_solver_holds_graphs_on_the_cpu(kind):
    opts = {"direct": {}, "relax_coarse": {"coarse_solver": "relax"},
            "one_level": {"ngrids": 1}}[kind]
    mbs = _solver(n=9, **opts)
    assert mbs.coarse_direct == (kind != "relax_coarse")
    assert mbs._graphs is None


def test_a_cpu_solve_moves_no_graph_counter_and_keeps_the_eager_iterates():
    """Each cycle of a CPU solve through ``_vcycle_du`` equals the eager
    ``_vcycle`` and metric bit for bit, asking a stand-in for its graph with
    the cycle's pattern; a real ``CycleGraphs`` gives CPU tensors none and
    keeps no key; no graph counter moves."""
    P.reset()
    mbs = _solver()
    real, rec = CycleGraphs(), _Recorder()
    calls = []
    vcycle_du = mbs._vcycle_du

    def checked(u, rhs, ex_tol, nmax_exact, act):
        want = _eager(mbs, u, rhs, act)
        assert real.get(mbs._cycle_du, u, rhs, tag=tuple(act)) is None
        got = vcycle_du(u, rhs, ex_tol, nmax_exact, act)
        assert torch.equal(got[0], want[0]) and got[1] == want[1] and got[2] == want[2]
        calls.append(tuple(act))
        return got

    mbs._graphs, mbs._vcycle_du, mbs._solved = rec, checked, True
    u, infos = mbs.solve(_u0(17))
    assert all(i.ierr == 0 for i in infos)
    assert rec.tags == calls and len(set(calls)) >= 2
    assert real._state == {} and _graph_counts() == (0, 0, 0)
    assert not any(k.startswith("ndsm.graph.") for k in P.stats())


def test_a_solver_asks_for_graphs_from_its_second_solve():
    """A solver's first solve runs eagerly and asks for no graph (one
    built for a single solve captures nothing); its second asks at every
    cycle, with the cycle's pattern; both give the same answer."""
    mbs = _solver()
    mbs._graphs = rec = _Recorder()
    assert not mbs._solved
    u1, infos1 = mbs.solve(_u0(17))
    assert rec.tags == [] and mbs._solved
    u2, infos2 = mbs.solve(_u0(17))
    assert len(rec.tags) >= max(i.cycles for i in infos2)  # one ask a cycle
    assert all(isinstance(t, tuple) and len(t) == 3 for t in rec.tags)
    assert rec.tags[0] == (True, True, True) and len(set(rec.tags)) >= 2
    assert torch.equal(u1, u2) and [i.cycles for i in infos1] == [i.cycles for i in infos2]


@pytest.mark.parametrize("precision", ["fp64", "mixed"])
def test_plain_levels_freeze_lanes_as_the_lane_wrappers_do(precision):
    """The plain levels' kept pattern masks give ``fused.lane_sweeps`` and
    ``lane_residual`` with ``active`` bit for bit, and a pattern's mask is
    made once."""
    mbs = _solver(precision=precision, coarse_solver="direct")
    dt = mbs.inner_dtype
    for level in range(mbs.h.ngrids):
        u, rhs = _fields((3,) + tuple(mbs.h.shapes[level]), level, dtype=torch.float64)
        u, rhs = u.to(dt), rhs.to(dt)
        dq, masks = mbs._dq[level], mbs._masks[level]
        for act in [(True, True, True), (False, True, True), (True, False, False)]:
            want = fused.lane_sweeps(u, rhs, dq, masks, 3, act)
            got = fused.lane_sweeps(u, rhs, dq, mbs._lane_masks(level, act), 3)
            assert torch.equal(got, want)
            want_r = fused.lane_residual(u, rhs, dq, masks, act)
            assert torch.equal(fused.lane_residual(u, rhs, dq, mbs._lane_masks(level, act)),
                               want_r)
    sel = mbs._sel((False, True, True))
    assert mbs._sel([False, True, True]) is sel and sel.shape == (3, 1, 1, 1)
    assert sel.dtype == torch.bool and sel.flatten().tolist() == [False, True, True]


class _Fake:
    """Stand-in CUDA input: what ``CycleGraphs.get`` reads of a tensor."""

    is_cuda = True
    dtype = torch.float32
    device = "cuda:0"

    def __init__(self, *shape):
        self.shape = shape


def test_the_key_holds_the_pattern_of_active_lanes(monkeypatch):
    captured = []
    made = {}

    def capture(self, fn, key, xs):
        captured.append(key)
        return made.setdefault(key, object())

    monkeypatch.setattr(CycleGraphs, "_capture", capture)
    cg = CycleGraphs()
    xs = (_Fake(3, 9, 9, 9), _Fake(3, 9, 9, 9))
    ttt, ftt = (True, True, True), (False, True, True)
    assert cg.get(None, *xs, tag=ttt) is None and captured == []  # first sight: eager
    g1 = cg.get(None, *xs, tag=ttt)
    assert g1 is not None and len(captured) == 1
    assert cg.get(None, *xs, tag=ftt) is None and len(captured) == 1  # a new pattern: eager
    g2 = cg.get(None, *xs, tag=ftt)
    assert g2 is not None and g2 is not g1 and len(captured) == 2  # its own capture
    assert cg.get(None, *xs, tag=ttt) is g1 and cg.get(None, *xs, tag=ftt) is g2
    assert len(captured) == 2 and captured[0][-1] == ttt and captured[1][-1] == ftt
    # without a tag (the engine's cycles) the key is the inputs' alone
    assert cg.get(None, *xs) is None and cg.get(None, *xs) is not None
    assert captured[2] == tuple(((3, 9, 9, 9), torch.float32, "cuda:0") for _ in xs)


def test_a_replay_skips_an_unchanged_input_and_copies_a_changed_or_other_one():
    x, r = torch.arange(12.0).reshape(3, 4), torch.ones(3, 4)
    ins = graphs._Inputs((x, r), "cpu")
    ins.fill((x, r))
    assert torch.equal(ins.tensors[0], x) and torch.equal(ins.tensors[1], r)

    def mark():  # overwrite the static inputs: a copy shows as their values again
        for s in ins.tensors:
            s.fill_(-7.0)

    def copied():
        return [not torch.equal(s, torch.full_like(s, -7.0)) for s in ins.tensors]

    mark()
    ins.fill((x, r))
    assert copied() == [False, False]  # the same tensors, unchanged: skipped
    x.add_(1.0)  # in place: copied again
    ins.fill((x, r))
    assert copied() == [True, False] and torch.equal(ins.tensors[0], x)
    mark()
    r[1].fill_(3.0)  # a view written in place moves its base's version
    ins.fill((x, r))
    assert copied() == [False, True] and torch.equal(ins.tensors[1], r)
    mark()
    torch.autograd.graph.increment_version(x)  # a kernel's write through a pointer
    ins.fill((x, r.clone()))  # and another tensor of the same values
    assert copied() == [True, True]
    mark()
    with torch.inference_mode():
        xi = torch.zeros(3, 4)
    ins.fill((xi, r))
    ins.tensors[0].fill_(-7.0)
    ins.fill((xi, r))  # an inference tensor has no version: always copied
    assert copied() == [True, True] and torch.equal(ins.tensors[0], xi)


def test_a_replay_under_inference_mode_copies_its_state_in_again():
    """A state returned under ``torch.inference_mode()`` has no version: the
    next cycle on it copies it in, as any input without one."""
    ins = graphs._Inputs((torch.zeros(2, 3), torch.ones(2, 3)), "cpu")

    class Doubles:
        def replay(self):
            ins.tensors[0].mul_(2.0).add_(ins.tensors[1])

    g = graphs._Graph(Doubles(), ins, (), ())
    with torch.inference_mode():
        u, rhs = torch.ones(2, 3), torch.ones(2, 3)
        (u1,) = g.replay(u, rhs)
        ins.tensors[0].fill_(-7.0)
        (u2,) = g.replay(u1, rhs)
    assert torch.equal(u1, torch.full((2, 3), 3.0)) and torch.equal(u2, torch.full((2, 3), 7.0))


def test_a_solver_and_its_graphs_make_no_reference_cycle():
    """The graphs go with their solver when the last reference to it goes
    (the solver cache evicting it), not at a later garbage collection."""
    mbs = _solver()
    mbs._graphs, mbs._solved = CycleGraphs(), True
    u, rhs = _fields((3,) + tuple(mbs.h.fine_shape), 1)
    mbs._vcycle_du(u, rhs, 1e-13, 50, [True, False, True])
    mbs._sel([True, False, True])
    ref = weakref.ref(mbs)
    gc.disable()
    try:
        del mbs
        assert ref() is None
    finally:
        gc.enable()


# ----------------------------------------------------------------------
# On a card
# ----------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for c in (poisson._ENGINE_CACHE, poisson._BVP_CACHE, vp_module._MBS_CACHE):
        c.clear()
    P.reset()
    yield torch.device("cuda", torch.cuda.current_device())
    for c in (poisson._ENGINE_CACHE, poisson._BVP_CACHE, vp_module._MBS_CACHE):
        c.clear()


def _eager_only(monkeypatch):
    monkeypatch.setattr(CycleGraphs, "get", lambda self, fn, *xs, tag=None: None)


def _spy(monkeypatch):
    """The patterns whose graph a solver replays, in order."""
    replayed = []
    get = CycleGraphs.get

    def spy(self, fn, *xs, tag=None):
        g = get(self, fn, *xs, tag=tag)
        if g is not None:
            replayed.append(tag)
        return g

    monkeypatch.setattr(CycleGraphs, "get", spy)
    return replayed


@pytest.mark.cuda
@pytest.mark.parametrize("smoother", ["auto", "compact"])
@pytest.mark.parametrize("n", [33, 65])
def test_cuda_graphed_mbs_solve_is_bitwise_the_eager_one(card, monkeypatch, n, smoother):
    u0 = _u0(n)
    mbs = _solver(n, "cuda", smoother=smoother)
    first, _ = mbs.solve(u0)  # a new solver's first solve: eager, no graph
    assert _graph_counts() == (0, 0, 0)
    replayed = _spy(monkeypatch)
    u, infos = mbs.solve(u0)
    counts, errors = _graph_counts(), dict(mbs._graphs.errors)
    P.reset()
    _eager_only(monkeypatch)
    u_e, infos_e = _solver(n, "cuda", smoother=smoother).solve(u0)
    assert counts[2] == 0, errors
    assert len(set(replayed)) >= 2 and counts[1] == len(replayed)
    assert counts[0] == len(mbs._graphs._state) - sum(
        g is None for g in mbs._graphs._state.values())
    assert _graph_counts() == (0, 0, 0)
    assert torch.equal(u, u_e) and torch.equal(first, u_e)
    for i, ie in zip(infos, infos_e):
        assert i.ierr == ie.ierr == 0
        assert i.cycles == ie.cycles and i.du_last == ie.du_last
        assert i.coarse_noconv == ie.coarse_noconv


@pytest.mark.cuda
def test_cuda_vector_potential_is_bitwise_with_graphs_on_and_off(card, monkeypatch):
    n = 64
    x = np.linspace(0.0, 1.0, n)
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    _, b = potential_field_case(X, Y, Z)
    opts = Options(precision="mixed")
    vector_potential(x, x, x, b, options=opts)  # builds the solver: eager
    replayed = _spy(monkeypatch)
    ierr, A, B, info = vector_potential(x, x, x, b, options=opts, full_output=True)
    counts = _graph_counts()
    assert any(t is not None for t in replayed)  # the solver's lane cycles replayed
    for c in (poisson._ENGINE_CACHE, poisson._BVP_CACHE, vp_module._MBS_CACHE):
        c.clear()
    _eager_only(monkeypatch)
    ierr_e, A_e, B_e, info_e = vector_potential(x, x, x, b, options=opts, full_output=True)
    assert ierr == ierr_e == 0 and counts[1] > 0 and counts[2] == 0
    assert np.array_equal(A, A_e) and np.array_equal(B, B_e)
    assert [i.cycles for i in info.components] == [i.cycles for i in info_e.components]
    assert [i.du_last for i in info.components] == [i.du_last for i in info_e.components]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["direct", "relax_coarse", "one_level"])
def test_cuda_solvers_hold_graphs_where_the_cycle_reads_nothing_on_the_host(card, kind):
    opts = {"direct": {}, "relax_coarse": {"coarse_solver": "relax"},
            "one_level": {"ngrids": 1}}[kind]
    mbs = _solver(n=9, device="cuda", **opts)
    assert (mbs._graphs is not None) == (kind == "direct")


@pytest.mark.cuda
def test_cuda_two_patterns_in_turns_share_the_pool_and_keep_their_outputs(card):
    mbs = _solver(65, "cuda")
    mbs._solved = True  # as a solver that has ended a solve
    shape = (3,) + tuple(mbs.h.fine_shape)
    pats = [(True, True, True), (False, True, False)]
    # new inputs every other cycle: the second pattern of a pair finds them
    # in the shared static inputs already
    fields = [_fields(shape, seed, card) for seed in range(4)]
    kept = []
    for i in range(8):
        act = pats[i % 2]
        u, rhs = fields[i // 2]
        want = _eager(mbs, u, rhs, act)
        got = mbs._vcycle_du(u, rhs, 1e-13, 50, act)
        assert torch.equal(got[0], want[0]) and got[1] == want[1] and got[2] == want[2]
        kept.append((got[0], got[0].clone()))
    assert _graph_counts() == (2, 6, 0)  # each pattern: eager, captured and replayed, replayed x2
    done = [g for g in mbs._graphs._state.values() if isinstance(g, graphs._Graph)]
    assert len(done) == 2 and done[0].inputs is done[1].inputs  # one static input set
    assert all(len(g.outputs) == 1 and g.outputs[0].dim() == 1 for g in done)  # du alone
    assert done[0].graph.pool() == done[1].graph.pool()  # one pool
    for u_new, copy in kept:  # no later replay overwrote a kept output
        assert torch.equal(u_new, copy)


@pytest.mark.cuda
def test_cuda_graphs_and_their_memory_go_with_their_solver(card):
    mbs = _solver(129, "cuda")
    mbs._solved = True  # as a solver that has ended a solve
    u, rhs = _fields((3,) + tuple(mbs.h.fine_shape), 2, card)
    for act in [(True, True, True)] * 3 + [(True, False, True)] * 3:
        mbs._vcycle_du(u, rhs, 1e-13, 50, act)
    torch.cuda.synchronize()
    assert _graph_counts() == (2, 4, 0)
    ref, alive = weakref.ref(mbs), torch.cuda.memory_allocated()
    gc.disable()
    try:
        del mbs
        assert ref() is None
    finally:
        gc.enable()
    # at least the two patterns' shared static inputs (two stacks) are freed
    assert alive - torch.cuda.memory_allocated() >= 2 * u.numel() * u.element_size()


@pytest.mark.cuda
def test_cuda_a_capture_that_raises_runs_eagerly_with_the_eager_result(card, monkeypatch):
    real = MultiBCSolver._cycle_du

    def reads_the_host(self, u, rhs, act):
        u_new, du = real(self, u, rhs, act)
        host_read(du.tolist)  # a host read: no stream capture takes it
        return u_new, du

    monkeypatch.setattr(MultiBCSolver, "_cycle_du", reads_the_host)
    mbs = _solver(33, "cuda")
    mbs._solved = True  # as a solver that has ended a solve
    u, rhs = _fields((3,) + tuple(mbs.h.fine_shape), 4, card)
    act = (True, True, False)
    for _ in range(4):
        want = _eager(mbs, u, rhs, act)
        got = mbs._vcycle_du(u, rhs, 1e-13, 50, act)
        assert torch.equal(got[0], want[0]) and got[1] == want[1] and got[2] == want[2]
        u = got[0]
    assert _graph_counts() == (0, 0, 1) and len(mbs._graphs.errors) == 1
