"""``ndsm_tpu_torch.utils.profiling``'s registry of spans and counters on
the CPU: span counts and inclusive and self seconds under nesting, the
per-call records, that no profiler range opens while none records, the
``ndsm.sync`` counts a mixed solve's cycles and defect groups imply, the
``ndsm.upload`` span, the ``ndsm.rebuild`` counter, and that under the
default trace no range but ``ndsm.sync`` opens inside the solve phases
(a trace gives each kernel to its innermost range) and no ``ndsm.sync``
encloses a computing operation."""

import bisect
import json
import math
import time

import numpy as np
import pytest
import torch

from ndsm_tpu_torch import solve_poisson_bvp, vector_potential
from ndsm_tpu_torch.options import Options
from ndsm_tpu_torch.utils import profiling as P
from ndsm_tpu_torch.utils.caching import BoundedCache

torch.set_num_threads(1)

#: What a host read runs: the scalar read, a list's conjugation views,
#: and the copy of ``.cpu()``.
READ_OPS = {"aten::item", "aten::_local_scalar_dense", "aten::is_nonzero", "aten::resolve_conj",
            "aten::resolve_neg", "aten::to", "aten::_to_copy", "aten::copy_",
            "aten::empty_strided", "aten::empty"}


def _box(n, seed=0):
    x = np.linspace(0.0, 1.0, n)
    b = np.random.default_rng(seed).standard_normal((3, n, n, n))
    return x, b


def _vp(n=8, **kw):
    x, b = _box(n)
    opts = Options(precision="mixed", batch_components="on", **kw)
    return vector_potential(x, x, x, b, options=opts, device="cpu", full_output=True)


def _solve(n, bcs, seed=0):
    x = np.linspace(0.0, 1.0, n)
    rhs = np.random.default_rng(seed).standard_normal((n, n, n))
    if all(tuple(b) == ("N", "N") for b in bcs):
        rhs -= rhs.mean()
    opts = Options(precision="mixed")
    u, info = solve_poisson_bvp(np.zeros((n, n, n)), rhs, (x, x, x), bcs, options=opts,
                                device="cpu")
    return info, P.calls()[-1], opts


def test_span_counts_inclusive_and_self_seconds_under_nesting():
    P.reset("test.")
    for _ in range(2):
        with P.span("test.outer"):
            time.sleep(0.01)
            with P.span("test.inner"):
                time.sleep(0.02)
    st = P.stats()
    n_out, incl_out, self_out = st["test.outer"]
    n_in, incl_in, self_in = st["test.inner"]
    assert n_out == 2 and n_in == 2
    assert incl_in >= 0.04 and self_in == incl_in  # nothing nested in it
    assert incl_out >= incl_in + 0.02
    assert self_out == pytest.approx(incl_out - incl_in, abs=1e-12)
    with P.span("test.same"):  # the same name nested: a frame of its own
        with P.span("test.same"):
            time.sleep(0.01)
    n, incl, own = P.stats()["test.same"]
    assert n == 2 and incl >= 0.02 and 0.01 <= own < incl
    P.count("test.counter", 3)
    P.count("test.counter")
    assert P.counter("test.counter") == 4 and P.stats()["test.counter"] == (4, 0.0, 0.0)
    P.reset("test.")
    assert P.counter("test.counter") == 0 and "test.outer" not in P.stats()


def test_per_call_records_and_a_call_that_raises():
    P.reset()
    with P.call("first"):
        P.count("test.c", 2)
        with P.call("nested"):  # a nested entry opens no second record
            with P.span("test.s"):
                pass
    with pytest.raises(RuntimeError):
        with P.call("second"):
            P.count("test.c")
            raise RuntimeError("a call that raises")
    P.count("test.c", 5)  # outside any call: the totals only
    first, second = P.calls()
    assert (first["entry"], first["raised"], second["entry"], second["raised"]) == (
        "first", False, "second", True)
    assert second["index"] == first["index"] + 1
    assert first["stats"]["test.c"] == (2, 0.0, 0.0) and first["stats"]["test.s"][0] == 1
    assert second["stats"] == {"test.c": (1, 0.0, 0.0)}
    assert first["wall_s"] >= first["stats"]["test.s"][1]
    assert P.counter("test.c") == 8
    for _ in range(P.CALLS_KEPT + 5):
        with P.call("many"):
            pass
    recs = P.calls()
    assert len(recs) == P.CALLS_KEPT and recs[-1]["index"] == second["index"] + P.CALLS_KEPT + 5
    assert [r["index"] for r in recs] == list(range(recs[0]["index"], recs[-1]["index"] + 1))
    P.reset()
    assert P.calls() == []


def test_no_profiler_range_while_none_records(monkeypatch):
    """With no profiler recording, a span never reaches
    ``record_function``; under one, exactly the names of ``RANGES`` do."""

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for name in sorted(P.RANGES | P.DETAIL_RANGES) + ["test.other"]:
        with P.span(name):
            pass
    info, rec, _ = _solve(9, (("D", "D"), ("D", "D"), ("N", "N")))
    assert info.ierr == 0 and rec["stats"][P.SYNC][0] > 0

    opened = []

    class Recorded:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Recorded)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for name in sorted(P.RANGES | P.DETAIL_RANGES) + ["test.other"]:
            with P.span(name):
                pass
    assert sorted(opened) == sorted(P.RANGES)


@pytest.mark.parametrize("bcs, per_group", [
    ((("D", "D"), ("D", "D"), ("N", "N")), 1),  # the df route: max|r| once a group
    ((("N", "N"),) * 3, 4),  # all-Neumann: k + 1 tests of the lanes, k, noconv, du
])
def test_sync_counts_follow_cycles_and_defect_groups(bcs, per_group):
    """A mixed 17^3 solve reads du once a V-cycle and ``per_group`` more
    values a defect group of up to ``mixed_inner_max`` V-cycles (the CPU
    has no synchronise to count)."""
    info, rec, opts = _solve(17, bcs)
    groups = math.ceil(info.cycles / opts.mixed_inner_max)
    assert info.ierr == 0 and info.cycles > opts.mixed_inner_max
    assert rec["entry"] == "solve_poisson_bvp"
    assert rec["stats"][P.SYNC][0] == info.cycles + per_group * groups
    assert rec["stats"][P.VCYCLE][0] == info.cycles
    syncs = rec["stats"][P.SYNC]
    assert syncs[1] == syncs[2] > 0  # a read encloses no other span


def test_upload_span_once_for_host_inputs_and_never_in_the_pipeline():
    bcs = (("D", "D"), ("D", "D"), ("N", "N"))
    _, rec, _ = _solve(9, bcs)
    assert rec["stats"][P.UPLOAD][0] == 1
    x = np.linspace(0.0, 1.0, 9)
    dev_rhs = torch.ones((9, 9, 9), dtype=torch.float64)
    solve_poisson_bvp(torch.zeros_like(dev_rhs), dev_rhs, (x, x, x), bcs,
                      options=Options(precision="mixed"), device="cpu")
    assert P.UPLOAD not in P.calls()[-1]["stats"]
    ierr, _, _, _ = _vp()
    rec = P.calls()[-1]
    assert ierr == 0 and rec["entry"] == "vector_potential"
    assert P.UPLOAD not in rec["stats"] and rec["stats"][P.FETCH][0] == 1
    for name in (P.FACES, P.CHI, P.SOLVE3D, P.POST):
        assert rec["stats"][name][0] == 1


def test_rebuild_counts_misses_on_evicted_keys():
    P.reset(P.REBUILD)
    cache = BoundedCache(maxsize=2)
    gets = 0
    for rnd in range(3):
        for key in ("a", "b", "c"):
            gets += rnd > 0
            if cache.get(key) is None:
                cache.put(key, key.upper())
    assert P.counter(P.REBUILD) == gets == 6
    P.reset(P.REBUILD)
    for _ in range(4):
        assert cache.get("c") == "C"
    assert cache.get("never") is None
    assert P.counter(P.REBUILD) == 0
    cache.clear()
    assert cache.get("a") is None and P.counter(P.REBUILD) == 0


def test_a_repeated_size_rebuilds_nothing():
    _vp()
    _vp()
    stats = P.calls()[-1]["stats"]
    assert P.REBUILD not in stats and P.BUILD not in stats


def _trace_events(tmp_path, detail):
    with P.trace(str(tmp_path), detail=detail):
        ierr, _, _, _ = _vp()
    assert ierr == 0
    (path,) = tmp_path.glob("*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    ops = sorted((e for e in events if e.get("cat") == "cpu_op"), key=lambda e: e["ts"])
    return ranges, ops


def _within(outer, inner) -> bool:
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_default_trace_leaves_the_solve_phases_their_kernels(tmp_path):
    _vp()  # the caches warm
    ranges, ops = _trace_events(tmp_path / "default", detail=False)
    names = {e["name"] for e in ranges}
    assert {P.FACES, P.CHI, P.SOLVE3D, P.POST, P.FETCH, P.SYNC} <= names
    assert names <= P.RANGES
    phases = [e for e in ranges if e["name"] in (P.CHI, P.SOLVE3D)]
    assert len(phases) == 2
    for p in phases:
        inside = {e["name"] for e in ranges if e is not p and _within(p, e)}
        assert inside == {P.SYNC}
    for e in ranges:  # the other ranges lie outside the solve phases
        if e["name"] not in (P.CHI, P.SOLVE3D, P.SYNC):
            assert not any(_within(p, e) or _within(e, p) for p in phases)
    starts = [o["ts"] for o in ops]
    syncs = [e for e in ranges if e["name"] == P.SYNC]
    assert syncs
    for s in syncs:
        i = bisect.bisect_left(starts, s["ts"])
        while i < len(ops) and ops[i]["ts"] <= s["ts"] + s["dur"]:
            if _within(s, ops[i]):
                assert ops[i]["name"] in READ_OPS, ops[i]["name"]
            i += 1

    ranges, _ = _trace_events(tmp_path / "detail", detail=True)
    assert sum(e["name"] == P.VCYCLE for e in ranges) > 0
    assert not P.DETAIL_RANGES & set(P._ranges)  # the detail ranges closed again
