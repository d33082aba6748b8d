"""The readers of the program's registry (``benchmark/lib/program.py`` and
the ``drivers.*`` metrics that read ``ndsm_tpu_torch.utils.profiling``'s
per-call records): the window's records sliced from between the warm-up
and the traced calls, too few records and a program without the registry
giving None, a cell without an upload giving None for ``drivers.upload_s``,
and a traced harness run on the CPU at a small size reading each metric."""

import pytest

from benchmark.lib import harness, program, spec
from ndsm_tpu_torch.utils import profiling

READERS = ("drivers.upload_s", "drivers.host_syncs", "drivers.sync_wait_s", "drivers.issue_s",
           "drivers.rebuilds")


def _rec(v, upload=True):
    stats = {"ndsm.sync": (int(v), 0.5 * v, 0.5 * v), "ndsm.vcycle": (int(v), 2.0 * v, v)}
    if upload:
        stats["ndsm.upload"] = (1, 0.25 * v, 0.25 * v)
    if v == 10:
        stats["ndsm.rebuild"] = (1, 0.0, 0.0)
    return {"index": 0, "entry": "solve_poisson_bvp", "wall_s": 3.0 * v, "raised": False,
            "stats": stats}


def _run(n_window, n_traced):
    return {"walls": [0.1] * n_window, "traced_calls": [{}] * n_traced}


def _stub(monkeypatch, recs):
    monkeypatch.setattr(profiling, "calls", lambda: list(recs))


def test_the_window_lies_between_warm_up_and_traced_calls(monkeypatch):
    # 2 warm-up calls (100), the window's 4 (10, 20, 20, 30), 3 traced (1000)
    recs = [_rec(100)] * 2 + [_rec(10), _rec(20), _rec(20), _rec(30)] + [_rec(1000)] * 3
    _stub(monkeypatch, recs)
    run = _run(4, 3)
    assert [r["stats"]["ndsm.sync"][0] for r in program.window_calls(run)] == [10, 20, 20, 30]
    got = {m: spec.reader(m)(run) for m in READERS}
    assert got["drivers.host_syncs"] == pytest.approx(20.0)
    assert got["drivers.sync_wait_s"] == pytest.approx(10.0)
    assert got["drivers.issue_s"] == pytest.approx(20.0)  # self seconds
    assert got["drivers.upload_s"] == pytest.approx(5.0)
    assert got["drivers.rebuilds"] == pytest.approx(0.25)
    assert all(isinstance(v, float) for v in got.values())
    _stub(monkeypatch, recs[2:6])  # no warm-up, no traced call
    assert spec.reader("drivers.host_syncs")(_run(4, 0)) == pytest.approx(20.0)


def test_too_few_records_or_no_registry_read_nothing(monkeypatch):
    _stub(monkeypatch, [_rec(10)] * 5)
    for m in READERS:
        assert spec.reader(m)(_run(4, 3)) is None
        assert spec.reader(m)(_run(0, 0)) is None
    monkeypatch.delattr(profiling, "calls")  # a program without the registry
    for m in READERS:
        assert spec.reader(m)(_run(1, 0)) is None


def test_a_cell_without_an_upload_reads_none_and_no_rebuild_reads_zero(monkeypatch):
    _stub(monkeypatch, [_rec(20, upload=False)] * 3)
    run = _run(3, 0)
    assert spec.reader("drivers.upload_s")(run) is None
    assert spec.reader("drivers.rebuilds")(run) == 0.0
    assert spec.reader("drivers.host_syncs")(run) == pytest.approx(20.0)


SMALL = {
    "poisson3d.ax257": ({"sizes": [17], "pool_per_size": 2, "warm_calls": 1, "check_per_size": 1,
                         "trace_calls": 2}, {}),
    "vp_test1.n220": ({"sizes": [22], "pool_per_size": 2, "warm_calls": 1, "check_per_size": 1,
                       "trace_calls": 1}, {"batch_components": "on"}),
}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_traced_cpu_run_reads_each_metric(cell):
    mix, overrides = SMALL[cell]
    r = harness.run(cell, 2**31 + 12345, 0.3, True, device="cpu", overrides=overrides,
                    mix_overrides=mix)
    assert r["correct"], r["checks"]
    want = [m["name"] for m in spec.load_cell(cell).per_layer if m["name"] in READERS]
    assert ("drivers.upload_s" in want) == cell.startswith("poisson3d.")
    for m in want:
        assert m in r["metrics"], (m, sorted(r["metrics"]))
    got = {m: r["metrics"][m]["value"] for m in want}
    assert got["drivers.host_syncs"] > 0 and got["drivers.sync_wait_s"] > 0
    assert got["drivers.issue_s"] > 0 and got["drivers.rebuilds"] == 0.0
    if "drivers.upload_s" in got:
        assert got["drivers.upload_s"] > 0
