"""``drivers.graph_replays``: the mean over the window's calls of the
program's ``ndsm.graph.replays`` counter; 0 where the program counts no
replay (a program without graphs, a cell whose cycles all run eagerly),
nothing where the registry holds too few records or is absent; and a
traced CPU run, whose cycles run eagerly, reading 0."""

import pytest

from benchmark.lib import harness, spec
from ndsm_tpu_torch.utils import profiling

NAME = "drivers.graph_replays"


def _rec(replays):
    stats = {"ndsm.vcycle": (15, 0.01, 0.01)}
    if replays is not None:
        stats["ndsm.graph.replays"] = (replays, 0.0, 0.0)
    return {"index": 0, "entry": "solve_poisson_bvp", "wall_s": 0.1, "raised": False,
            "stats": stats}


def _run(n_window, n_traced):
    return {"walls": [0.1] * n_window, "traced_calls": [{}] * n_traced}


def test_reads_the_mean_replays_of_the_window(monkeypatch):
    # warm-up (the capture's call: 13 replays), the window's 3, 2 traced
    recs = [_rec(13), _rec(14), _rec(14), _rec(15), _rec(99), _rec(99)]
    monkeypatch.setattr(profiling, "calls", lambda: list(recs))
    got = spec.reader(NAME)(_run(3, 2))
    assert isinstance(got, float) and got == pytest.approx(43 / 3)


def test_a_program_without_the_counter_reads_zero(monkeypatch):
    monkeypatch.setattr(profiling, "calls", lambda: [_rec(None)] * 4)
    assert spec.reader(NAME)(_run(3, 1)) == 0.0


def test_too_few_records_or_no_registry_read_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "calls", lambda: [_rec(14)] * 2)
    assert spec.reader(NAME)(_run(3, 1)) is None
    monkeypatch.delattr(profiling, "calls")
    assert spec.reader(NAME)(_run(1, 0)) is None


def test_every_cell_reports_it():
    for w in spec.load_benchmark()["workloads"]:
        assert NAME in [m["name"] for m in spec.load_cell(w["name"]).per_layer], w["name"]


def test_a_traced_cpu_run_reads_zero():
    mix = {"sizes": [17], "pool_per_size": 2, "warm_calls": 1, "check_per_size": 1,
           "trace_calls": 1}
    r = harness.run("poisson3d.ax257", 2**31 + 777, 0.3, True, device="cpu", mix_overrides=mix)
    assert r["correct"], r["checks"]
    assert r["metrics"][NAME]["value"] == 0.0
