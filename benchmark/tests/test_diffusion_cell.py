"""The injected-operator cell (``diffusion3d.strat257``) on the CPU at 17^3:
a sound run is correct and reads its two ``operator.*`` metrics; its
traffic is the same for the same seed; ``correct`` comes out false with
the operator's coefficient scaled by 1.01 on the finest level (whose
float64 defect fixes the answer; a coarse level's fault would only slow
the convergence) and under the lower-precision control; and the new
metrics read nothing on a program without the registry or the counter."""

import numpy as np
import pytest
import torch

from benchmark.lib import harness, spec
from benchmark.lib.traffic import Traffic
from ndsm_tpu_torch.utils import profiling

CELL = "diffusion3d.strat257"
SMALL = {"sizes": [17], "pool_per_size": 2, "warm_calls": 1, "check_per_size": 2,
         "trace_calls": 1}
METRICS = ("operator.issue_s", "operator.term_builds")


def _run(traced=False, seed=2**31 + 77, overrides=None, mix=None):
    return harness.run(CELL, seed, 0.3, traced, device="cpu", overrides=overrides,
                       mix_overrides={**SMALL, **(mix or {})})


def test_sound_traced_run_is_correct_and_reads_the_operator_metrics():
    r = _run(traced=True)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert {m["name"] for m in spec.load_cell(CELL).per_layer} >= set(METRICS)
    got = {m: r["metrics"][m]["value"] for m in METRICS}
    assert got["operator.issue_s"] > 0
    # 17^3 has 3 levels: their float32 terms and the finest float64 ones
    assert got["operator.term_builds"] == 4.0
    assert r["metrics"]["drivers.issue_s"]["value"] > 0


def test_same_seed_same_problems():
    c = spec.load_cell(CELL)
    mix = {**c.mix, "sizes": [9], "pool_per_size": 3}
    a, b, other = (Traffic(mix, c.config, s) for s in (5, 5, 6))
    for x, y, z in zip(a.pools[9], b.pools[9], other.pools[9]):
        for key in ("rhs", "u_true"):
            assert np.array_equal(x.args[key], y.args[key])
            assert not np.array_equal(x.args[key], z.args[key])
        assert x.args["operator"] == c.config["operator"]


def test_coefficient_scaled_on_the_finest_level_is_incorrect(monkeypatch):
    from ndsm_tpu_torch.mg import operator

    real = operator._diffusion_halves

    def scaled(shape, coef, dtype, device, window=None):
        halves = real(shape, coef, dtype, device, window)
        if tuple(shape) == (17, 17, 17) and dtype == torch.float64:
            halves = [(1.01 * lo, 1.01 * hi) for lo, hi in halves]
        return halves

    monkeypatch.setattr(operator, "_diffusion_halves", scaled)
    r = _run()
    assert not r["correct"] and r["checks"]["u_gap"]["value"] > r["checks"]["u_gap"]["limit"]


def test_lower_precision_control_fails():
    """The program's own float32 path; its cycles stall at the float32 floor,
    so they are capped to keep the test short."""
    r = _run(overrides={"precision": "fp32", "ncycles_max": 40},
             mix={"warm_calls": 0, "check_per_size": 1})
    assert not r["correct"] and r["checks"]["u_gap"]["value"] > r["checks"]["u_gap"]["limit"]


def _rec(terms):
    stats = {"ndsm.op.relax": (300, 0.5, 0.5), "ndsm.op.residual": (20, 0.25, 0.25)}
    if terms:
        stats["ndsm.op.terms"] = (terms, 0.0, 0.0)
    return {"index": 0, "entry": "solve_poisson_bvp", "wall_s": 1.0, "raised": False,
            "stats": stats}


def test_metrics_read_nothing_without_the_registry_or_the_counter(monkeypatch):
    run = {"walls": [0.1, 0.1], "traced_calls": []}
    monkeypatch.setattr(profiling, "calls", lambda: [_rec(8), _rec(0)])
    assert spec.reader("operator.issue_s")(run) == pytest.approx(0.75)
    assert spec.reader("operator.term_builds")(run) == pytest.approx(4.0)
    monkeypatch.setattr(profiling, "calls", lambda: [_rec(0), _rec(0)])
    assert spec.reader("operator.term_builds")(run) == 0.0
    monkeypatch.delattr(profiling, "OP_TERMS")  # a program without the counter
    assert spec.reader("operator.term_builds")(run) is None
    monkeypatch.delattr(profiling, "calls")  # a program without the registry
    for m in METRICS:
        assert spec.reader(m)(run) is None
