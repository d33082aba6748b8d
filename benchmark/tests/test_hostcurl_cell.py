"""The host-curl cell (``vp_hostcurl.n220``) on the CPU at 22^3, the split16
gate at 0 so that the encoding runs and 7 z slabs a component: a sound run
is correct and reads its four ``hostcurl.*`` metrics; ``correct`` comes out
false with split16's int16 correction dropped (q = 0: A crosses as float32),
with one z slab of B left unwritten, and under the lower-precision control;
and the new metrics read nothing on a program without the registry, the
spans or the counter."""

import numpy as np
import pytest
import torch

from benchmark.lib import harness, spec
from ndsm_tpu_torch.potential import vector_potential as VP
from ndsm_tpu_torch.utils import profiling

CELL = "vp_hostcurl.n220"
N = 22
SMALL = {"sizes": [N], "pool_per_size": 2, "warm_calls": 1, "check_per_size": 2,
         "trace_calls": 1}
# On the card "auto" batches the three component solves; the CPU run asks for it.
CARD_ROUTE = {"batch_components": "on"}
METRICS = ("hostcurl.encode_s", "hostcurl.fetch_s", "hostcurl.curl_s", "hostcurl.fresh_bytes")


@pytest.fixture(autouse=True)
def gates(monkeypatch):
    monkeypatch.setattr(VP, "SPLIT16_MIN_MB", 0.0)
    monkeypatch.setattr(VP, "FETCH_SLAB_MB", 1e-3)


def _run(traced=False, seed=2**31 + 77, overrides=None, mix=None):
    return harness.run(CELL, seed, 0.3, traced, device="cpu",
                       overrides={**CARD_ROUTE, **(overrides or {})},
                       mix_overrides={**SMALL, **(mix or {})})


def _gap_over_limit(r) -> bool:
    return any(v["value"] > v["limit"] for k, v in r["checks"].items() if k.endswith("_gap"))


def test_sound_traced_run_is_correct_and_reads_the_hostcurl_metrics():
    r = _run(traced=True)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert {m["name"] for m in spec.load_cell(CELL).per_layer} >= set(METRICS)
    got = {m: r["metrics"][m]["value"] for m in METRICS}
    assert got["hostcurl.encode_s"] > 0 and got["hostcurl.fetch_s"] > 0
    assert got["hostcurl.curl_s"] >= 0
    assert got["hostcurl.fresh_bytes"] == 2 * 8 * 3 * N ** 3  # float64 A and B
    assert r["metrics"]["drivers.host_syncs"]["value"] > 0


def test_int16_correction_dropped_is_incorrect(monkeypatch):
    """q = 0: the host rebuilds hi alone, A as a float32 wire gives it."""
    real = VP._split16

    def no_correction(A):
        hi, q, inv_scale = real(A)
        return hi, torch.zeros_like(q), inv_scale

    monkeypatch.setattr(VP, "_split16", no_correction)
    r = _run()
    assert not r["correct"] and r["checks"]["A_gap"]["value"] > r["checks"]["A_gap"]["limit"]


class _FreshPages:
    """numpy as ``_fetch_and_curl`` sees it, with ``empty`` giving what a
    fresh mapping of the size of 220^3's arrays holds: zeros."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def empty(shape, dtype=float):
        return np.zeros(shape, dtype=dtype)


def test_one_slab_of_B_left_unwritten_is_incorrect(monkeypatch):
    real = VP.curl_np_into

    def skip_first(A, dq, out, z0=0, z1=None):
        return out if z0 == 0 else real(A, dq, out, z0, z1)

    monkeypatch.setattr(VP, "np", _FreshPages())
    monkeypatch.setattr(VP, "curl_np_into", skip_first)
    r = _run()
    assert not r["correct"] and r["checks"]["B_gap"]["value"] > r["checks"]["B_gap"]["limit"]


def test_lower_precision_control_fails():
    """The program's own float32 path; its cycles stall at the float32 floor,
    so they are capped to keep the test short."""
    r = _run(overrides={"precision": "fp32", "ncycles_max": 40},
             mix={"warm_calls": 0, "check_per_size": 1})
    assert not r["correct"] and _gap_over_limit(r), r["checks"]


def _rec(fresh):
    stats = {"ndsm.hostcurl.encode": (1, 0.004, 0.001), "ndsm.hostcurl.fetch": (1, 0.05, 0.02),
             "ndsm.hostcurl.curl": (1, 0.03, 0.03)}
    if fresh:
        stats["ndsm.hostcurl.fresh_bytes"] = (fresh, 0.0, 0.0)
    return {"index": 0, "entry": "vector_potential", "wall_s": 1.0, "raised": False,
            "stats": stats}


def test_metrics_read_nothing_without_the_registry_or_the_counter(monkeypatch):
    run = {"walls": [0.1, 0.1], "traced_calls": []}
    monkeypatch.setattr(profiling, "calls", lambda: [_rec(100), _rec(300)])
    assert spec.reader("hostcurl.encode_s")(run) == pytest.approx(0.004)
    assert spec.reader("hostcurl.fetch_s")(run) == pytest.approx(0.05)
    assert spec.reader("hostcurl.curl_s")(run) == pytest.approx(0.03)
    assert spec.reader("hostcurl.fresh_bytes")(run) == pytest.approx(200.0)
    monkeypatch.setattr(profiling, "calls", lambda: [_rec(0), _rec(0)])
    assert spec.reader("hostcurl.fresh_bytes")(run) == 0.0
    monkeypatch.setattr(profiling, "calls", lambda: [
        {"index": 0, "entry": "vector_potential", "wall_s": 1.0, "raised": False,
         "stats": {}}] * 2)  # a program without the spans
    for m in METRICS[:3]:
        assert spec.reader(m)(run) is None
    monkeypatch.delattr(profiling, "HOSTCURL_FRESH_BYTES")  # a program without the counter
    assert spec.reader("hostcurl.fresh_bytes")(run) is None
    monkeypatch.delattr(profiling, "calls")  # a program without the registry
    for m in METRICS:
        assert spec.reader(m)(run) is None
