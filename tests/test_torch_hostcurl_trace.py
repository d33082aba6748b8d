"""The registry's record of ``Options.host_curl`` (``utils.profiling``: the
``ndsm.hostcurl`` span, its ``encode``, ``fetch`` and ``curl`` spans and its
``slabs``, ``wire_bytes`` and ``fresh_bytes`` counters) on the CPU at 33^3,
with the split16 gate at 0 so that the encoding runs, and the answers of
that route against the benchmark's plain reference
(``benchmark/reference/vector_potential.py``) within the limits of the
``vp_hostcurl`` configuration.  Imports no JAX.

``FETCH_SLAB_MB`` is set so that 33^3 (0.86 MB of float64 A) cuts each
component into 8 z slabs, the 24 slab copies of 220^3."""

import functools
import json
import threading
from pathlib import Path

import numpy as np
import pytest

import ndsm_tpu_torch
from benchmark.reference import vector_potential as ref_vp
from ndsm_tpu_torch import Options
from ndsm_tpu_torch.potential import vector_potential as VP
from ndsm_tpu_torch.utils import profiling as P
from ndsm_tpu_torch.utils.testing import build_test_mesh, potential_field_case

N = 33
NSLAB = 8
CONFIG = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "configs"
                     / "vp_hostcurl.json").read_text())
SPANS = (P.HOSTCURL, P.HOSTCURL_ENCODE, P.HOSTCURL_FETCH, P.HOSTCURL_CURL)
COUNTERS = (P.HOSTCURL_SLABS, P.HOSTCURL_WIRE_BYTES, P.HOSTCURL_FRESH_BYTES)


@functools.lru_cache(maxsize=None)
def _case():
    x, y, z = build_test_mesh(N)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    return (x, y, z), potential_field_case(X, Y, Z)[1]


@functools.lru_cache(maxsize=None)
def _reference():
    (x, y, z), b = _case()
    return tuple(t.numpy() for t in ref_vp.vector_potential(x, y, z, b, device="cpu"))


@pytest.fixture
def gates(monkeypatch):
    monkeypatch.setattr(VP, "SPLIT16_MIN_MB", 0.0)
    monkeypatch.setattr(VP, "FETCH_SLAB_MB", 0.1)


def _call(**kw):
    """One public call with the configuration's options (the three component
    lanes batched, as on a card) and its record in the registry."""
    (x, y, z), b = _case()
    opts = Options(**{**CONFIG["options"], "batch_components": "on", **kw})
    out = ndsm_tpu_torch.vector_potential(x, y, z, b.copy(), options=opts, full_output=True,
                                          device="cpu")
    return out, P.calls()[-1]["stats"]


def _gap(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def test_split16_route_spans_counters_and_answers(gates, monkeypatch):
    opened = []
    real_span = P.span

    def span(name):
        if name.startswith(P.HOSTCURL):
            opened.append((name, threading.get_ident()))
        return real_span(name)

    monkeypatch.setattr(P, "span", span)
    (ierr, A, B, info), stats = _call()
    assert ierr == 0 and isinstance(A, np.ndarray) and isinstance(B, np.ndarray)
    A_ref, B_ref = _reference()
    limits = CONFIG["limits"]
    assert _gap(A, A_ref) <= limits["A_gap"] and _gap(B, B_ref) <= limits["B_gap"]
    for name in SPANS:
        assert stats[name][0] == 1, name
    assert stats[P.HOSTCURL][1] >= max(stats[n][1] for n in SPANS[1:])
    assert sorted(n for n, _ in opened) == sorted(SPANS)
    assert {t for _, t in opened} == {threading.get_ident()}  # the calling thread's
    points = A.size
    assert stats[P.HOSTCURL_SLABS][0] == 3 * NSLAB
    assert stats[P.HOSTCURL_WIRE_BYTES][0] == 6 * points  # float32 + int16
    assert stats[P.HOSTCURL_FRESH_BYTES][0] == A.nbytes + B.nbytes == 2 * 8 * points
    assert list(info.phases)[-4:] == ["host_alloc", "slab_split", "fetch", "curl"]


def test_raw_route_has_no_encode(gates):
    """Under fetch_encoding "f64" A crosses raw: no encode span, 8 bytes a
    point."""
    (ierr, A, B, _), stats = _call(fetch_encoding="f64")
    assert ierr == 0
    assert P.HOSTCURL_ENCODE not in stats
    for name in (P.HOSTCURL, P.HOSTCURL_FETCH, P.HOSTCURL_CURL):
        assert stats[name][0] == 1, name
    assert stats[P.HOSTCURL_SLABS][0] == 3 * NSLAB
    assert stats[P.HOSTCURL_WIRE_BYTES][0] == 8 * A.size
    # on the CPU the host copy of A is fresh too (no pinned buffer)
    assert stats[P.HOSTCURL_FRESH_BYTES][0] == A.nbytes + B.nbytes


def test_default_route_opens_none(gates):
    before = {name: P.counter(name) for name in SPANS + COUNTERS}
    (ierr, _, _, info), stats = _call(host_curl=False)
    assert ierr == 0 and "curl" not in info.phases
    assert not [name for name in stats if name.startswith(P.HOSTCURL)]
    assert {name: P.counter(name) for name in SPANS + COUNTERS} == before
