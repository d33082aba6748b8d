"""The port's ``Options.per_face``, ``host_curl`` and ``fetch_encoding``
against ``ndsm_tpu`` on the CPU, at 12^3 on the analytic case.

Tolerances:
  * per_face against JAX's per_face, fp64: A and B within 1e-12 max|.|
    (same algorithm, summation orders differ); with float32 outputs
    within 1e-6 max|.| (each of the 18 solves is rounded to float32 before
    the sum, and a solve that differs by an ulp of float64 can round the
    other way);
  * per_face against the port's default solve: 1e-6 (A) and 1e-4 (B),
    JAX's test_per_face_superposition (both stop at vc_tol);
  * per_face under ``dist`` on a CPU mesh of 2 against per_face on one
    device: 1e-12 max|.|;
  * ``curl_np_into``: bitwise against JAX's, and over any split of z into
    slabs bitwise against one call;
  * host_curl against the default on the CPU: A bitwise, B within 1e-13
    max|B| (JAX's bound; on the CPU it is bitwise, asserted too);
  * split16: bitwise against JAX's pipeline on the same input, and within
    max|A - f32(A)| / 32767 of A (JAX's bound).
"""

import functools
import sys

import numpy as np
import pytest
import torch

import ndsm_tpu
import ndsm_tpu_torch
from ndsm_tpu.ops import deriv as jderiv
from ndsm_tpu.potential import vector_potential as JVP
from ndsm_tpu.utils.testing import build_test_mesh, potential_field_case
from ndsm_tpu_torch import Options
from ndsm_tpu_torch.ops import deriv
from ndsm_tpu_torch.parallel.shard import DistConfig, make_mesh
from ndsm_tpu_torch.potential import vector_potential as VP

torch.set_num_threads(1)

N = 12


@functools.lru_cache(maxsize=None)
def _case():
    x, y, z = build_test_mesh(N)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    return (x, y, z), potential_field_case(X, Y, Z)[1]


def _port(dist=None, **kw):
    (x, y, z), b = _case()
    return ndsm_tpu_torch.vector_potential(x, y, z, b.copy(),
                                           options=Options(precision="fp64", **kw),
                                           device="cpu", full_output=True, dist=dist)


_port_cached = functools.lru_cache(maxsize=None)(lambda **kw: _port(**kw))


@functools.lru_cache(maxsize=None)
def _jax(**kw):
    (x, y, z), b = _case()
    ierr, A, B, info = ndsm_tpu.vector_potential(
        x, y, z, b.copy(), options=ndsm_tpu.Options(precision="fp64", **kw), full_output=True)
    return ierr, np.asarray(A), np.asarray(B), info


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_per_face_against_jax_and_the_default_solve():
    ierr, A, B, info = _port_cached(per_face=True)
    ierr_j, A_j, B_j, info_j = _jax(per_face=True)
    assert ierr == ierr_j == 0
    assert [s.name for s in info.components] == [s.name for s in info_j.components]
    assert len(info.components) == 18 and info.components[4].name == "Ay_face1"
    assert [s.cycles for s in info.components] == [s.cycles for s in info_j.components]
    assert _rel(A, A_j) < 1e-12 and _rel(B, B_j) < 1e-12
    _, A0, B0, _ = _port_cached()
    assert np.abs(A - A0).max() < 1e-6
    assert np.abs(B - B0).max() < 1e-4
    assert not VP._batch_components(Options(per_face=True, batch_components="on"), "mixed",
                                    (N, N, N), torch.device("cpu"))


def test_per_face_float32_output():
    _, A, B, info = _port_cached(per_face=True, output_dtype="float32")
    _, A_j, B_j, _ = _jax(per_face=True, output_dtype="float32")
    assert A.dtype == B.dtype == A_j.dtype == np.float32
    assert _rel(A, A_j) < 1e-6 and _rel(B, B_j) < 1e-6
    _, A64, _, _ = _port_cached(per_face=True)
    assert _rel(A, A64) < 1e-6


def test_per_face_under_dist():
    dist = DistConfig(make_mesh(2, devices=["cpu"] * 2))
    ierr, A, B, info = _port(dist=dist, per_face=True)
    _, A1, B1, info1 = _port_cached(per_face=True)
    assert ierr == 0 and len(info.components) == 18
    assert [s.name for s in info.components] == [s.name for s in info1.components]
    assert _rel(A, A1) < 1e-12 and _rel(B, B1) < 1e-12


def test_curl_np_into_bitwise_against_jax_and_slabs():
    rng = np.random.default_rng(12)
    dq = (0.1, 0.07, 0.13)
    for shape in ((3, 9, 7, 8), (3, 3, 5, 4)):
        A = rng.standard_normal(shape)
        whole = np.empty_like(A)
        deriv.curl_np_into(A, dq, whole)
        ref = np.empty_like(A)
        jderiv.curl_np_into(A, dq, ref)
        assert np.array_equal(whole, ref)
        assert np.array_equal(deriv.curl_np(A, dq), jderiv.curl_np(A, dq))
        nz = shape[1]
        for cuts in ([0, 1, nz], [0, nz // 2, nz], list(range(nz + 1))):
            out = np.full_like(A, np.nan)
            for z0, z1 in zip(cuts[:-1], cuts[1:]):
                deriv.curl_np_into(A, dq, out, z0, z1)
            assert np.array_equal(out, whole), cuts
        # float32 in and out: differenced in float64, then stored
        A32 = A.astype(np.float32)
        out32, ref32 = np.empty_like(A32), np.empty_like(A32)
        deriv.curl_np_into(A32, dq, out32)
        jderiv.curl_np_into(A32, dq, ref32)
        assert np.array_equal(out32, ref32)
        assert np.array_equal(out32, deriv.curl_np(A32.astype(np.float64), dq).astype(np.float32))


def test_host_curl_against_the_device_path():
    _, A0, B0, _ = _port_cached()
    ierr, A, B, info = _port_cached(host_curl=True)
    assert ierr == 0 and isinstance(A, np.ndarray) and isinstance(B, np.ndarray)
    assert np.array_equal(A, A0)
    assert np.abs(B - B0).max() <= 1e-13 * np.abs(B0).max()
    assert np.array_equal(B, B0)  # the CPU's device curl is separate elementwise ops
    assert {"host_alloc", "slab_split", "fetch", "curl"} <= set(info.phases)


@pytest.mark.parametrize("where", ["order1", "dist"])
def test_host_curl_not_taken(where):
    """Under flux_correction_order=1 (B holds the analytic field too) and
    under dist, B comes from the device path, as in JAX."""
    if where == "order1":
        kw, dist = {"flux_correction_order": 1}, None
    else:
        kw, dist = {}, DistConfig(make_mesh(2, devices=["cpu"] * 2))
    _, A0, B0, _ = _port(dist=dist, **kw)
    _, A, B, info = _port(dist=dist, host_curl=True, **kw)
    assert np.array_equal(A, A0) and np.array_equal(B, B0)
    assert "curl" not in info.phases and "fetch" in info.phases


def _pipeline_inputs():
    rng = np.random.default_rng(5)
    return rng.standard_normal((3, 12, 10, 9)) * 3.0, (0.1, 0.2, 0.3)


def test_split16_round_trip_against_jax(monkeypatch):
    A, dq = _pipeline_inputs()
    monkeypatch.setenv("NDSM_TPU_SPLIT16_MIN_MB", "0")
    monkeypatch.setattr(VP, "SPLIT16_MIN_MB", 0.0)
    marks = []
    h_j, B_j = JVP._fetch_and_curl_pipelined(A, dq, "float64", lambda *a: None,
                                             encoding="split16")
    h, B = VP._fetch_and_curl(torch.as_tensor(A), dq, "float64", marks.append, "split16")
    assert marks == ["host_alloc", "slab_split", "fetch", "curl"]
    bound = np.abs(A - A.astype(np.float32)).max() / 32767
    assert 0 < np.abs(h - A).max() <= bound
    assert np.array_equal(h, np.asarray(h_j)) and np.array_equal(B, np.asarray(B_j))
    # the pipeline's B is the curl of what reached the host
    assert np.array_equal(B, deriv.curl_np(h, dq))


def test_split16_size_gate_and_unknown_encodings():
    A, dq = _pipeline_inputs()
    assert A.nbytes / 1e6 < VP.SPLIT16_MIN_MB  # under the gate: the raw copy
    for enc in ("split16", "f64", "no-such-encoding"):
        h, B = VP._fetch_and_curl(torch.as_tensor(A), dq, "float64", lambda *a: None, enc)
        assert np.array_equal(h, A), enc
        assert np.array_equal(B, deriv.curl_np(A, dq)), enc
    # float32 outputs never take split16
    A32 = torch.as_tensor(A, dtype=torch.float32)
    h, _ = VP._fetch_and_curl(A32, dq, "float32", lambda *a: None, "split16")
    assert h.dtype == np.float32 and np.array_equal(h, A32.numpy())


@pytest.mark.parametrize("encoding", ["f64", "split16"])
def test_fetch_pipeline_threads_under_stress(monkeypatch, encoding):
    """The slab bookkeeping shared by the host threads: many slabs, more
    curl threads than cores and a short switch interval; every slab must be
    curled once and B must be the whole curl of what landed, bit for bit."""
    rng = np.random.default_rng(9)
    A = torch.as_tensor(rng.standard_normal((3, 48, 6, 5)))
    dq = (0.1, 0.2, 0.3)
    monkeypatch.setattr(VP, "FETCH_SLABS", 16)
    monkeypatch.setattr(VP, "FETCH_SLAB_MB", 1e-6)
    monkeypatch.setattr(VP, "SPLIT16_MIN_MB", 0.0)
    monkeypatch.setattr(VP, "CURL_WORKERS", 32)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(20):
            h, B = VP._fetch_and_curl(A, dq, "float64", lambda *a: None, encoding)
            if encoding == "f64":
                assert np.array_equal(h, A.numpy())
            assert np.array_equal(B, deriv.curl_np(h, dq))
    finally:
        sys.setswitchinterval(old)
