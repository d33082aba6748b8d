"""``ndsm_tpu_torch.utils.profiling`` on the CPU: the ``Timer`` of JAX's
tests/test_utils.py, its ``sync`` argument with CPU tensors, and
``trace`` writing a Chrome trace that names a ``record_function`` range."""

import json

import numpy as np
import torch

import ndsm_tpu_torch
from ndsm_tpu_torch.potential.vector_potential import CHI_RANGE, SOLVE3D_RANGE
from ndsm_tpu_torch.utils import profiling
from ndsm_tpu_torch.utils.profiling import Timer

torch.set_num_threads(1)


def test_timer():
    t = Timer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    assert "a:" in t.report()
    assert t.report().splitlines()[0].endswith("calls")


def test_timer_sync_with_cpu_tensors():
    """``sync`` takes a tensor or a sequence of them (filled inside the
    block); CPU tensors and other objects need no synchronisation."""
    t = Timer()
    x = torch.ones(8)
    with t.phase("one", sync=x):
        x = x * 2
    out = []
    with t.phase("list", sync=out):
        out.extend([x + 1, np.zeros(2), None])
    assert t.counts == {"one": 1, "list": 1}
    assert all(v >= 0.0 for v in t.totals.values())


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with torch.profiler.record_function("ndsm.test_range"):
            torch.ones(64).sum()
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "ndsm.test_range" for e in events)
    assert any(e.key == "ndsm.test_range" for e in prof.key_averages())


def test_trace_names_the_pipeline_phases(tmp_path):
    x = np.linspace(0, 1, 8)
    b = np.zeros((3, 8, 8, 8))
    with profiling.trace(str(tmp_path)):
        ierr, _, _ = ndsm_tpu_torch.vector_potential(x, x, x, b, device="cpu")
    assert ierr == 0
    text = next(tmp_path.glob("*.json")).read_text()
    assert CHI_RANGE in text and SOLVE3D_RANGE in text
