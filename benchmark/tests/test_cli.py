"""run.py's refusals and the import guard."""

import subprocess
import sys
import types
from pathlib import Path

import pytest

from benchmark.lib import guard

ROOT = Path(__file__).resolve().parents[2]


def test_no_card_exits_nonzero_and_prints_no_metric():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "vp_test1.n220",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and "correct" not in out.stdout
    assert "CUDA" in out.stderr


def test_guard_matches_whole_top_level_names(monkeypatch):
    assert guard.found() == []
    monkeypatch.setitem(sys.modules, "ndsm_tpu_torch_fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib_like", types.ModuleType("x"))
    assert guard.found() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "ndsm_tpu", types.ModuleType("x"))
    assert guard.found() == ["jax.numpy", "ndsm_tpu"]
    with pytest.raises(SystemExit):
        guard.check()


def test_a_run_loads_no_jax():
    """A whole run (set-up, window, trace, check) in a fresh process, on the
    CPU at a small size: no JAX, no JAX package in sys.modules after it."""
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "from benchmark.lib import guard, harness\n"
            "harness.run('vp_test1.n220', 9, 0.2, True, device='cpu', mix_overrides={"
            "'sizes': [22], 'pool_per_size': 1, 'warm_calls': 1, 'trace_calls': 1, "
            "'check_per_size': 1})\n"
            "print(guard.found(), 'ndsm_tpu_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"
