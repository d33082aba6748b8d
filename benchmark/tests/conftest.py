"""Tests of the benchmark.  Run from the repository root:

    python -m pytest benchmark/tests -q

Tests marked ``cuda`` need a card and skip without one (on the card:
``python -m pytest benchmark/tests -q -m cuda``)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips on hosts without one")


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"
