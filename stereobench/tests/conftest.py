"""Tests of the benchmark.  They run on the CPU at tiny sizes against the
port's plain versions; the ones marked ``card`` need a CUDA card and skip
without one (decided inside the test, never at import)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on the CPU")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own sizes run there")
    return torch.device("cuda", 0)
