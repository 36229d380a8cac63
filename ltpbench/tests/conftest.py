"""Tests of the benchmark. Run from the repository's root:

    PYTHONPATH=src python -m pytest ltpbench/tests

Tests marked ``card`` need a CUDA device and skip without one; the
fixture ``card`` decides, when the test runs."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
