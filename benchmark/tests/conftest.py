"""CPU tests of the benchmark (`python -m pytest benchmark/tests -q`); the
test marked `card` runs only where a CUDA device is present."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parents[1]), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided at run time, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs only on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_root(tmp_path):
    import harness_fixture

    return harness_fixture.make_root(tmp_path)
