"""The benchmark's CPU tests.  They import no JAX; tests marked ``card``
need a CUDA device, decide so inside the ``card`` fixture, and skip here.
Run them all from the repository's root: ``python -m pytest rxbench/tests``;
on the card the same command runs the marked ones too."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark runs on the card")
    return "cuda"
