"""Tests of the benchmark harness. CPU tests run the harness at small sizes
with the program's plain kernel versions; tests marked ``card`` need a CUDA
card and skip without one (decided inside the ``card`` fixture, never at
import). On the card: ``python -m pytest -m card gpubench/tests``."""

import os
import sys

import pytest

ROOT = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (python -m pytest -m card "
                                       "gpubench/tests)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size runs on the card")
    return torch.device("cuda", 0)
