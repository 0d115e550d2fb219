"""Tests of the benchmark's harness.  They run on the CPU at tiny sizes;
those marked ``card`` need a CUDA device and skip without one, decided
inside the ``card`` fixture (never while a module is imported)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark's cells run on the "
                    "card); run with: python -m pytest benchmark/tests -m card")
    return "cuda"
