"""Pytest settings of the benchmark's own tests.

Tests marked `chip` need a CUDA card; their `cuda` fixture skips them
elsewhere. On the card: python -m pytest -p no:cacheprovider benchmark/tests -m chip
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
