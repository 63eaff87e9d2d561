"""The benchmark's CPU tests: ``python -m pytest perfbench/tests -q`` from
the repository's root. Tests that need the card carry the ``cuda`` marker
and skip here, decided inside a fixture."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
