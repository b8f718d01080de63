"""Tests of the benchmark. Those that need a CUDA card carry the ``cuda``
marker and skip, with the reason, on a machine without one; the card is
looked for inside the fixture, never while a module is imported. Run
them on the card with ``python3 -m pytest portbench/tests -m cuda``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
