"""Fixtures of the benchmark's own tests (run on the CPU at tiny sizes:
``python -m pytest benchmark/tests -q``)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: runs on the chip")
    return torch.device("cuda", 0)
