"""The benchmark's tests: on the CPU here, at tiny sizes; those marked
``cuda`` need a card and skip without one (decided in a fixture, never at
import). Run from the checkout's root:
``python -m pytest bench_h100/tests -q`` (the card's:
``python -m pytest bench_h100/tests -m cuda -q``)."""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (BENCH, os.path.dirname(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return "cuda"
