"""Tests of the benchmark itself.  Run on the CPU with
``python -m pytest benchmark/tests -q``; the tests marked ``cuda`` need a
card and skip without one (``python -m pytest benchmark/tests -m cuda``
on the card)."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """Skip unless a CUDA card is visible (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
