"""Tests of the benchmark harness.  Run from the repository's root:

    python -m pytest qbench/tests -q

Tests marked ``card`` need a CUDA card and skip without one; on the card's
machine the same command runs them."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
