"""Tests of the benchmark's own code. They run on the CPU, except those
marked ``card``, which skip without a CUDA device (decided in the
``card`` fixture, never at import):

    python -m pytest portbench/tests -q            # here
    python -m pytest portbench/tests -q -m card    # on the card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
