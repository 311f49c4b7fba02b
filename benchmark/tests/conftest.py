"""Settings of the benchmark's own tests (``python -m pytest
benchmark/tests``): the ``card`` marker for tests that need a CUDA card,
and the fixture that looks for one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return "cuda"
