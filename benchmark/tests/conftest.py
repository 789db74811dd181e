"""The card marker and fixture of the benchmark's tests."""

from __future__ import annotations

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card on a machine without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the card run: python3 -m pytest benchmark/tests -m card")
    return torch.cuda.get_device_name(0)
