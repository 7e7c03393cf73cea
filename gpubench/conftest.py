"""Test settings of the benchmark's own tests (``pytest gpubench``).

Tests that need a CUDA card carry the ``card`` marker and take the
``card`` fixture, which skips them where there is none; the decision is
made when the fixture runs, never when a module is imported.  On the
chip: ``python3 -m pytest gpubench -m card``.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: these run on the chip")
    return torch.cuda.get_device_name(0)
