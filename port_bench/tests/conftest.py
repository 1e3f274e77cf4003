"""Settings of the benchmark's own tests (``python -m pytest port_bench/tests``).

Registers the ``card`` marker of the tests that need a CUDA card; the
``card`` fixture skips such a test inside the test, never while the module
is imported. The tests import no JAX.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips on a machine without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
