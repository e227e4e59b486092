"""The benchmark's own tests: ``python -m pytest portbench/tests``.

Tests that need a CUDA card carry the ``chip`` marker and decide inside
the test, never at import, whether there is one."""

from pathlib import Path

import pytest

DATA = Path(__file__).resolve().parent / "data"
#: a seed past 32 signed bits, as the benchmark's callers give
BIG_SEED = 2 ** 31 + 12345


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
