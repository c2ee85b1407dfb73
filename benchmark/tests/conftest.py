"""Tests of the benchmark's harness, reference and yardstick.  Run from the
repository root: ``python -m pytest benchmark/tests -q``.  Tests marked
``chip`` need an NVIDIA card and skip without one (decided in a fixture)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
