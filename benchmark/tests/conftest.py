"""pytest set-up of the benchmark's own tests: the `cuda` marker and the
fixtures (`portbench_helpers` holds the rest)."""

import pytest
import torch

from portbench_helpers import tiny_copy


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips itself where there is none")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.fixture
def tiny(tmp_path):
    return tiny_copy(tmp_path)
