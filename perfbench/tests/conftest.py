"""The harness's own tests (run them from the checkout's root:
python -m pytest perfbench/tests). Tests of the card carry the `card`
marker and skip, inside the `card` fixture, where there is none."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process")
    return torch.device("cuda")
