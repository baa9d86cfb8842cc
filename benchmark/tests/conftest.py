"""Settings of the benchmark's own tests (run with
``python -m pytest benchmark/tests``); the card's tests carry the ``cuda``
marker and skip, inside a fixture, where there is no card."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark's cells run only on "
                    "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)
