"""Tests of the benchmark itself (not collected by the repository's
`pytest tests/`): `python -m pytest helmbench/tests -q`. Tests marked
`card` need a CUDA device, decided inside the `card` fixture; they skip
elsewhere."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (run on the card)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's runs on the card")
    return torch.device("cuda")
