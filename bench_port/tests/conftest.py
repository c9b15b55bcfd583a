"""Tests of the port's benchmark (bench_port/). They import nothing of JAX;
those marked ``cuda`` run on the card and skip without one:

    python -m pytest bench_port/tests -q
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs on the card; skips where torch.cuda.is_available() is false")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
