"""Tests of the benchmark harness, run on the CPU:

    python -m pytest benchmark/tests -q

They import torch, tpinn_torch and the harness, never JAX.  Tests marked
``cuda`` need a card and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: requires a CUDA GPU (tpinn_torch kernels)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)
