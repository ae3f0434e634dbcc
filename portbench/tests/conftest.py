"""Settings for the benchmark's own tests.

    python -m pytest portbench/tests -q            # here, on the CPU
    python -m pytest portbench/tests -q -m requires_cuda   # on a machine with a card

Tests that need the card take the `cuda` fixture, which skips without one:
the decision is made when the test runs, never at import or collection.
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "requires_cuda: needs a CUDA device; skips without one")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return "cuda"


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
