"""Test set-up for the benchmark's own tests: the harness and the
references import as ``harness`` / ``reference``, the port from ``src``.
Nothing here imports JAX."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH.parent / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (an H100); skips without one")


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
