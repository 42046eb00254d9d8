"""The benchmark's own tests: ``python3 -m pytest benchmarks/tests -q``
from the root of the repository.  Tests marked ``cuda`` need a card and
skip without one; on the card machine the same command runs them."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"
