"""Shared set-up of the benchmark's tests: the repository's root and its
``src/`` on the path, one torch thread, and the ``cuda`` fixture that
skips a test where no card is present (decided when the test runs, never
at import)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (CUDA); skipped without one")


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
