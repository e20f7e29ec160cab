"""pytest settings of the benchmark's own tests (python -m pytest gpu_bench):
the harness's modules and the repository root on the path, and the
`card` marker of tests that need a CUDA card (they skip without one, as
the `cuda_card` fixture decides)."""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent
for p in (BENCH_DIR / "tests", BENCH_DIR, BENCH_DIR.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run these on the chip (python -m pytest gpu_bench -m card)")
    return torch.device("cuda", 0)
