"""Tests of the port that need an NVIDIA GPU (and nvcc).  They import
torch and the port only, never JAX: run them on the card with
`python -m pytest tests_gpu -q`; elsewhere every test skips with a reason.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips elsewhere"
    )
