"""Tests of the benchmark harness.  On the CPU they drive the harness at a
tiny size with the program's backend "torch"; tests marked `cuda` need
the card and skip elsewhere.  Run them with `python -m pytest
dicbench/tests -q` from the repository's root."""

import copy
import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

CELLS = ("rect_grid_1mp.eulerian_first", "annulus_512.eulerian_first")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def tiny(cell, pairs: int = 3):
    """The cell at a CPU test's size: 256 x 256 frames, 64 grid subsets
    or 2 x 16 annular sectors (about 890 px each, as the cell's are),
    `pairs` pairs; its motion and limits unchanged."""
    config = copy.deepcopy(cell.config)
    config["frame"].update(height=256, width=256)
    dom = config["domain"]
    if dom["kind"] == "grid":
        dom.update(subsets=64)
    else:
        dom.update(center=[128, 120], radii=[30, 100], subdivisions=[2, 16])
    mix = dict(cell.mix, pairs=pairs)
    return dataclasses.replace(cell, config=config, mix=mix)


@pytest.fixture(params=CELLS)
def tiny_cell(request):
    from dicbench import spec

    return tiny(spec.load_cell(request.param))
