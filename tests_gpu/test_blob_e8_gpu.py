"""The benchmark's ASTM E8 gauge blob at full size (140,672 px, K1's split
path with the tile in global memory at every level) through run_sequence
on the card, against the same run on the CPU, and its levels counted as
split by a recording."""

import numpy as np
import pytest
import torch

from correlation_tpu_torch import SequenceConfig, run_sequence
from correlation_tpu_torch.config import (
    FittingModel,
    Interpolation,
    PyramidConfig,
    SolverConfig,
)
from correlation_tpu_torch.ops import assemble_v2 as v2
from correlation_tpu_torch.problems import drifting_sequence
from correlation_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

PAIRS = 2


def _gauge_points():
    from dicbench import spec

    dom = spec.load_cell("blob_e8_gauge.eulerian_first").config["domain"]
    (pts,), _ = spec.load("domains", "blob").points(dom, None)
    return [pts]


def test_gauge_blob_on_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    cfg = SolverConfig(model=FittingModel.AFFINE,
                       interpolation=Interpolation.BICUBIC,
                       pyramid=PyramidConfig(0, 1, 2))
    frames = drifting_sequence(PAIRS, 1024)
    pts = _gauge_points()
    scfg = SequenceConfig(solver=cfg)
    v2.reset_launches()
    with profiling.recording() as rec:
        card = run_sequence(list(frames), pts, scfg, centers=None,
                            device="cuda")
    levels = len(cfg.pyramid.levels_coarse_to_fine())
    assert rec.counters["levels"] == levels * PAIRS
    assert rec.counters["split_levels"] == rec.counters["levels"]
    assert rec.counters["native_levels"] == rec.counters["levels"]
    # Every launch is on the split path, the tile read from memory.
    assert v2.LAUNCHES_BY_SHAPE
    for p_len, th, tw in v2.LAUNCHES_BY_SHAPE:
        assert v2.subset_chunks(p_len) > 1
        assert not v2.tile_in_shared(th, tw, 1, v2.subset_threads(p_len),
                                     v2.subset_chunks(p_len))
    cpu = run_sequence(list(frames), pts, scfg, centers=None, device="cpu")
    assert len(card) == len(cpu) == PAIRS
    for t, (a, b) in enumerate(zip(card, cpu)):
        np.testing.assert_array_equal(a.params, b.params)
        np.testing.assert_array_equal(a.iterations, b.iterations)
        np.testing.assert_array_equal(a.error, b.error)
        np.testing.assert_allclose(a.params[0, :2], [0.0, t + 1.0],
                                   atol=0.02)
