"""run_sequence on the card against the same run on the CPU."""

import numpy as np
import pytest
import torch

from correlation_tpu_torch import SequenceConfig, run_sequence
from correlation_tpu_torch.config import DeformationDescription, ReferenceImage
from correlation_tpu_torch.ops import assemble_v2 as v2
from correlation_tpu_torch.problems import (
    annular_problem,
    blob_problem,
    sequence_problem,
)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("deformation", list(DeformationDescription),
                         ids=lambda d: d.name)
def test_sequence_on_card_equals_cpu(deformation):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    cfg, frames, pts, centers = sequence_problem(64, 4, img_hw=256)
    scfg = SequenceConfig(solver=cfg, deformation=deformation,
                          reference=ReferenceImage.PREVIOUS, frame_chunk=4)
    before = v2.LAUNCHES
    card = run_sequence(list(frames), pts, scfg, centers=centers,
                        device="cuda")
    assert v2.LAUNCHES > before
    cpu = run_sequence(list(frames), pts, scfg, centers=centers, device="cpu")
    assert len(card) == len(cpu) == 4
    for a, b in zip(card, cpu):
        np.testing.assert_array_equal(a.params, b.params)
        np.testing.assert_array_equal(a.iterations, b.iterations)
        np.testing.assert_array_equal(a.error, b.error)
        np.testing.assert_allclose(np.median(a.params[:, :2], axis=0),
                                   [0.0, 1.0], atol=0.02)


def _assert_card_equals_cpu(frames, pts, scfg, expect):
    """run_sequence on the card equals the CPU's, and each pair recovers
    `expect(t)`, the (u, v) of pair t."""
    before = v2.LAUNCHES
    card = run_sequence(list(frames), pts, scfg, centers=None, device="cuda")
    assert v2.LAUNCHES > before
    cpu = run_sequence(list(frames), pts, scfg, centers=None, device="cpu")
    assert len(card) == len(cpu) == len(frames) - 1
    for t, (a, b) in enumerate(zip(card, cpu)):
        np.testing.assert_array_equal(a.params, b.params)
        np.testing.assert_array_equal(a.iterations, b.iterations)
        np.testing.assert_array_equal(a.error, b.error)
        np.testing.assert_allclose(np.median(a.params[:, :2], axis=0),
                                   expect(t), atol=0.02)


@pytest.mark.parametrize("lagrangian", [False, True],
                         ids=["eulerian-first", "lagrangian-previous"])
def test_annular_sequence_on_card_equals_cpu(lagrangian):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    cfg, frames, pts, _ = annular_problem(3, img_hw=256, center=(128, 120),
                                          radii=(30, 100),
                                          subdivisions=(2, 8))
    scfg = SequenceConfig(solver=cfg, frame_chunk=3)
    if lagrangian:
        scfg = SequenceConfig(solver=cfg, frame_chunk=3,
                              deformation=DeformationDescription.LAGRANGIAN,
                              reference=ReferenceImage.PREVIOUS)
    _assert_card_equals_cpu(
        frames, pts, scfg,
        lambda t: [0.0, 1.0] if lagrangian else [0.0, t + 1.0])


def test_blob_sequence_on_global_tile_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    cfg, frames, pts, _ = blob_problem(2, img_hw=384, center=(192, 184),
                                       radius=125)
    v2.reset_launches()
    _assert_card_equals_cpu(frames, pts, SequenceConfig(solver=cfg),
                            lambda t: [0.0, t + 1.0])
    big = [k for k, (n, _) in v2.LAUNCHES_BY_SHAPE.items() if n
           and not v2.tile_in_shared(k[1], k[2], 1, v2.subset_threads(k[0]))]
    assert big
    # Every level of the blob is split over several blocks.
    assert all(v2.subset_chunks(k[0]) > 1 for k in v2.LAUNCHES_BY_SHAPE)


def test_recording_counts_the_card_steps(monkeypatch):
    """On a grid of the benchmark's size (4096 subsets, 1 MP frames): a
    recording counts every LM-step launch (53 a level, 159 a pair), its
    empty steps are the zero lengths the card's count rows hold (read
    here from copies taken as each level is issued), every level is
    issued by the one native call, and the records equal a run's without
    a recording bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from correlation_tpu_torch.ops import solve
    from correlation_tpu_torch.utils import profiling

    pairs = 4
    cfg, frames, pts, centers = sequence_problem(4096, pairs, img_hw=1024)
    scfg = SequenceConfig(solver=cfg, frame_chunk=pairs)
    plain = run_sequence(list(frames), pts, scfg, centers=centers,
                         device="cuda")
    seen = []
    real = profiling.Recording.add_lengths

    def copied(self, lengths):
        seen.extend(x.reshape(-1).clone() for x in lengths)
        return real(self, lengths)

    monkeypatch.setattr(profiling.Recording, "add_lengths", copied)
    before = solve.LAUNCHES
    with profiling.recording() as rec:
        recorded = run_sequence(list(frames), pts, scfg, centers=centers,
                                device="cuda")
    levels = len(cfg.pyramid.levels_coarse_to_fine())
    steps = (cfg.max_iterations + 3) * levels
    assert rec.counters["steps"] == solve.LAUNCHES - before == steps * pairs
    lengths = torch.cat(seen).tolist()
    assert rec.counters["empty_steps"] == lengths.count(0) > 0
    assert len(lengths) == rec.counters["steps"]
    assert rec.counters["levels"] == rec.counters["native_levels"] == (
        levels * pairs)
    for a, b in zip(plain, recorded):
        np.testing.assert_array_equal(a.params, b.params)
        np.testing.assert_array_equal(a.chi, b.chi)
        np.testing.assert_array_equal(a.iterations, b.iterations)
        np.testing.assert_array_equal(a.error, b.error)
