"""run_sequence on the card against the same run on the CPU, and the
subset batch it builds on the card against the CPU's build."""

import numpy as np
import pytest
import torch

from correlation_tpu_torch import SequenceConfig, run_sequence
from correlation_tpu_torch import sequence as seq
from correlation_tpu_torch.domains import FlatPoints, build_batch, make_batch
from correlation_tpu_torch.config import DeformationDescription, ReferenceImage
from correlation_tpu_torch.ops import assemble_v2 as v2
from correlation_tpu_torch.ops import solve
from correlation_tpu_torch.problems import (
    annular_problem,
    blob_problem,
    sequence_problem,
)
from dicbench import spec

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("deformation", list(DeformationDescription),
                         ids=lambda d: d.name)
def test_sequence_on_card_equals_cpu(deformation):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    cfg, frames, pts, centers = sequence_problem(64, 4, img_hw=256)
    scfg = SequenceConfig(solver=cfg, deformation=deformation,
                          reference=ReferenceImage.PREVIOUS, frame_chunk=4)
    v2.reset_launches()
    card = run_sequence(list(frames), pts, scfg, centers=centers,
                        device="cuda")
    assert v2.LAUNCHES > 0  # counted by the time run_sequence returns
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
    v2.reset_launches()
    card = run_sequence(list(frames), pts, scfg, centers=None, device="cuda")
    assert v2.LAUNCHES > 0  # counted by the time run_sequence returns
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
    recording counts the LM steps the card ran, the lengths the card's
    count rows hold that are not -1 (read here from copies taken as each
    level is issued), at least two a level and fewer than its bound of
    53, and the launch counters count the same steps; no step ran on an
    empty list; every level is issued by the one native call as one
    graph launch, and the records equal a run's without a recording bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
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
    v2.reset_launches()
    solve.reset_launches()
    with profiling.recording() as rec:
        recorded = run_sequence(list(frames), pts, scfg, centers=centers,
                                device="cuda")
    levels = len(cfg.pyramid.levels_coarse_to_fine())
    steps = (cfg.max_iterations + 3) * levels
    assert solve.LAUNCHES == v2.LAUNCHES == rec.counters["steps"]
    lengths = [x for x in torch.cat(seen).tolist() if x >= 0]
    assert rec.counters["empty_steps"] == lengths.count(0) == 0
    assert len(lengths) == rec.counters["steps"] < steps * pairs
    assert rec.counters["steps"] >= levels * pairs * 2
    assert rec.counters["levels"] == rec.counters["native_levels"] == (
        rec.counters["graph_levels"]) == levels * pairs
    assert rec.counters["batches"] == rec.counters["batches_on_device"] == 1
    for a, b in zip(plain, recorded):
        np.testing.assert_array_equal(a.params, b.params)
        np.testing.assert_array_equal(a.chi, b.chi)
        np.testing.assert_array_equal(a.iterations, b.iterations)
        np.testing.assert_array_equal(a.error, b.error)


CELLS = ("rect_grid_1mp.eulerian_first", "annulus_512.eulerian_first",
         "blob_e8_gauge.eulerian_first")


def _same_bits(a, b):
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("cell", CELLS)
def test_card_batch_equals_cpu_build(cell):
    """The benchmark cells' point lists, built on the card from one pinned
    copy, equal make_batch's CPU build bit for bit (xy, mask, center0,
    extents), with point means and, for the grid, its explicit centers."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    config = spec.load_cell(cell).config
    pts, centers = spec.load("domains", config["domain"]["kind"]).points(
        config["domain"], config["frame"])
    for c in {id(x): x for x in (centers, None)}.values():
        card = build_batch(FlatPoints(pts, pin=True), c, 2, device="cuda")
        cpu = make_batch(pts, c, 2)
        assert card.xy[0].is_cuda and card.extents == cpu.extents
        for a, b in zip(card.xy + card.mask + [card.center0],
                        cpu.xy + cpu.mask + [cpu.center0]):
            assert _same_bits(a, b)


def _numpy_batch(flat, centers, stop, pad_to=None, device=None):
    """run_sequence's batch as make_batch on the CPU, then to_device."""
    lists = np.split(flat.xy, np.cumsum(flat.counts)[:-1])
    return make_batch(lists, centers, stop, pad_to).to_device(device)


# The caching allocator hands out a cached block whole when what would be
# left of it is under 1 MiB, and max_memory_allocated counts the block:
# the build's freed blocks can move a later peak by up to that.
UNSPLIT = 1 << 20


@pytest.mark.parametrize("kind", ["grid", "annulus"])
def test_sequence_equals_a_run_on_the_cpu_built_batch(monkeypatch, kind):
    """Records on the card equal a run whose batch is built on the CPU
    and copied up.  Over the sequence the card build asks for no more
    memory at its peak (requested bytes), and max_memory_allocated is no
    higher but for one unsplit block."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    if kind == "grid":
        cfg, frames, pts, centers = sequence_problem(4096, 4, img_hw=1024)
    else:
        cfg, frames, pts, _ = annular_problem(
            4, img_hw=1024, center=(512, 480), radii=(120, 400),
            subdivisions=(8, 64))
        centers = None
    scfg = SequenceConfig(solver=cfg, frame_chunk=4)

    def run():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        recs = run_sequence(list(frames), pts, scfg, centers=centers,
                            device="cuda")
        torch.cuda.synchronize()
        stats = torch.cuda.memory_stats()
        return recs, (stats["allocated_bytes.all.peak"],
                      stats["requested_bytes.all.peak"])

    run()  # warm: the kernel library, the caching allocator
    with monkeypatch.context() as m:
        m.setattr(seq, "build_batch", _numpy_batch)
        want, want_peak = run()
    got, peak = run()
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        for f in ("params", "chi", "iterations", "error", "und_center",
                  "def_center", "def_global_center"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert peak[1] <= want_peak[1]
    assert peak[0] <= want_peak[0] + UNSPLIT
