"""The port's sequence records on disk against the JAX package's: the CSV
report byte for byte, checkpoints that resume in the other package, the
file-driven run's bounded decode cache, and a PNG round trip."""

import dataclasses
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from correlation_tpu import report as jreport
from correlation_tpu import sequence as jseq
from correlation_tpu.utils import checkpoint as jckpt
from correlation_tpu_torch import report, sequence as tseq
from correlation_tpu_torch.config import (
    DeformationDescription,
    FittingModel,
    PyramidConfig,
    ReferenceImage,
    SolverConfig,
)
from correlation_tpu_torch.utils import checkpoint as ckpt
from test_torch_sequence import (
    assert_same_records,
    drift_frames,
    pallas_interpret,
    run_both,
    sectors,
)

torch.set_num_threads(2)

CENTERS = [(30, 30), (62, 30), (30, 62), (62, 62)]
LAGR = dict(deformation=DeformationDescription.LAGRANGIAN,
            reference=ReferenceImage.PREVIOUS, frame_chunk=2)


def _convert(records, cls):
    return [cls(**{f.name: getattr(r, f.name)
                   for f in dataclasses.fields(cls)}) for r in records]


def _jax_cfg(**kw):
    from correlation_tpu.config import PyramidConfig as JPyramid
    from correlation_tpu.config import SolverConfig as JSolver

    enums = {"deformation": jseq.DeformationDescription,
             "reference": jseq.ReferenceImage}
    return jseq.SequenceConfig(
        solver=JSolver(pyramid=JPyramid(0, 1, 2), backend="pallas"),
        **{k: enums[k](int(v)) if k in enums else v for k, v in kw.items()})


def _port_cfg(**kw):
    return tseq.SequenceConfig(solver=SolverConfig(pyramid=PyramidConfig(0, 1, 2)),
                               **kw)


@pytest.fixture(scope="module")
def lagr_runs():
    """JAX and port records of one uninterrupted Lagrangian run."""
    frames = drift_frames(5, 1.3, -0.8)
    return frames, run_both(frames, sectors(CENTERS), **LAGR)


def test_csv_is_byte_identical(lagr_runs):
    _, (ref, got) = lagr_runs
    assert_same_records(ref, got)
    names = [f"f{i}.png" for i in range(5)]
    for recs in (ref, _convert(got, jseq.FrameRecord)):
        mine = _convert(recs, tseq.FrameRecord)
        for kw in ({}, {"file_names": names, "reference_first": False}):
            want = jreport.write_report(recs, **kw)
            assert report.write_report(mine, **kw) == want
            assert want.count("\n") == 1 + 4 * 4
    assert report.report_header(6) == jreport.report_header(6)
    assert report.write_report([]) == ""


def _partial_run(run, frames, pts, cfg, path, **kw):
    """Run with a stop raised by the record of frame 1."""
    state = {"stop": False}

    def on_frame(rec):
        state["stop"] = rec.frame >= 1

    return run(frames, pts, cfg, checkpoint_path=path, on_frame=on_frame,
               should_stop=lambda: state["stop"], **kw)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_in_the_other_package(lagr_runs, tmp_path, writer):
    """A run stopped while its records are emitted leaves the same records
    and checkpoint in both packages, and resumes from it in either package
    with the same records.  (A resumed Lagrangian run rebuilds its coarse
    levels from the moved points, so it need not equal the uninterrupted
    run; both packages resume alike.)  Both poll should_stop at the next
    chunk's dispatch, before the first chunk's records, and before each
    record after a chunk's first: the stop raised by frame 1's record lets
    the second chunk emit frame 2, then ends the run."""
    frames, (ref, _) = lagr_runs
    pts = sectors(CENTERS)
    first = str(tmp_path / "first.npz")
    if writer == "jax":
        with pallas_interpret():
            part = _partial_run(jseq.run_sequence, frames, pts,
                                _jax_cfg(**LAGR), first)
    else:
        part = _partial_run(tseq.run_sequence, frames, pts, _port_cfg(**LAGR),
                            first, device="cpu")
    n = 3
    assert len(part) == n
    assert_same_records(ref[:n], part)
    for load in (jckpt.load_checkpoint, ckpt.load_checkpoint):
        next_frame, _, records = load(first)
        assert next_frame == n and len(records) == n
    second = str(tmp_path / "second.npz")
    shutil.copy(first, second)
    with pallas_interpret():
        by_jax = jseq.run_sequence(frames, pts, _jax_cfg(**LAGR),
                                   checkpoint_path=first)
    by_port = tseq.run_sequence(frames, pts, _port_cfg(**LAGR),
                                checkpoint_path=second, device="cpu")
    assert len(by_port) == 4
    assert_same_records(by_jax, by_port)
    np.testing.assert_allclose(by_port[3].params, ref[3].params, atol=5e-3)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_stop_at_each_poll_matches_jax(tmp_path, k):
    """A should_stop that turns true at its k-th call ends both packages'
    chunked runs after the same records, with the same checkpoint: 3 pairs
    in chunks of 2 poll at chunk 0's dispatch, at chunk 1's dispatch (a
    stop there still emits chunk 0's first record), then before chunk 0's
    second record."""
    frames = drift_frames(4, 1.3, -0.8)
    pts = sectors(CENTERS)
    runs = {}
    for writer in ("jax", "port"):
        calls = []

        def should_stop():
            calls.append(1)
            return len(calls) >= k

        path = str(tmp_path / f"{writer}.npz")
        if writer == "jax":
            with pallas_interpret():
                recs = jseq.run_sequence(frames, pts, _jax_cfg(frame_chunk=2),
                                         should_stop=should_stop,
                                         checkpoint_path=path)
        else:
            recs = tseq.run_sequence(frames, pts, _port_cfg(frame_chunk=2),
                                     should_stop=should_stop,
                                     checkpoint_path=path, device="cpu")
        runs[writer] = (recs, ckpt.load_checkpoint(path)[0], len(calls))
    (ref, ref_next, ref_calls), (got, got_next, got_calls) = (
        runs["jax"], runs["port"])
    assert len(got) == {1: 0, 2: 1, 3: 1}[k]
    assert got_next == ref_next == len(got) and got_calls == ref_calls
    assert_same_records(ref, got)


def test_stop_with_a_chunk_in_flight_matches_jax(monkeypatch, tmp_path):
    """The chunked loop dispatches chunk i + 1 before it fetches and emits
    chunk i, as JAX's does.  5 pairs in chunks of 2: the third poll, before
    chunk 0's second record, stops the run while chunk 1 is in flight;
    chunk 1 is dropped, and both packages keep chunk 0's first record and
    write the same checkpoint."""
    frames = drift_frames(6, 1.3, -0.8)
    pts = sectors(CENTERS)
    events = []
    dispatch = tseq.correlate_frames

    def spy(*args, **kwargs):
        events.append("dispatch")
        return dispatch(*args, **kwargs)

    monkeypatch.setattr(tseq, "correlate_frames", spy)
    runs = {}
    for writer in ("jax", "port"):
        calls = []

        def should_stop():
            calls.append(1)
            return len(calls) >= 3

        path = str(tmp_path / f"{writer}.npz")
        kw = dict(should_stop=should_stop, checkpoint_path=path,
                  on_frame=lambda rec: events.append(("emit", rec.frame)))
        if writer == "jax":
            with pallas_interpret():
                recs = jseq.run_sequence(frames, pts, _jax_cfg(frame_chunk=2),
                                         **kw)
            events.clear()
        else:
            recs = tseq.run_sequence(frames, pts, _port_cfg(frame_chunk=2),
                                     device="cpu", **kw)
        runs[writer] = (recs, ckpt.load_checkpoint(path)[0], len(calls))
    assert events == ["dispatch", "dispatch", ("emit", 0)]
    (ref, ref_next, ref_calls), (got, got_next, got_calls) = (
        runs["jax"], runs["port"])
    assert len(got) == 1 and got_next == ref_next == 1
    assert got_calls == ref_calls == 3
    assert_same_records(ref, got)


def test_checkpoint_round_trip_keeps_every_field(lagr_runs, tmp_path):
    _, (_, got) = lagr_runs
    state = tseq.initial_track_state(
        sectors(CENTERS), None, np.array([46.0, 46.0]),
        np.zeros(6, np.float32), FittingModel.AFFINE,
        contours=[np.zeros((4, 2), np.float32)] * 4)
    path = str(tmp_path / "rt.npz")
    ckpt.save_checkpoint(path, 3, state, got)
    next_frame, state2, records = ckpt.load_checkpoint(path)
    assert next_frame == 3
    for f in dataclasses.fields(tseq._TrackState):
        a, b = getattr(state, f.name), getattr(state2, f.name)
        if isinstance(a, list):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif a is not None:
            np.testing.assert_array_equal(a, b)
    for a, b in zip(records, got):
        for f in dataclasses.fields(tseq.FrameRecord):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, list):
                for p, q in zip(x, y):
                    np.testing.assert_array_equal(p, q)
            else:
                np.testing.assert_array_equal(x, y)


def _pngs(tmp_path, frames):
    paths = []
    for t, f in enumerate(frames):
        p = str(tmp_path / f"s{t:02d}.png")
        Image.fromarray(f[..., 0].astype(np.uint8)).save(p)
        paths.append(p)
    return paths


def test_streaming_sequence_bounded_cache(tmp_path):
    """As tests/test_sequence.py: a 12-frame run decodes at most
    ahead (chunk + 1) + behind (1) + current frames at once."""
    frames = drift_frames(12, 0.3, -0.2, h=64, w=64)
    stats = {}
    records = tseq.run_sequence_from_files(
        _pngs(tmp_path, frames), sectors([(32, 32)], half=12),
        _port_cfg(frame_chunk=3), io_stats=stats, device="cpu")
    assert len(records) == 11
    for t, rec in enumerate(records):
        np.testing.assert_allclose(rec.params[0, :2],
                                   [0.3 * (t + 1), -0.2 * (t + 1)], atol=0.05)
    assert stats["max_cached"] <= 6


@pytest.mark.parametrize("frame_chunk", [1, 3])
def test_png_round_trip(tmp_path, frame_chunk):
    """PNG files through run_sequence_from_files (decoded frames staged as
    uint8) give the records of the in-memory frames."""
    frames = drift_frames(4, 1.3, -0.8)
    pts = sectors(CENTERS)
    cfg = _port_cfg(frame_chunk=frame_chunk)
    from_files = tseq.run_sequence_from_files(_pngs(tmp_path, frames), pts,
                                              cfg, device="cpu")
    in_memory = tseq.run_sequence(frames, pts, cfg, device="cpu")
    assert len(from_files) == 3
    for a, b in zip(from_files, in_memory):
        np.testing.assert_array_equal(a.params, b.params)
        np.testing.assert_array_equal(a.iterations, b.iterations)
        np.testing.assert_array_equal(a.error, b.error)
