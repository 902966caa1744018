"""The port against the benchmark's plain reference (dicbench/reference,
which imports nothing of the port) at a CPU test's size: the blob cell's
ASTM E8 gauge blob scaled onto 256 x 256 frames (more than 2048 px at
levels 0 and 1, so K1's split path runs in the plain version's order),
and the grid cell's domain solved Lagrangian / Previous through the
reference's own chain.  Then what the program reports of them: the
point-mean centre, the split_levels counter and the seq.advance span."""

import copy
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from correlation_tpu_torch.config import DeformationDescription  # noqa: E402
from correlation_tpu_torch.domains import make_batch  # noqa: E402
from correlation_tpu_torch.ops import assemble_v2 as v2  # noqa: E402
from correlation_tpu_torch.sequence import run_sequence  # noqa: E402
from correlation_tpu_torch.utils import profiling  # noqa: E402
from dicbench import check, harness, spec  # noqa: E402

torch.set_num_threads(2)

BLOB = "blob_e8_gauge.eulerian_first"
# The grid cell's domain and motion, solved Lagrangian / Previous: no
# cell of the benchmark runs it (its whole-pixel moves round one way in
# float32 and the other in float64 on a few subsets a sequence, so its
# gaps need a check that scores those apart).
LAGR = "rect_grid_1mp.lagrangian_previous"
PAIRS = 3
SEEDS = [7, 2**31 + 101]


def small(name: str):
    """The cell on 256 x 256 frames, PAIRS pairs: the blob at 3.2 px/mm
    about the frame's centre; the grid with 64 subsets and a drift of
    (0.9, 0.8) px a frame, so that the domain moves by a whole pixel each
    way before every pair but the first."""
    cell = spec.load_cell(BLOB if name == BLOB else
                          "rect_grid_1mp.eulerian_first")
    config = copy.deepcopy(cell.config)
    config["frame"].update(height=256, width=256)
    mix = dict(cell.mix, pairs=PAIRS)
    if name == BLOB:
        config["domain"].update(px_per_mm=3.2, center=[127.5, 127.5])
    else:
        config["domain"].update(subsets=64)
        mix.update(name="lagrangian_previous", deformation="LAGRANGIAN",
                   reference="PREVIOUS",
                   motion=dict(mix["motion"], rate={"tx": 0.9, "ty": 0.8}))
    return dataclasses.replace(cell, name=name, config=config, mix=mix)


def _run(cell, inputs, **kw):
    scfg = dataclasses.replace(
        harness.sequence_config(cell.config, cell.mix, "torch"), **kw)
    return run_sequence(harness.Frames(inputs.frames), inputs.points, scfg,
                        centers=inputs.centers, device="cpu")


def _arrays(recs):
    out = harness.Outputs()
    out.add(recs)
    return next(iter(out.distinct.values()))


@pytest.mark.parametrize("name", [BLOB, LAGR])
@pytest.mark.parametrize("seed", SEEDS)
def test_port_against_the_reference(name, seed):
    """Parameters within a tenth of the cell's limits of the float64
    reference's (the grid cell's limits for the Lagrangian solve), error
    codes equal."""
    cell = small(name)
    inputs = harness.make_inputs(cell, seed, "cpu")
    got = _arrays(_run(cell, inputs))
    ref = check.reference_outputs(cell, inputs, "cpu")
    gaps = check.gaps(got, ref)
    for k, limit in cell.checks.items():
        assert gaps[k] <= limit / 10, (k, gaps[k])
    np.testing.assert_array_equal(got["error"], ref["error"])
    if name == BLOB:
        masks = make_batch(inputs.points, None, 2).mask
        assert [int(m.sum()) > v2.CHUNK_MIN_PIXELS for m in masks] == [
            True, True, False]
    else:
        # Every subset moved before pairs 2 and 3.
        assert (np.floor(ref["params"][:-1, :, :2] + 0.5) >= 1).all()


def test_point_mean_centre_of_the_e8_blob():
    """make_batch centres the blob cell's 140,672-px subset on the float64
    mean of its points, rounded to float32 (a float32 sum taken one point
    at a time lands 0.38 px off it, and u and v with it)."""
    dom = spec.load_cell(BLOB).config["domain"]
    (pts,), centers = spec.load("domains", "blob").points(dom, None)
    assert centers is None and len(pts) == 140672
    want = np.asarray(pts, np.float64).mean(axis=0).astype(np.float32)
    np.testing.assert_array_equal(make_batch([pts], None, 2).center0[0],
                                  want)


@pytest.mark.parametrize("name, split", [(BLOB, [True, True, False]),
                                         (LAGR, [False, False, False])])
def test_split_levels_counted(name, split):
    """split_levels counts the levels whose padded subsets subset_chunks
    cuts into spans: the blob's two finer levels, none of a 21 x 21
    grid's."""
    cell = small(name)
    inputs = harness.make_inputs(cell, SEEDS[0], "cpu")
    batch = make_batch(inputs.points, inputs.centers, 2)
    assert [v2.subset_chunks(x.shape[1]) > 1 for x in batch.xy] == split
    with profiling.recording() as rec:
        _run(cell, inputs)
    assert rec.counters["levels"] == 3 * PAIRS
    assert rec.counters["split_levels"] == sum(split) * PAIRS
    assert rec.counters["native_levels"] == 0


def _advances(rec):
    return [(s, rec.spans[s.parent].name if s.parent is not None else None)
            for s in rec.spans if s.name == profiling.SEQ_ADVANCE]


@pytest.mark.parametrize("chunk", [64, 1], ids=["chunked", "pair_by_pair"])
@pytest.mark.parametrize("deformation", list(DeformationDescription),
                         ids=lambda d: d.name)
def test_advance_span(chunk, deformation):
    """seq.advance opens once a pair after the first of a Lagrangian
    sequence (inside the chunk's seq.emit, or before the pair's solve),
    never in an Eulerian one; a recording leaves the records as they
    are."""
    cell = small(LAGR)
    inputs = harness.make_inputs(cell, SEEDS[1], "cpu")
    kw = dict(frame_chunk=chunk, deformation=deformation)
    plain = _run(cell, inputs, **kw)
    with profiling.recording() as rec:
        recorded = _run(cell, inputs, **kw)
    spans = _advances(rec)
    if deformation == DeformationDescription.EULERIAN:
        assert spans == []
    else:
        assert len(spans) == PAIRS - 1
        chunked = (chunk > 1 and deformation
                   == DeformationDescription.LAGRANGIAN)
        want = profiling.SEQ_EMIT if chunked else profiling.SEQ_RUN
        assert {p for _, p in spans} == {want}
        assert all(s.end_ns >= s.start_ns > 0 for s, _ in spans)
    assert len(plain) == len(recorded) == PAIRS
    for a, b in zip(plain, recorded):
        for f in ("params", "chi", "iterations", "error", "und_center",
                  "def_center"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_advance_span_off_opens_no_record_function(monkeypatch):
    """With neither a recording nor a profiler, the domain advance opens
    no record_function."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    cell = small(LAGR)
    inputs = harness.make_inputs(cell, SEEDS[0], "cpu")
    assert len(_run(cell, inputs)) == PAIRS
