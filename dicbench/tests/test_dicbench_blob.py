"""The blob_e8_gauge.eulerian_first cell: its files found by name, the
outline of the ASTM E8 specimen's gauge region and its frozen rasterizer
against the program's, the harness on a reduced blob whose two finer
levels take K1's split path, the control failing the cell's limits, and
k1_split_level_pct, read from the program's split_levels counter.  The
program against the reference on that blob is
tests/test_torch_bench_cells.py's."""

import copy
import dataclasses
import time
import types

import numpy as np
import pytest

from dicbench import check, harness, spec

CELL = "blob_e8_gauge.eulerian_first"


def tiny(pairs: int = 3):
    """The cell at a CPU test's size: 256 x 256 frames and the outline at
    3.2 px/mm about the frame's centre (10,040 px at level 0, 2,510 at
    level 1, both on K1's split path, 628 at level 2), `pairs` pairs;
    motion and limits unchanged."""
    cell = spec.load_cell(CELL)
    config = copy.deepcopy(cell.config)
    config["frame"].update(height=256, width=256)
    config["domain"].update(px_per_mm=3.2, center=[127.5, 127.5])
    return dataclasses.replace(cell, config=config,
                               mix=dict(cell.mix, pairs=pairs))


def _domain():
    return spec.load("domains", "blob")


def test_the_cell_loads():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1
    dom = cell.config["domain"]
    assert dom["kind"] == "blob"
    assert dom["dimensions_mm"] == {"A": 57, "W": 12.5, "R": 12.5, "C": 20}
    assert cell.mix["name"] == "eulerian_first"
    assert set(cell.checks) == {"uv_gap_px", "strain_gap"}
    names = {m["name"] for m in cell.per_layer}
    assert "k1_split_level_pct" in names
    assert {m["name"] for m in cell.end_to_end} == {
        "solves_per_s", "peak_mem_gib", "setup_s"}


def test_the_outline():
    """The reduced section and both fillets out to the grip width at
    12 px/mm: 898.2 x 240 px about the frame's centre, the reduced
    section 150 px wide, non-convex at the fillets."""
    dom = spec.load_cell(CELL).config["domain"]
    c = _domain().contour(dom)
    span = c.max(0) - c.min(0)
    fillet = np.sqrt(12.5 ** 2 - (12.5 - 3.75) ** 2)
    np.testing.assert_allclose(span, [(57 + 2 * fillet) * 12, 240])
    np.testing.assert_allclose((c.max(0) + c.min(0)) / 2, dom["center"])
    assert len(c) == 4 * dom["arc_vertices"]
    # The narrowest rows are the reduced section's: 150 px.
    (pts,), centers = _domain().points(dom, None)
    assert centers is None
    mid = pts[pts[:, 0] == 511]
    assert len(mid) == 150
    # Non-convex: the grips reach wider than the reduced section.
    assert np.ptp(pts[pts[:, 0] == 63][:, 1]) > np.ptp(mid[:, 1])


def test_frozen_rasterizer_equals_the_programs():
    from correlation_tpu_torch.domains import blob_inside_points_crossing

    dom = spec.load_cell(CELL).config["domain"]
    c = _domain().contour(dom)
    got = _domain().inside_points_crossing(c)
    np.testing.assert_array_equal(got, blob_inside_points_crossing(c))


def test_point_count_is_stable():
    dom = spec.load_cell(CELL).config["domain"]
    (a,), _ = _domain().points(dom, None)
    (b,), _ = _domain().points(copy.deepcopy(dom), None)
    assert len(a) == len(b) == 140672
    np.testing.assert_array_equal(a, b)


def test_every_level_on_the_split_path():
    from correlation_tpu_torch.domains import make_batch
    from correlation_tpu_torch.ops import assemble_v2 as v2

    (pts,), _ = _domain().points(spec.load_cell(CELL).config["domain"],
                                 None)
    batch = make_batch([pts], None, 2)
    assert [int(m.sum()) for m in batch.mask] == [140672, 35168, 8736]
    assert [v2.subset_chunks(x.shape[1]) for x in batch.xy] == [275, 69, 18]


def test_control_fails_the_limits():
    import torch

    cell = tiny()
    inputs = harness.make_inputs(cell, 5, "cpu")
    ref = check.reference_outputs(cell, inputs, "cpu")
    ctrl = check.reference_outputs(cell, inputs, "cpu", torch.float32,
                                   torch.bfloat16)
    gaps = check.gaps(ctrl, ref)
    assert any(gaps[k] > limit for k, limit in cell.checks.items())


def test_the_harness_runs_the_cell():
    res = harness.run_cell(tiny(), 2**31 + 11, 0.2, True,
                           time.perf_counter(), device="cpu",
                           backend="torch")
    assert res["correct"] is True and res["failed"] == 0
    # Levels 0 and 1 of the reduced blob take the split path, level 2 not.
    assert res["metrics"]["k1_split_level_pct"]["value"] == pytest.approx(
        200.0 / 3)


def _read(counters):
    rec = None if counters is None else types.SimpleNamespace(
        counters=counters, spans=[])
    return spec.load("metrics", "k1_split_level_pct").read(
        types.SimpleNamespace(_program_record=rec))


def test_split_level_pct_reads_the_counters():
    assert _read({"steps": 10, "empty_steps": 0, "levels": 192,
                  "native_levels": 192, "split_levels": 192}) == 100.0
    assert _read({"levels": 4, "split_levels": 1}) == 25.0


@pytest.mark.parametrize("counters", [
    None, {"steps": 10, "empty_steps": 0, "levels": 192,
           "native_levels": 192}, {"levels": 0, "split_levels": 0}],
    ids=["no recording", "no split_levels counter", "no level"])
def test_split_level_pct_reads_none_without_the_counter(counters):
    assert _read(counters) is None
