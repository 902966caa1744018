"""batch_on_device_pct: the share of the recorded subset batches that the
program built on the card, read from a recording's counters; None where
there is no recording or it has no batch counters (a program from before
them)."""

import types

import pytest

from dicbench import spec

NAME = "batch_on_device_pct"
CELLS = ("rect_grid_1mp.eulerian_first", "annulus_512.eulerian_first",
         "blob_e8_gauge.eulerian_first")


def read(counters):
    """The metric on a run whose recording has `counters` (None: the
    program has no recording())."""
    rec = None if counters is None else types.SimpleNamespace(
        counters=counters, spans=[])
    return spec.load("metrics", NAME).read(
        types.SimpleNamespace(_program_record=rec))


@pytest.mark.parametrize("on_device, batches, want", [
    (2, 2, 100.0), (0, 2, 0.0), (1, 4, 25.0)])
def test_reads_a_recording(on_device, batches, want):
    assert read({"steps": 10176, "empty_steps": 0, "levels": 192,
                 "native_levels": 192, "split_levels": 0,
                 "batches": batches, "batches_on_device": on_device}) == want


@pytest.mark.parametrize("counters", [
    None, {"steps": 10176, "empty_steps": 8744, "levels": 192,
           "native_levels": 192, "split_levels": 0}, {"batches": 0}],
    ids=["no recording", "no batch counters", "no batch"])
def test_nothing_to_read(counters):
    assert read(counters) is None


@pytest.mark.parametrize("cell", CELLS)
def test_entry(cell):
    """A sequence metric of every cell, read from a program counter."""
    (m,) = [m for m in spec.load_cell(cell).per_layer if m["name"] == NAME]
    assert (m["unit"], m["layer"], m["source"], m["moves"]) == (
        "%", "sequence", "program_counter", "solves_per_s")
