"""lm_graph_reuse_pct: the share of the recorded levels run as one CUDA
graph launch on a graph kept from an earlier level, read from a
recording's counters; None where there is no recording, it has no graph
counters (a program from before them), or no level ran as a graph."""

import types

import pytest

from dicbench import spec

NAME = "lm_graph_reuse_pct"
CELLS = ("rect_grid_1mp.eulerian_first", "annulus_512.eulerian_first",
         "blob_e8_gauge.eulerian_first")


def read(counters):
    """The metric on a run whose recording has `counters` (None: the
    program has no recording())."""
    rec = None if counters is None else types.SimpleNamespace(
        counters=counters, spans=[])
    return spec.load("metrics", NAME).read(
        types.SimpleNamespace(_program_record=rec))


@pytest.mark.parametrize("levels, made, want", [
    (192, 0, 100.0), (192, 192, 0.0), (192, 3, 98.4375)])
def test_reads_a_recording(levels, made, want):
    assert read({"steps": 2000, "empty_steps": 0, "levels": levels,
                 "native_levels": levels, "graph_levels": levels,
                 "graph_instantiations": made}) == want


@pytest.mark.parametrize("counters", [
    None, {"steps": 10176, "empty_steps": 8744, "levels": 192,
           "native_levels": 192},
    {"levels": 192, "graph_levels": 0, "graph_instantiations": 0}],
    ids=["no recording", "no graph counters", "zero levels"])
def test_nothing_to_read(counters):
    assert read(counters) is None


def test_entry():
    """An engine metric of the three cells, read from a program counter,
    higher better, moving solves_per_s."""
    for cell in CELLS:
        (m,) = [m for m in spec.load_cell(cell).per_layer
                if m["name"] == NAME]
        assert (m["unit"], m["better"], m["layer"], m["source"],
                m["moves"]) == ("%", "higher", "engine", "program_counter",
                                "solves_per_s")
        assert m["workloads"] == list(CELLS)
