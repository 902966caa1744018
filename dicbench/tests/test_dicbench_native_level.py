"""lm_native_level_pct: the share of the recorded pyramid levels whose LM
loop the program issued by one call into the kernel library, read from a
recording's counters; None where there is no recording or it has no
level counters (a program from before them)."""

import types

import pytest

from dicbench import spec

NAME = "lm_native_level_pct"


def read(counters):
    """The metric on a run whose recording has `counters` (None: the
    program has no recording())."""
    rec = None if counters is None else types.SimpleNamespace(
        counters=counters, spans=[])
    return spec.load("metrics", NAME).read(
        types.SimpleNamespace(_program_record=rec))


@pytest.mark.parametrize("native, levels, want", [
    (192, 192, 100.0), (0, 192, 0.0), (48, 192, 25.0)])
def test_reads_a_recording(native, levels, want):
    assert read({"steps": 53 * levels, "empty_steps": 0, "levels": levels,
                 "native_levels": native}) == want


@pytest.mark.parametrize("counters", [
    None, {"steps": 10176, "empty_steps": 8744}, {"levels": 0}],
    ids=["no recording", "no level counters", "no level"])
def test_nothing_to_read(counters):
    assert read(counters) is None


def test_entry():
    """An engine metric of both cells, read from a program counter."""
    for cell in ("rect_grid_1mp.eulerian_first", "annulus_512.eulerian_first"):
        (m,) = [m for m in spec.load_cell(cell).per_layer
                if m["name"] == NAME]
        assert (m["unit"], m["layer"], m["source"], m["moves"]) == (
            "%", "engine", "program_counter", "solves_per_s")
