"""On the card: a short traced run of each cell at a reduced size reads
every per-layer metric, each share of a bound inside (0, 100], and is
correct."""

import time

import pytest

from dicbench import harness
from conftest import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rect_grid_1mp.eulerian_first",
                                  "annulus_512.eulerian_first"])
def test_traced_run_on_the_card(card, name):
    from dicbench import spec

    cell = tiny(spec.load_cell(name))
    res = harness.run_cell(cell, 2**31 + 3, 0.5, True, time.perf_counter())
    assert res["correct"] is True
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer}
    for name in ("k1_roofline", "lm_step_roofline"):
        assert 0 < res["metrics"][name]["value"] <= 100
    assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
    assert res["breakdown"]["device_ops"] and res["breakdown"]["idle_gaps"]
