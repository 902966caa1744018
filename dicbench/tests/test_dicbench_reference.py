"""The plain reference against the program, and the control: the
reference computed with its pixel arithmetic in bfloat16, the precision
below the configuration's float32, which the cell's limits must reject."""

import numpy as np
import pytest
import torch

from dicbench import check, harness
from dicbench.motions import homogeneous


def _program(cell, inputs):
    from correlation_tpu_torch.sequence import run_sequence

    scfg = harness.sequence_config(cell.config, cell.mix, "torch")
    recs = run_sequence(harness.Frames(inputs.frames), inputs.points, scfg,
                        centers=inputs.centers, device="cpu")
    out = harness.Outputs()
    out.add(recs)
    return next(iter(out.distinct.values()))


@pytest.mark.parametrize("seed", [3, 2**31 + 77])
def test_reference_against_the_program(tiny_cell, seed):
    inputs = harness.make_inputs(tiny_cell, seed, "cpu")
    ref = check.reference_outputs(tiny_cell, inputs, "cpu")
    got = _program(tiny_cell, inputs)
    gaps = check.gaps(got, ref)
    for k, limit in tiny_cell.checks.items():
        assert gaps[k] <= limit / 10, (k, gaps[k])
    assert (got["error"] == ref["error"]).all()
    assert (got["iterations"] != ref["iterations"]).mean() < 0.2
    # The motion's own displacement of each subset's center.
    centers = (inputs.centers if inputs.centers is not None
               else np.array([p.mean(0) for p in inputs.points]))
    for t in range(tiny_cell.mix["pairs"]):
        f, d, c = homogeneous.mapping(tiny_cell.mix["motion"],
                                      tiny_cell.config["frame"], t + 1)
        truth = (centers - c) @ f.T + c + d - centers
        assert np.abs(ref["params"][t, :, :2] - truth).max() < 0.05


def test_control_fails_the_limits(tiny_cell):
    inputs = harness.make_inputs(tiny_cell, 5, "cpu")
    ref = check.reference_outputs(tiny_cell, inputs, "cpu")
    ctrl = check.reference_outputs(tiny_cell, inputs, "cpu", torch.float32,
                                   torch.bfloat16)
    gaps = check.gaps(ctrl, ref)
    assert any(gaps[k] > limit for k, limit in tiny_cell.checks.items())
