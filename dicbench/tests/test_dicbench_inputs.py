"""The cells' inputs: made from the seed alone, and the frozen copies of
the program's generators equal to their originals."""

import numpy as np
import pytest
import torch

from dicbench import harness, spec, texture
from dicbench.motions import homogeneous


def test_inputs_from_seed(tiny_cell):
    a = harness.make_inputs(tiny_cell, 2**31 + 5, "cpu")
    b = harness.make_inputs(tiny_cell, 2**31 + 5, "cpu")
    c = harness.make_inputs(tiny_cell, 17, "cpu")
    assert a.frames.dtype == np.uint8
    assert a.frames.shape == (4, 256, 256, 1)
    assert np.array_equal(a.frames, b.frames)
    assert not np.array_equal(a.frames, c.frames)
    assert all(np.array_equal(p, q) for p, q in zip(a.points, c.points))


def _mix(motion, pairs=4):
    return {"pairs": pairs, "motion": dict(motion, kind="homogeneous")}


FRAME = {"height": 64, "width": 48, "bit_depth": 8, "channels": 1}


def test_frame_zero_is_the_texture():
    mix = _mix({"period_frames": 8, "amplitude": {"exx": 0.02, "rot": 0.01}})
    f = homogeneous.frames(FRAME, mix, 9, "cpu")[..., 0]
    h, w = FRAME["height"], FRAME["width"]
    p = homogeneous.pad(mix["motion"], FRAME, mix["pairs"])
    tex = texture.speckle(h + 2 * p, w + 2 * p, 9, "cpu")[p:p + h, p:p + w]
    assert f.dtype == torch.uint8 and f.shape == (5, h, w)
    assert torch.equal(f[0], tex.to(torch.uint8))
    assert int(f.max()) > 200 and int(f.min()) < 50
    assert not torch.equal(f[1], f[0])


def test_whole_pixel_drift_moves_the_texture():
    """A drift of whole pixels a frame and nothing else moves frame 0's
    pixels unchanged."""
    mix = _mix({"period_frames": 8, "rate": {"tx": 2.0, "ty": 1.0}})
    f = homogeneous.frames(FRAME, mix, 9, "cpu")[..., 0]
    for t in range(1, 5):
        assert torch.equal(f[t, t:, 2 * t:], f[0, :64 - t, :48 - 2 * t])


def test_mapping_of_the_mix():
    """Frame t maps X to c + F (X - c) + d: u and v differ from subset to
    subset, and a constant-velocity guess misses them."""
    cell = spec.load_cell("rect_grid_1mp.eulerian_first")
    frame, motion = cell.config["frame"], cell.mix["motion"]

    def disp(x, t):
        f, d, c = homogeneous.mapping(motion, frame, t)
        return c + f @ (np.asarray(x, float) - c) + d - x

    corner = [40.0, 40.0]
    u = [disp(corner, t) for t in range(4)]
    assert not np.allclose(u[1], disp([500.0, 500.0], 1), atol=0.1)
    assert np.abs(u[3] - (2 * u[2] - u[1])).max() > 0.05
    assert 0.1 < np.abs(u[1]).max() < 3


@pytest.mark.parametrize("name", ["rect_grid_1mp", "annulus_512"])
def test_domains_equal_the_programs(name):
    from correlation_tpu_torch import problems
    from correlation_tpu_torch.domains import AnnularDomain, annular_batch

    cell = spec.load_cell(f"{name}.eulerian_first")
    domain = spec.load("domains", cell.config["domain"]["kind"])
    pts, centers = domain.points(cell.config["domain"], cell.config["frame"])
    if name == "rect_grid_1mp":
        want, want_c = problems._grid(4096, 1024, 10)
        assert np.array_equal(centers, want_c)
    else:
        batch = annular_batch(AnnularDomain(512.0, 480.0, 120.0, 400.0, 8, 64),
                              0)
        want = [xy[m] for xy, m in zip(batch.xy[0], batch.mask[0])]
        assert centers is None
    assert len(pts) == len(want)
    assert all(np.array_equal(p, q) for p, q in zip(pts, want))
