"""The separable-tile path (backend "sep") on the card against the same
code on the CPU.

The separable assembly uses elementwise operations, gathers and the fused
kernel's summation order only, so the card must equal the CPU bit for
bit: the assembly for every model, interpolation and channel count, with
repeated indices, and chained solves, 4 channels under "auto" included.
"""

import numpy as np
import pytest
import torch

from correlation_tpu_torch import correlate_frames, make_batch
from correlation_tpu_torch.config import (
    NUM_PARAMS,
    FittingModel,
    Interpolation,
    PyramidConfig,
    SolverConfig,
)
from correlation_tpu_torch.ops import assemble_v2 as v2
from correlation_tpu_torch.ops import solve
from correlation_tpu_torch.ops.assemble import sep_assemble
from correlation_tpu_torch.problems import drifting_sequence, speckle

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("model", list(FittingModel), ids=lambda m: m.name)
@pytest.mark.parametrize("interp", list(Interpolation), ids=lambda i: i.name)
def test_sep_assembly_on_card_equals_cpu(dev, interp, model, channels):
    h, w, tile = 120, 150, 24
    img = np.stack([np.floor(speckle(h, w, 1) * f) for f in
                    (1.0, 0.8, 0.6, 0.45)[:channels]], -1).astype(np.float32)
    rng = np.random.default_rng(int(model) + 4 * channels)
    s, side = 30, 13
    xy = np.zeros((s, side * side, 2), np.float32)
    for i in range(s):
        cx, cy = rng.integers(2, w - 2), rng.integers(2, h - 2)
        gx, gy = np.meshgrid(np.arange(cx - 6, cx + 7),
                             np.arange(cy - 6, cy + 7), indexing="ij")
        xy[i] = np.stack([gx.ravel(), gy.ravel()], -1)
    mask = np.ones(xy.shape[:2], bool)
    mask[0, -20:] = False
    mask[1] = xy[1].sum(axis=-1) >= xy[1].sum(axis=-1).mean()  # a triangle
    mask[2] = False
    center = xy.mean(axis=1).astype(np.float32)
    und_w = img[np.clip(xy[..., 1], 0, h - 1).astype(int),
                np.clip(xy[..., 0], 0, w - 1).astype(int)]
    params = rng.normal(0, 0.02, (s, NUM_PARAMS[model])).astype(np.float32)
    params[:, 0] += 0.6
    params[3, 0] = 500.0  # out of the image
    if model == FittingModel.AFFINE:
        params[4, 2] = 1.2  # out of its tile
    idx = np.array([5, 3, 3, 0, 29, 12, 5, 1, 2], np.int32)  # with repeats

    def run(device):
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        pix = v2.pack_pixels(t(xy), t(mask), t(und_w), t(center))
        return (sep_assemble(model, interp, tile, tile, h, w, t(img), pix,
                             t(center), t(params)),
                sep_assemble(model, interp, tile, tile, h, w, t(img), pix,
                             t(center), t(params), t(idx)))

    (whole, part), (whole_c, part_c) = run(dev), run("cpu")
    assert torch.equal(whole.cpu(), whole_c)
    assert torch.equal(part.cpu(), part_c)
    assert torch.equal(part_c, whole_c[torch.as_tensor(idx).long()])
    n = NUM_PARAMS[model]
    assert whole_c[3, n + 1, n + 1] > 0
    assert (whole_c[2] == 0).all()


@pytest.mark.parametrize("channels,backend", [(1, "sep"), (4, "sep"),
                                              (4, "auto")])
def test_sep_frames_on_card_equal_cpu(dev, channels, backend):
    frames = drifting_sequence(3, img_hw=256)
    frames = np.concatenate([frames, 255 - frames, frames // 2,
                             frames // 3 + 64][:channels], axis=-1)
    pts = []
    for cx in range(16, 250, 32):
        for cy in range(16, 220, 32):
            gx, gy = np.meshgrid(np.arange(cx - 10, cx + 11),
                                 np.arange(cy - 10, cy + 11), indexing="ij")
            pts.append(np.stack([gx.ravel(), gy.ravel()], -1))
    cfg = SolverConfig(pyramid=PyramidConfig(0, 1, 2), backend=backend)
    guess = np.zeros((len(pts), 6), np.float32)
    v2.reset_launches()
    card = correlate_frames(cfg, frames, make_batch(pts, None, 2), guess,
                            device=dev)
    solve.resolve_launches()
    assert v2.LAUNCHES == 0
    cpu = correlate_frames(cfg, frames, make_batch(pts, None, 2), guess,
                           device="cpu")
    for key in ("params", "chi", "iterations", "error"):
        assert torch.equal(card[key].cpu(), cpu[key]), key
    for t in range(3):
        np.testing.assert_allclose(
            np.median(cpu["params"][t, :, :2].numpy(), axis=0),
            [0.0, t + 1.0], atol=0.02)
