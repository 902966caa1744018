"""The coefficient-field path on the card against the same code on the CPU.

The field is an exact fixed-order sum and the field assembly uses
elementwise operations, gathers and the fused kernel's summation order
only, so the card must equal the CPU bit for bit: the field, the
assembly, the phase-correlation seeds and a chained solve.
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
from correlation_tpu_torch.ops.assemble import field_assemble
from correlation_tpu_torch.ops.interp import precompute_field
from correlation_tpu_torch.ops.seed import phase_correlation_guess
from correlation_tpu_torch.problems import drifting_sequence, speckle

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _image(channels, h=120, w=150):
    return np.stack([np.floor(speckle(h, w, 1) * f) for f in
                     (1.0, 0.8, 0.6, 0.45)[:channels]], -1).astype(np.float32)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("model", list(FittingModel), ids=lambda m: m.name)
@pytest.mark.parametrize("interp", list(Interpolation), ids=lambda i: i.name)
def test_field_and_assembly_on_card_equal_cpu(dev, interp, model, channels):
    img = _image(channels)
    field_cpu = precompute_field(torch.from_numpy(img), interp)
    field_dev = precompute_field(torch.from_numpy(img).to(dev), interp)
    assert torch.equal(field_dev.field.cpu(), field_cpu.field)
    rng = np.random.default_rng(int(model) + 4 * channels)
    s, side = 30, 13
    xy = np.zeros((s, side * side, 2), np.float32)
    for i in range(s):
        cx, cy = rng.integers(2, 148), rng.integers(2, 118)
        gx, gy = np.meshgrid(np.arange(cx - 6, cx + 7),
                             np.arange(cy - 6, cy + 7), indexing="ij")
        xy[i] = np.stack([gx.ravel(), gy.ravel()], -1)
    mask = np.ones(xy.shape[:2], bool)
    mask[0, -20:] = False
    center = xy.mean(axis=1).astype(np.float32)
    und_w = img[np.clip(xy[..., 1], 0, 119).astype(int),
                np.clip(xy[..., 0], 0, 149).astype(int)]
    params = rng.normal(0, 0.02, (s, NUM_PARAMS[model])).astype(np.float32)
    params[:, 0] += 0.6
    params[3, 0] = 500.0  # out of the image
    idx = np.array([5, 3, 3, 0, 29, 12, 5], np.int32)  # with repeats

    def run(device):
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        field = field_dev if device != "cpu" else field_cpu
        pix = v2.pack_pixels(t(xy), t(mask), t(und_w), t(center))
        return (field_assemble(model, interp, field, pix, t(center),
                               t(params)),
                field_assemble(model, interp, field, pix, t(center),
                               t(params), t(idx)))

    (whole, part), (whole_c, part_c) = run(dev), run("cpu")
    assert torch.equal(whole.cpu(), whole_c)
    assert torch.equal(part.cpu(), part_c)
    assert torch.equal(part_c, whole_c[torch.as_tensor(idx).long()])
    n = NUM_PARAMS[model]
    assert whole_c[3, n + 1, n + 1] > 0


def test_phase_correlation_on_card_equals_cpu(dev):
    big = speckle(256, 300, 2)
    und = big[:, 40:296, None]
    dfm = big[:, 0:256, None]  # u = +40
    centers = np.array([(cx, cy) for cx in (64, 128, 192)
                        for cy in (64, 128, 192)], np.float32)
    card = phase_correlation_guess(und, dfm, centers, win=128, device=dev)
    cpu = phase_correlation_guess(und, dfm, centers, win=128, device="cpu")
    np.testing.assert_array_equal(card, cpu)
    np.testing.assert_array_equal(card, np.tile([40.0, 0.0], (9, 1)))


@pytest.mark.parametrize("channels", [1, 4])
def test_field_frames_on_card_equal_cpu(dev, channels):
    frames = drifting_sequence(3, img_hw=256)
    frames = np.concatenate([frames, 255 - frames, frames // 2,
                             frames // 3 + 64][:channels], axis=-1)
    pts = []
    for cx in range(48, 208, 32):
        for cy in range(48, 200, 32):
            gx, gy = np.meshgrid(np.arange(cx - 10, cx + 11),
                                 np.arange(cy - 10, cy + 11), indexing="ij")
            pts.append(np.stack([gx.ravel(), gy.ravel()], -1))
    cfg = SolverConfig(pyramid=PyramidConfig(0, 1, 2), backend="field")
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
