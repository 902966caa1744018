"""The CUDA fused assembly against its plain PyTorch version, on the card.

The plain version sums the Gram in the kernel's order and both round every
per-pixel operation alike, so the kernel must equal it bit for bit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from correlation_tpu_torch import correlate, make_batch
from correlation_tpu_torch.config import (
    NUM_PARAMS,
    FittingModel,
    Interpolation,
    PyramidConfig,
    SolverConfig,
)
from correlation_tpu_torch.ops import assemble_v2 as v2
from correlation_tpu_torch.ops.pyramid import build_pyramid
from correlation_tpu_torch.problems import speckle

pytestmark = pytest.mark.cuda

GRID = [
    (FittingModel.AFFINE, Interpolation.BICUBIC),
    (FittingModel.UV, Interpolation.BILINEAR),
    (FittingModel.UVQ, Interpolation.BICUBIC),
    (FittingModel.U, Interpolation.NEAREST),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _args(model, interp, channels, dev, s=40):
    rng = np.random.default_rng(int(model) * 10 + channels)
    img = np.stack([speckle(120, 150, 1) * f
                    for f in (1.0, 0.8, 0.6)[:channels]], -1)
    side = 13
    xy = np.zeros((s, side * side, 2), np.float32)
    for i in range(s):
        cx, cy = rng.integers(8, 142), rng.integers(8, 112)
        if i == 0:
            cx, cy = 4, 60  # reaches past the left edge: bad pixels
        gx, gy = np.meshgrid(np.arange(cx - 6, cx + 7),
                             np.arange(cy - 6, cy + 7), indexing="ij")
        xy[i] = np.stack([gx.ravel(), gy.ravel()], -1)
    mask = rng.random((s, side * side)) > 0.1
    center = xy.mean(axis=1).astype(np.float32)
    und = img[np.clip(xy[..., 1], 0, 119).astype(int),
              np.clip(xy[..., 0], 0, 149).astype(int)]
    num_p = NUM_PARAMS[model]
    params = rng.normal(0, 0.05, (s, num_p)).astype(np.float32)
    params[:, :2] += rng.normal(0, 2.0, (s, min(2, num_p)))

    def t(a):
        return torch.as_tensor(a, device=dev)

    th, tw = v2.choose_tile(12, 12, 120, 152)
    xy_t, mask_t, center_t = t(xy), t(mask), t(center)
    return (model, interp, th, tw, 120, 150, v2.prepare_image(t(img), th, tw),
            v2.pack_pixels(xy_t, mask_t, t(und), center_t), center_t,
            t(params), v2.subset_bbox(xy_t, mask_t))


@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("model,interp", GRID)
def test_kernel_equals_plain(dev, model, interp, channels):
    args = _args(model, interp, channels, dev)
    got = v2.fused_assemble(*args)
    again = v2.fused_assemble(*args)
    ref = v2.fused_assemble_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # repeatable run to run
    assert torch.equal(got, ref)
    assert got[0, NUM_PARAMS[model] + 1, NUM_PARAMS[model] + 1] > 0


def test_index_list_on_card(dev):
    args = _args(FittingModel.AFFINE, Interpolation.BICUBIC, 1, dev)
    full = v2.fused_assemble(*args)
    idx = torch.tensor([5, 0, 39, 5], dtype=torch.int32, device=dev)
    part = v2.fused_assemble(*args, idx)
    assert torch.equal(part, full[idx.long()])
    empty = v2.fused_assemble(*args, idx[:0])
    assert empty.shape == (0, 8, 8)


def test_index_out_of_range_stops_kernel(dev):
    # The kernel checks each index against S and traps, which leaves the
    # CUDA context unusable: run it in a process of its own.
    code = (
        "import torch, tests_gpu.test_kernels_gpu as t\n"
        "from correlation_tpu_torch.ops import assemble_v2 as v2\n"
        "dev = torch.device('cuda')\n"
        "args = t._args(t.FittingModel.AFFINE, t.Interpolation.BICUBIC, 1,"
        " dev)\n"
        "ok = torch.tensor([39], dtype=torch.int32, device=dev)\n"
        "v2.fused_assemble(*args, ok); torch.cuda.synchronize()\n"
        "print('valid index ok', flush=True)\n"
        "bad = torch.tensor([0, 40], dtype=torch.int32, device=dev)\n"
        "v2.fused_assemble(*args, bad); torch.cuda.synchronize()\n"
        "print('out-of-range index passed', flush=True)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert "valid index ok" in proc.stdout, proc.stderr
    assert "out-of-range index passed" not in proc.stdout
    assert proc.returncode != 0


def test_backend_must_match_device(dev):
    img = speckle(64, 64, 3)
    pyr = [a.to(dev) for a in build_pyramid(torch.as_tensor(img[..., None]),
                                            0)]
    pts = [np.stack(np.meshgrid(np.arange(22, 43), np.arange(22, 43),
                                indexing="ij"), -1).reshape(-1, 2)]
    cfg = SolverConfig(pyramid=PyramidConfig(0, 1, 0), backend="torch")
    with pytest.raises(ValueError):
        correlate(cfg, pyr, pyr, make_batch(pts, None, 0),
                  np.zeros((1, 6), np.float32))


def test_correlate_on_card_equals_cpu(dev):
    img = speckle(96, 96, 5)
    dfm = np.roll(img, 1, axis=0)
    und_pyr = build_pyramid(torch.as_tensor(img[..., None]), 2)
    def_pyr = build_pyramid(torch.as_tensor(dfm[..., None]), 2)
    pts = [
        np.stack(np.meshgrid(np.arange(cx - 8, cx + 9),
                             np.arange(cy - 8, cy + 9), indexing="ij"),
                 -1).reshape(-1, 2)
        for cx in (30, 48, 66) for cy in (30, 48, 66)
    ]
    batch = make_batch(pts, None, 2)
    cfg = SolverConfig(pyramid=PyramidConfig(0, 1, 2))
    p0 = np.zeros((9, 6), np.float32)
    cpu = correlate(cfg, und_pyr, def_pyr, batch, p0)
    before = v2.LAUNCHES
    gpu = correlate(cfg, [a.to(dev) for a in und_pyr],
                    [a.to(dev) for a in def_pyr], batch, p0)
    assert v2.LAUNCHES > before
    np.testing.assert_allclose(gpu.params.cpu().numpy(), cpu.params.numpy(),
                               atol=1e-4)
    np.testing.assert_array_equal(gpu.error.cpu().numpy(), cpu.error.numpy())
