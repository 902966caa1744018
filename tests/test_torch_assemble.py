"""The port's fused assembly against the JAX Pallas kernel.

correlation_tpu_torch.ops.assemble_v2.fused_assemble_reference (the plain
PyTorch version of the CUDA kernel) is held against
correlation_tpu.ops.assemble_v2.fused_assemble run with interpret=True,
which takes the kernel's non-DMA path: the tile contract the port follows.
The CUDA kernel itself is compared with the plain version on the card by
tests_gpu/ and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from correlation_tpu.config import FittingModel as JModel
from correlation_tpu.config import Interpolation as JInterp
from correlation_tpu.ops import assemble_v2 as jv2
from correlation_tpu_torch.config import FittingModel, Interpolation
from correlation_tpu_torch.ops import assemble_v2 as tv2
from synthetic import Speckle

torch.set_num_threads(2)

_NP = {0: 1, 1: 2, 2: 3, 3: 6}

# (model, interpolation) pairs of tests/test_assemble_v2.py.
GRID = [
    (FittingModel.AFFINE, Interpolation.BICUBIC),
    (FittingModel.UV, Interpolation.BILINEAR),
    (FittingModel.UVQ, Interpolation.BICUBIC),
    (FittingModel.U, Interpolation.NEAREST),
]


def _problem(model, s=5, side=11, channels=1, seed=4):
    spk = Speckle(96, 130, seed=9)
    und = np.floor(spk.image())
    dfm = np.floor(spk.warped_image(u=0.7, v=-0.4))
    scale = (1.0, 0.8, 0.6)[:channels]
    und = np.stack([und * f for f in scale], -1).astype(np.float32)
    dfm = np.stack([dfm * f for f in scale], -1).astype(np.float32)
    xy = np.zeros((s, side * side, 2), np.float32)
    for i in range(s):
        cx, cy = 20 + 13 * i, 25 + 9 * i
        gx, gy = np.meshgrid(
            np.arange(cx - side // 2, cx + side // 2 + 1),
            np.arange(cy - side // 2, cy + side // 2 + 1),
            indexing="ij",
        )
        xy[i] = np.stack([gx.ravel(), gy.ravel()], -1)
    mask = np.ones((s, side * side), bool)
    mask[-1, -7:] = False  # one ragged subset
    center = xy.mean(axis=1).astype(np.float32)
    und_w = und[xy[..., 1].astype(int), xy[..., 0].astype(int), :]
    rng = np.random.default_rng(seed)
    num_p = _NP[int(model)]
    params = rng.normal(0, 0.01, (s, num_p)).astype(np.float32)
    params[:, 0] += 0.7
    if num_p > 1:
        params[:, 1] -= 0.4
    return dfm, xy, mask, center, und_w.astype(np.float32), params


def _tiles(dfm, xy):
    h, w = dfm.shape[0], dfm.shape[1]
    ext = int(np.ceil((xy.max(axis=1) - xy.min(axis=1)).max()))
    return tv2.choose_tile(ext, ext, -(-h // 8) * 8, -(-w // 8) * 8)


def _jax(model, interp, dfm, xy, mask, center, und_w, params):
    h, w = dfm.shape[0], dfm.shape[1]
    th, tw = _tiles(dfm, xy)
    pix = jv2.pack_pixdata(
        jnp.asarray(xy), jnp.asarray(mask), jnp.asarray(und_w),
        jnp.asarray(center),
    )
    bbox = jv2.subset_bbox(jnp.asarray(xy), jnp.asarray(mask))
    out = jv2.fused_assemble(
        JModel(int(model)), JInterp(int(interp)), th, tw, h, w,
        jnp.asarray(dfm), pix, jnp.asarray(center), jnp.asarray(params),
        bbox, 2, True,  # block, interpret: the non-DMA (tile) path
    )
    return np.asarray(out.flat).reshape(-1, 8, 8)


def _port(model, interp, dfm, xy, mask, center, und_w, params, idx=None):
    h, w = dfm.shape[0], dfm.shape[1]
    th, tw = _tiles(dfm, xy)
    xy_t, mask_t = torch.as_tensor(xy), torch.as_tensor(mask)
    center_t = torch.as_tensor(center)
    pix = tv2.pack_pixels(xy_t, mask_t, torch.as_tensor(und_w), center_t)
    bbox = tv2.subset_bbox(xy_t, mask_t)
    img = tv2.prepare_image(torch.as_tensor(dfm), th, tw)
    return tv2.fused_assemble(
        model, interp, th, tw, h, w, img, pix, center_t,
        torch.as_tensor(params), bbox, idx,
    ).numpy()


def _assert_gram_close(got, ref, num_p):
    """The tolerances of tests/test_assemble_v2.py: float32 summation-order
    noise between two reductions of the same products.  Err counts must be
    identical."""
    a, a0 = got[:, :num_p, :num_p], ref[:, :num_p, :num_p]
    b, b0 = got[:, :num_p, num_p], ref[:, :num_p, num_p]
    np.testing.assert_allclose(a, a0, rtol=2e-4, atol=np.abs(a0).max() * 5e-6)
    np.testing.assert_allclose(b, b0, rtol=2e-4, atol=np.abs(b0).max() * 2e-5)
    np.testing.assert_allclose(
        got[:, num_p, num_p], ref[:, num_p, num_p], rtol=2e-5
    )
    np.testing.assert_array_equal(
        got[:, num_p + 1, num_p + 1], ref[:, num_p + 1, num_p + 1]
    )


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("model,interp", GRID)
def test_reference_matches_jax_kernel(model, interp, channels):
    args = _problem(model, channels=channels)
    got = _port(model, interp, *args)
    ref = _jax(model, interp, *args)
    num_p = _NP[int(model)]
    _assert_gram_close(got, ref, num_p)
    # The whole 8x8 block (cross terms with V and bad, zero rows) too:
    # same summation-order tolerance against the block's largest entry.
    np.testing.assert_allclose(
        got, ref, rtol=2e-4, atol=np.abs(ref).max() * 5e-6
    )


def test_out_of_image_flagged():
    model, interp = FittingModel.UV, Interpolation.BICUBIC
    dfm, xy, mask, center, und_w, _ = _problem(model, s=3)
    params = np.array([[0.0, 0.0], [400.0, 0.0], [0.0, -60.0]], np.float32)
    got = _port(model, interp, dfm, xy, mask, center, und_w, params)
    ref = _jax(model, interp, dfm, xy, mask, center, und_w, params)
    err = got[:, 3, 3]
    assert err[0] == 0 and err[1] > 0 and err[2] > 0
    np.testing.assert_array_equal(err, ref[:, 3, 3])


def test_nonfinite_params_poison_only_their_subset():
    model, interp = FittingModel.AFFINE, Interpolation.BICUBIC
    dfm, xy, mask, center, und_w, params = _problem(model, s=3)
    params[1, 2] = np.nan
    got = _port(model, interp, dfm, xy, mask, center, und_w, params)
    ref = _jax(model, interp, dfm, xy, mask, center, und_w, params)
    assert np.isfinite(got[[0, 2]]).all()
    assert not np.isfinite(got[1, :6, :6]).any()
    assert got[1, 7, 7] == ref[1, 7, 7] == 121  # every pixel is bad
    _assert_gram_close(got[[0, 2]], ref[[0, 2]], 6)


def test_index_list_selects_subsets():
    model, interp = FittingModel.AFFINE, Interpolation.BICUBIC
    args = _problem(model, s=6)
    full = _port(model, interp, *args)
    idx = torch.tensor([4, 1, 1], dtype=torch.int32)
    part = _port(model, interp, *args, idx=idx)
    np.testing.assert_array_equal(part, full[[4, 1, 1]])


def test_tile_bound_flags_large_warp():
    """A warp that outgrows the tile margin flags the subset even inside
    the image (the Pallas tile contract, in_tile)."""
    model, interp = FittingModel.AFFINE, Interpolation.BICUBIC
    dfm, xy, mask, center, und_w, params = _problem(model, s=2)
    params[1, 2] = 1.2  # ux: the subset grows to ~2.2x its width
    got = _port(model, interp, dfm, xy, mask, center, und_w, params)
    ref = _jax(model, interp, dfm, xy, mask, center, und_w, params)
    assert got[0, 7, 7] == 0 and got[1, 7, 7] > 0
    np.testing.assert_array_equal(got[:, 7, 7], ref[:, 7, 7])


def test_wrapper_validates_inputs():
    model, interp = FittingModel.UV, Interpolation.BICUBIC
    dfm, xy, mask, center, und_w, params = _problem(model, s=2)
    with pytest.raises(TypeError):
        _port(model, interp, dfm, xy, mask, center, und_w,
              params.astype(np.float64))
    with pytest.raises(TypeError):
        _port(model, interp, dfm, xy, mask, center, und_w, params,
              idx=torch.tensor([0, 1]))  # int64
    with pytest.raises(ValueError):
        _port(model, interp, dfm, xy, mask, center, und_w, params[:, :1])
    with pytest.raises(IndexError):
        _port(model, interp, dfm, xy, mask, center, und_w, params,
              idx=torch.tensor([0, 2], dtype=torch.int32))
    # CPU tensors never reach the kernel.
    before = tv2.LAUNCHES
    _port(model, interp, dfm, xy, mask, center, und_w, params)
    assert tv2.LAUNCHES == before
