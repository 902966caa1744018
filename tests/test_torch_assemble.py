"""The port's fused assembly against the JAX Pallas kernel.

correlation_tpu_torch.ops.assemble_v2.fused_assemble_reference (the plain
PyTorch version of the CUDA kernel) is held against
correlation_tpu.ops.assemble_v2.fused_assemble run with interpret=True,
which takes the kernel's non-DMA path: the tile contract the port follows.
The CUDA kernel itself is compared with the plain version on the card by
tests_gpu/ and chip_smoke.py.  The plain version sums the Gram in the
order of the kernel's path for the subset size (subset_threads, and
subset_chunks for the split path); each path's order is held to a
float64 sum within float32's error bound.
"""

import math
import re
from pathlib import Path

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


def _problem(model, s=5, side=11, channels=1, seed=4, p_len=None):
    """s subsets of side x side pixels (side odd), the last ragged, padded
    with masked points at each subset's first pixel to p_len points."""
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
    if p_len is not None:
        pad = p_len - side * side
        xy = np.concatenate([xy, np.repeat(xy[:, :1], pad, axis=1)], axis=1)
        mask = np.concatenate([mask, np.zeros((s, pad), bool)], axis=1)
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


@pytest.mark.parametrize("side,p_len", [(5, 40), (21, 448), (47, 2304)])
@pytest.mark.parametrize("model,interp", GRID[:2])
def test_reference_matches_jax_on_both_paths(model, interp, side, p_len):
    """Subsets of 40 padded pixels (the warp path, as pyramid level 2),
    448 (the block path, as level 0) and 2304 (the split path: 5 spans,
    the last of 256 pixels, its tail masked padding)."""
    warp = p_len <= tv2.WARP_MAX_PIXELS
    assert tv2.subset_threads(p_len) == (
        tv2.WARP_LANES if warp else tv2.BLOCK_THREADS)
    assert (tv2.subset_chunks(p_len) > 1) == (p_len > tv2.CHUNK_MIN_PIXELS)
    args = _problem(model, s=3, side=side, p_len=p_len)
    got = _port(model, interp, *args)
    ref = _jax(model, interp, *args)
    _assert_gram_close(got, ref, _NP[int(model)])
    np.testing.assert_allclose(
        got, ref, rtol=2e-4, atol=np.abs(ref).max() * 5e-6
    )


@pytest.mark.parametrize("threads", [16, 32, 64, 128])
@pytest.mark.parametrize("p_len", [40, 448, 2049, 2304])
def test_kernel_order_sum_within_float32_bound(p_len, threads):
    """Each order against the float64 sum: within gamma_d * sum |terms|,
    d the additions a term goes through (its thread's chain over its
    span, the lane butterfly, the warps in order, then the spans in
    order), gamma_d = d u / (1 - d u).  Above CHUNK_MIN_PIXELS the rule
    splits: 2049 leaves a last span of one pixel, 2304 one of 256."""
    rng = np.random.default_rng(p_len + threads)
    channels = 2
    prod = rng.normal(size=(4, 36, p_len, channels)) * rng.lognormal(
        0, 2, size=(4, 36, 1, 1))
    prod = torch.as_tensor(prod.astype(np.float32))
    chunk = tv2.subset_span(p_len)
    spans = tv2.subset_chunks(p_len)
    assert spans == -(-p_len // chunk)
    got = tv2.kernel_order_sum(prod, threads, chunk).double()
    exact = prod.double().sum(dim=(2, 3))
    terms = prod.double().abs().sum(dim=(2, 3))
    group = min(threads, 32)
    depth = (-(-chunk // threads) * channels + int(math.log2(group))
             + threads // group - 1 + spans - 1)
    u = 2.0 ** -24
    gamma = depth * u / (1 - depth * u)
    assert ((got - exact).abs() <= gamma * terms).all()
    assert not torch.equal(got, exact)  # float32 rounding did happen


def test_subset_threads_rule_matches_the_kernel_source():
    """The plain version's order follows the path the kernel takes: the
    rule's constants are the .cu file's, and the split rule reads the
    padded length alone."""
    src = (Path(tv2.__file__).parent.parent / "csrc"
           / "fused_assemble.cu").read_text()
    kernel = {k: int(re.search(rf"constexpr int k{k} = (\d+);", src).group(1))
              for k in ("BlockThreads", "WarpLanes", "ChunkMin",
                        "ChunkPixels")}
    assert tv2.BLOCK_THREADS == kernel["BlockThreads"]
    assert tv2.WARP_LANES == kernel["WarpLanes"]
    assert tv2.CHUNK_MIN_PIXELS == kernel["ChunkMin"]
    assert tv2.CHUNK_PIXELS == kernel["ChunkPixels"]
    assert tv2.subset_threads(1) == tv2.WARP_LANES
    assert tv2.subset_threads(tv2.WARP_MAX_PIXELS) == tv2.WARP_LANES
    assert tv2.subset_threads(tv2.WARP_MAX_PIXELS + 1) == tv2.BLOCK_THREADS
    # Every shape of the dense grid (448 / 128 / 40 padded pixels) and of
    # the annulus (1328 / 336 / 88) stays whole.
    assert tv2.CHUNK_MIN_PIXELS >= 2048
    assert tv2.CHUNK_PIXELS % tv2.BLOCK_THREADS == 0
    for p_len in (1, 40, 88, 128, 336, 448, 1328, tv2.CHUNK_MIN_PIXELS):
        assert tv2.subset_chunks(p_len) == 1
        assert tv2.subset_span(p_len) == p_len
    for p_len in (tv2.CHUNK_MIN_PIXELS + 1, 4456, 17816, 71264):
        assert tv2.subset_chunks(p_len) == -(-p_len // tv2.CHUNK_PIXELS)
        assert tv2.subset_span(p_len) == tv2.CHUNK_PIXELS
    assert tv2.subset_span(4456, 10000) == 4456
    with pytest.raises(ValueError):
        tv2.subset_span(4456, 0)


@pytest.mark.parametrize("p_len", [40, 448, 1328, 2048])
def test_split_order_keeps_the_whole_order_up_to_the_threshold(p_len):
    """Up to CHUNK_MIN_PIXELS the rule's order is the one-block order,
    bit for bit, on every path's thread count."""
    rng = np.random.default_rng(p_len)
    prod = torch.as_tensor(rng.normal(size=(3, 36, p_len, 2)).astype(
        np.float32))
    threads = tv2.subset_threads(p_len)
    assert torch.equal(
        tv2.kernel_order_sum(prod, threads, tv2.subset_span(p_len)),
        tv2.kernel_order_sum(prod, threads))
    assert torch.equal(tv2.kernel_order_sum(prod, threads, p_len + 64),
                       tv2.kernel_order_sum(prod, threads))


def test_split_order_adds_spans_in_order():
    """Above the threshold the order is each span's own block order, then
    the spans left to right; it differs from the one-block order."""
    rng = np.random.default_rng(3)
    p_len, threads = 2304, tv2.BLOCK_THREADS
    prod = torch.as_tensor(rng.normal(size=(2, 36, p_len, 1)).astype(
        np.float32))
    chunk = tv2.subset_span(p_len)
    spans = [tv2.kernel_order_sum(prod[:, :, i:i + chunk], threads)
             for i in range(0, p_len, chunk)]
    total = spans[0]
    for part in spans[1:]:
        total = total + part
    got = tv2.kernel_order_sum(prod, threads, chunk)
    assert torch.equal(got, total)
    assert not torch.equal(got, tv2.kernel_order_sum(prod, threads))


def test_plain_version_takes_the_order_of_any_path():
    """threads= picks the order; the default is the rule's path; chunk=
    at p_len or more changes nothing below the split threshold."""
    model, interp = FittingModel.AFFINE, Interpolation.BICUBIC
    dfm, xy, mask, center, und_w, params = _problem(model, s=3)
    th, tw = _tiles(dfm, xy)
    xy_t, mask_t = torch.as_tensor(xy), torch.as_tensor(mask)
    center_t = torch.as_tensor(center)
    args = (model, interp, th, tw, dfm.shape[0], dfm.shape[1],
            tv2.prepare_image(torch.as_tensor(dfm), th, tw),
            tv2.pack_pixels(xy_t, mask_t, torch.as_tensor(und_w), center_t),
            center_t, torch.as_tensor(params), tv2.subset_bbox(xy_t, mask_t))
    rule = tv2.subset_threads(xy.shape[1])
    default = tv2.fused_assemble_reference(*args)
    assert torch.equal(default,
                       tv2.fused_assemble_reference(*args, threads=rule))
    assert torch.equal(default, tv2.fused_assemble_reference(
        *args, chunk=xy.shape[1]))
    orders = {t: tv2.fused_assemble_reference(*args, threads=t)
              for t in (16, 32, 64, 128)}
    assert any(not torch.equal(orders[16], o) for o in orders.values())
    for o in orders.values():
        _assert_gram_close(o.numpy(), default.numpy(), 6)


def test_reset_launches():
    tv2.LAUNCHES += 3
    tv2.LAUNCHES_BY_SHAPE[(448, 32, 32)] = [2, 8000]
    tv2.reset_launches()
    assert tv2.LAUNCHES == 0 and tv2.LAUNCHES_BY_SHAPE == {}


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
    shapes = dict(tv2.LAUNCHES_BY_SHAPE)
    _port(model, interp, dfm, xy, mask, center, und_w, params)
    assert tv2.LAUNCHES == before
    assert tv2.LAUNCHES_BY_SHAPE == shapes
