"""The port's pyramid against correlation_tpu/ops/pyramid.py.

The port sums each 5x5 window exactly (float64, exact for uint8-valued
inputs) and floors; JAX sums in float32 in the order of its convolution.
They agree everywhere except where the exact window sum lies within float32
rounding of an integer: there JAX's floor may land one count lower or
higher.  The test requires exact equality on every other pixel, and at
those boundary pixels a difference of at most one count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from correlation_tpu.ops.pyramid import build_pyramid as jax_pyramid
from correlation_tpu_torch.ops.pyramid import BINOMIAL_1D, build_pyramid
from synthetic import Speckle

torch.set_num_threads(2)

_K = np.outer(BINOMIAL_1D, BINOMIAL_1D).astype(np.float32).astype(np.float64)


def _exact_window_sums(src):
    """Exact float64 window sums of one downsample step (interior)."""
    th, tw = src.shape[0] // 2, src.shape[1] // 2
    acc = np.zeros((th - 2, tw - 2))
    for dj in range(5):
        for di in range(5):
            acc += src[dj : dj + 2 * (th - 2) : 2,
                       di : di + 2 * (tw - 2) : 2] * _K[dj, di]
    return acc


@pytest.mark.parametrize("h,w,seed", [(96, 96, 42), (37, 42, 5), (61, 75, 3),
                                      (131, 97, 8)])
def test_pyramid_matches_jax(h, w, seed):
    img = Speckle(h, w, seed=seed).image(quantize=True)
    ref = jax_pyramid(jnp.asarray(img[..., None]), 2)
    got = build_pyramid(torch.as_tensor(img[..., None]), 2)
    assert [tuple(a.shape) for a in got] == [tuple(a.shape) for a in ref]
    for lvl in (1, 2):
        r = np.asarray(ref[lvl])[..., 0]
        g = got[lvl].numpy()[..., 0]
        prev = got[lvl - 1].numpy()[..., 0].astype(np.float64)
        exact = _exact_window_sums(prev)
        # float32 rounding of a sum of 25 terms below 2^9: < 25 ulp(256)
        near = np.zeros_like(g, bool)
        near[1:-1, 1:-1] = np.abs(exact - np.round(exact)) < 25 * 2.0**-15
        assert np.array_equal(g[~near], r[~near]), lvl
        assert np.abs(g - r).max() <= 1.0
        # the border is zero and the interior is the floored exact sum
        assert not g[0].any() and not g[-1].any()
        assert not g[:, 0].any() and not g[:, -1].any()
        np.testing.assert_array_equal(g[1:-1, 1:-1], np.floor(exact))


def test_pyramid_exact_on_flat_and_batched():
    """Flat regions (where float32 sums of the weights straddle 1.0) and a
    batch of frames give the floored exact sums, frame by frame."""
    img = np.full((40, 52), 128.0, np.float32)
    img[10:30, 5:20] = 7.0
    img[:, 40:] = 255.0
    got = build_pyramid(torch.as_tensor(img[..., None]), 1)[1].numpy()[..., 0]
    ref = jax_pyramid(jnp.asarray(img[..., None]), 1)[1]
    np.testing.assert_array_equal(got, np.asarray(ref)[..., 0])
    np.testing.assert_array_equal(
        got[1:-1, 1:-1], np.floor(_exact_window_sums(img.astype(np.float64)))
    )
    stack = torch.stack([torch.as_tensor(img), torch.as_tensor(img[::-1].copy())])
    batched = build_pyramid(stack[..., None], 2)
    for i in range(2):
        single = build_pyramid(stack[i, ..., None], 2)
        for a, b in zip(batched, single):
            assert torch.equal(a[i], b)
