"""The port's coefficient field (ops/interp.py) against the JAX package's.

precompute_field must equal JAX's bit for bit: every filter weight is a
multiple of 1/4, so for integer pixels every product and partial sum is
exact in float32 whatever the order (the port sums shifted slices, JAX
convolves).  sample_field evaluates the polynomial in a fixed order where
JAX contracts with einsum.  Nearest and bilinear take the same few
operations in both and agree within 1e-5 (1 + |w|); the bicubic sum of 16
terms y^j x^i c_ji cancels heavily (terms reach 1e6 where w is ~255), so
there the two are held to the float32 rounding of that sum,
2 * 16 * 2^-24 * sum_k |c_k t_k| (both sides round; either is as far from
the float64 value as from the other).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from correlation_tpu.config import Interpolation as JInterp
from correlation_tpu.ops import interp as jinterp
from correlation_tpu_torch.config import Interpolation
from correlation_tpu_torch.ops import interp

INTERPS = list(Interpolation)


def _image(h, w, c, seed):
    rng = np.random.default_rng(seed)
    return np.floor(rng.uniform(0, 256, (h, w, c))).astype(np.float32)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("interp_", INTERPS, ids=lambda i: i.name)
def test_field_equals_jax_bit_for_bit(interp_, channels):
    img = _image(64, 70, channels, 3 + channels)
    ref = np.asarray(jinterp.precompute_field(jnp.asarray(img),
                                              JInterp(int(interp_))).field)
    got = interp.precompute_field(torch.from_numpy(img), interp_)
    np.testing.assert_array_equal(got.field.numpy(), ref)
    assert got.image_shape(interp_) == img.shape[:2]


def test_filters_and_constants_equal_jax():
    for i in INTERPS:
        j = JInterp(int(i))
        np.testing.assert_array_equal(
            interp._coeff_filters(i).astype(np.float32),
            jinterp._coeff_filters(j)[:, :, 0, :])
        assert interp.NUM_COEFFS[i] == jinterp.NUM_COEFFS[j]
        assert interp.WINDOW[i] == jinterp.WINDOW[j]
        assert interp.WINDOW_OFFSET[i] == jinterp.WINDOW_OFFSET[j]
    np.testing.assert_array_equal(interp._bicubic_inverse_matrix(),
                                  jinterp._bicubic_inverse_matrix())


def _points(h, w, rng):
    """Random positions over and beyond the image, plus points on each
    validity window's edges (0, 1, W - 2, W - 1 and the same in y) and just
    inside and outside them."""
    pts = [rng.uniform(-3.0, w + 2.0, (400, 1)),
           rng.uniform(-3.0, h + 2.0, (400, 1))]
    edges_x = np.array([0.0, 1.0, w - 2.0, w - 1.0])
    edges_y = np.array([0.0, 1.0, h - 2.0, h - 1.0])
    eps = np.array([-1e-3, 0.0, 1e-3])
    ex = (edges_x[:, None] + eps).ravel()
    ey = (edges_y[:, None] + eps).ravel()
    gx, gy = np.meshgrid(ex, ey, indexing="ij")
    mid_x = np.full(ey.shape, w / 2.0 + 0.3)
    mid_y = np.full(ex.shape, h / 2.0 - 0.2)
    xs = np.concatenate([pts[0][:, 0], gx.ravel(), ex, mid_x])
    ys = np.concatenate([pts[1][:, 0], gy.ravel(), mid_y, ey])
    return np.stack([xs, ys], -1).astype(np.float32)


@pytest.mark.parametrize("interp_", INTERPS, ids=lambda i: i.name)
def test_sample_field_matches_jax(interp_):
    h, w, c = 40, 52, 2
    img = _image(h, w, c, 11)
    rng = np.random.default_rng(12)
    xy = _points(h, w, rng)
    field = interp.precompute_field(torch.from_numpy(img), interp_)
    got = [t.numpy() for t in interp.sample_field(field, interp_,
                                                  torch.from_numpy(xy))]
    ref = [np.asarray(t) for t in jinterp.sample_field(
        jinterp.InterpField(jnp.asarray(field.field.numpy())),
        JInterp(int(interp_)), jnp.asarray(xy))]
    np.testing.assert_array_equal(got[3], ref[3])
    assert got[3].any() and not got[3].all()
    if interp_ == Interpolation.BICUBIC:
        # Scale of the 16-term sums: sum_k |c_k| |t_k| with |t_k| <= 2^j 2^i
        # bounding each term (the local coordinates lie in [1, 2)).
        ix = np.clip(np.floor(xy[:, 0]) - 1, 0, w - 4).astype(int)
        iy = np.clip(np.floor(xy[:, 1]) - 1, 0, h - 4).astype(int)
        cf = np.abs(field.field.numpy()[iy, ix])  # [N, C, 16]
        j, i = np.divmod(np.arange(16), 4)
        bound = [cf @ (2.0 ** j * 2.0 ** i),
                 cf @ (2.0 ** j * np.maximum(i, 1) * 2.0 ** i),
                 cf @ (np.maximum(j, 1) * 2.0 ** j * 2.0 ** i)]
        for k in range(3):
            tol = 2 * 16 * 2.0 ** -24 * bound[k]
            assert (np.abs(got[k] - ref[k]) <= tol).all()
    else:
        for k in range(3):
            assert (np.abs(got[k] - ref[k])
                    <= 1e-5 * (1 + np.abs(ref[k]))).all()
    for k in range(3):  # zero outside the validity window
        assert not got[k][~got[3]].any()


def test_sample_integer_equals_jax():
    img = _image(30, 40, 3, 5)
    rng = np.random.default_rng(6)
    xy = rng.uniform(-2, 42, (200, 2)).astype(np.float32)
    got = interp.sample_integer(torch.from_numpy(img), torch.from_numpy(xy))
    ref = jinterp.sample_integer(jnp.asarray(img), jnp.asarray(xy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
