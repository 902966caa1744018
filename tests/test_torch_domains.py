"""The port's host-side geometry against correlation_tpu/domains.py, and its
integer sampler and dense-grid problem against the JAX package's.

All of it is exact integer / float32 bookkeeping: arrays must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from correlation_tpu import domains as jdom
from correlation_tpu.ops.interp import sample_integer as jax_sample_integer
from correlation_tpu_torch import domains as tdom
from correlation_tpu_torch.ops.interp import sample_integer
from correlation_tpu_torch.problems import dense_grid_problem

torch.set_num_threads(2)


def _assert_same_batch(got, ref):
    assert len(got.xy) == len(ref.xy)
    for a, b in zip(got.xy, ref.xy):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(got.mask, ref.mask):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(got.center0, np.asarray(ref.center0))
    assert got.extents == ref.extents


def _ragged_lists(s, seed):
    rng = np.random.default_rng(seed)
    lists = []
    for i in range(s):
        cx, cy = rng.integers(12, 80, 2)
        hx, hy = rng.integers(2, 9, 2)
        pts = tdom.rectangular_points(int(cx), int(cy), int(hx), int(hy))
        keep = rng.random(len(pts)) > 0.2  # ragged: drop some points
        lists.append(pts[keep] + rng.integers(0, 2) * 0.5)
    return lists


@pytest.mark.parametrize("s", [7, 64, 90])
def test_make_batch_matches_jax(s):
    """S <= 64 goes through JAX's native decimation, S > 64 through its
    NumPy compaction; the port always uses the latter."""
    lists = _ragged_lists(s, seed=s)
    for centers in (None, np.random.default_rng(1).uniform(10, 80, (s, 2))):
        got = tdom.make_batch(lists, centers, 2, pad_to=[0, 40, 16])
        ref = jdom.make_batch(lists, centers, 2, pad_to=[0, 40, 16])
        _assert_same_batch(got, ref)


def test_rectangular_batch_matches_jax():
    dom = tdom.RectangularDomain(10.0, 20.0, 110.5, 121.0, 3, 2)
    jd = jdom.RectangularDomain(10.0, 20.0, 110.5, 121.0, 3, 2)
    c1, x1, y1 = tdom.rectangular_sectors(dom)
    c2, x2, y2 = jdom.rectangular_sectors(jd)
    np.testing.assert_array_equal(c1, c2)
    assert (x1, y1) == (x2, y2)
    _assert_same_batch(tdom.rectangular_batch(dom, 2),
                       jdom.rectangular_batch(jd, 2))
    assert (dom.x_center, dom.y_center) == (jd.x_center, jd.y_center)


def test_to_device_gives_tensors():
    batch = tdom.make_batch(_ragged_lists(3, seed=0), None, 1)
    dev = batch.to_device("cpu")
    assert dev.xy[1].dtype == torch.float32 and dev.mask[1].dtype == torch.bool
    np.testing.assert_array_equal(dev.xy[1].numpy(), batch.xy[1])
    assert dev.num_subsets == 3 and dev.extents == batch.extents


def test_sample_integer_matches_jax():
    rng = np.random.default_rng(2)
    img = np.floor(rng.uniform(0, 255, (23, 31, 3))).astype(np.float32)
    xy = rng.uniform(-3, 35, (4, 9, 2)).astype(np.float32)
    xy[0, 0] = (10.5, 7.5)  # exact halves round up: int(x + 0.5)
    np.testing.assert_array_equal(
        sample_integer(torch.as_tensor(img), torch.as_tensor(xy)).numpy(),
        np.asarray(jax_sample_integer(jnp.asarray(img), jnp.asarray(xy))),
    )


def test_dense_grid_problem_matches_bench():
    cfg, und, dfm, batch, params0 = dense_grid_problem(100, img_hw=160)
    jcfg, _, _, jbatch, jparams0, (jund, jdfm) = bench.build_problem(
        100, img_hw=160
    )
    np.testing.assert_array_equal(und, jund)
    np.testing.assert_array_equal(dfm, jdfm)
    _assert_same_batch(batch, jbatch)
    np.testing.assert_array_equal(params0, np.asarray(jparams0))
    assert (cfg.model, cfg.interpolation) == (jcfg.model, jcfg.interpolation)
    assert cfg.pyramid.levels_coarse_to_fine() == \
        jcfg.pyramid.levels_coarse_to_fine()
    # bench.main runs at the reference's stopping rule
    assert (cfg.max_iterations, cfg.precision) == (50, 1e-3)
