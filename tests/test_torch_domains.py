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


def test_drifting_sequence_moves_one_row_a_frame():
    """Frame t of the drifting sequence is frame 0 moved down by t rows;
    speckle keeps bench's texture up to max_shift 4."""
    from correlation_tpu_torch.problems import (
        drifting_sequence,
        sequence_problem,
        speckle,
    )

    frames = drifting_sequence(9, img_hw=64, seed=3)
    assert frames.shape == (10, 64, 64, 1) and frames.dtype == np.uint8
    for t in range(10):
        np.testing.assert_array_equal(frames[t, t:, :, 0],
                                      frames[0, : 64 - t, :, 0])
    np.testing.assert_array_equal(speckle(64, 64, 3, 2),
                                  speckle(64, 64, 3, 2, max_shift=2))
    with pytest.raises(ValueError):
        speckle(64, 64, 3, 5)
    _, frames, pts, centers = sequence_problem(64, 8, img_hw=128)
    # Every subset keeps clear of the bicubic border after 8 rows of drift.
    assert max(p[:, 1].max() for p in pts) + 8 < 128 - 2
    np.testing.assert_array_equal(centers, [p.mean(axis=0) for p in pts])


# ---- annular and blob domains, multi-ROI batches ---------------------------

import dataclasses  # noqa: E402
import math  # noqa: E402

from correlation_tpu import native as jnative  # noqa: E402
from correlation_tpu import polygon as jpoly  # noqa: E402
from correlation_tpu.config import DomainType  # noqa: E402
from correlation_tpu.engine import CorrelationResult as JResult  # noqa: E402
from correlation_tpu_torch import polygon as tpoly  # noqa: E402
from correlation_tpu_torch.engine import CorrelationResult  # noqa: E402
from correlation_tpu_torch.interop import domain_from_dict  # noqa: E402

CONTOURS = {
    "convex": [[5, 5], [25, 6], [28, 20], [15, 28], [4, 18]],
    "concave": [[4.3, 3.1], [30.2, 4.0], [29.5, 14.7], [15.2, 15.1],
                [14.6, 33.3], [3.9, 32.8]],
    "bowtie": [[0, 0], [20, 20], [20, 0], [0, 20]],
}
# (r, dr, a, da, cx, cy, as_): a wedge, a whole ring (as_ = 1), and two
# sectors across theta = 0 (from below and from just under 2 pi).
SECTORS = [
    (10.0, 10.0, 0.3, math.pi / 3, 50.0, 50.0, 6),
    (8.0, 9.5, 0.0, 2 * math.pi, 40.5, 41.0, 1),
    (12.0, 7.0, -0.4, 0.8, 45.0, 44.0, 8),
    (12.0, 7.0, 2 * math.pi - 0.3, 0.6, 45.0, 44.0, 8),
]


@pytest.fixture
def no_native(monkeypatch):
    """The JAX package on its NumPy generators, the port's only ones."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_load_attempted", True)


def _contour(name):
    return np.array(CONTOURS[name], np.float32)


def _points_lists(batch):
    return [xy[m] for xy, m in zip(batch.xy[0], batch.mask[0])]


@pytest.mark.parametrize("gpu", [False, True])
@pytest.mark.parametrize("sector", range(len(SECTORS)))
def test_annular_sector_points_match_jax(no_native, sector, gpu):
    got = tdom.annular_sector_points(*SECTORS[sector], gpu_semantics=gpu)
    ref = jdom.annular_sector_points(*SECTORS[sector], gpu_semantics=gpu)
    assert len(got) > 20
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("gpu", [False, True])
def test_annular_batch_matches_jax(no_native, gpu):
    args = (60.0, 55.0, 8.0, 30.0, 2, 6)
    got = tdom.annular_batch(tdom.AnnularDomain(*args), 2, base_angle=0.2,
                             gpu_semantics=gpu)
    ref = jdom.annular_batch(jdom.AnnularDomain(*args), 2, base_angle=0.2,
                             gpu_semantics=gpu)
    assert got.num_subsets == 12
    _assert_same_batch(got, ref)


@pytest.mark.parametrize("args", [(60.0, 55.0, 8.0, 30.0, 2, 6),
                                  (40.0, 41.5, 5.0, 20.0, 3, 1)])
def test_annular_sector_centers_match_jax(args):
    np.testing.assert_array_equal(
        tdom.annular_sector_centers(tdom.AnnularDomain(*args)),
        jdom.annular_sector_centers(jdom.AnnularDomain(*args)))


@pytest.mark.parametrize("name", sorted(CONTOURS))
def test_polygon_matches_jax(name):
    got, ref = tpoly.Polygon(_contour(name)), jpoly.Polygon(_contour(name))
    assert got.error == ref.error == (name == "bowtie")
    assert got.triangles == ref.triangles
    pts = got.inside_points()
    np.testing.assert_array_equal(pts, ref.inside_points())
    assert len(pts) > 100 or got.error


@pytest.mark.parametrize("triangulate", [True, False])
@pytest.mark.parametrize("name", ["convex", "concave"])
def test_blob_batch_matches_jax(no_native, name, triangulate):
    got = tdom.blob_batch(tdom.BlobDomain(_contour(name)), 2,
                          use_triangulation=triangulate)
    ref = jdom.blob_batch(jdom.BlobDomain(_contour(name)), 2,
                          use_triangulation=triangulate)
    _assert_same_batch(got, ref)
    dom = tdom.BlobDomain(_contour(name))
    assert (dom.x_center, dom.y_center) == \
        (jdom.BlobDomain(_contour(name)).x_center,
         jdom.BlobDomain(_contour(name)).y_center)


def test_blob_batch_rejects_bad_domains_as_jax():
    for mod in (tdom, jdom):
        with pytest.raises(ValueError, match="self-intersecting"):
            mod.blob_batch(mod.BlobDomain(_contour("bowtie")), 1)
        tiny = np.array([[3.2, 3.2], [3.7, 3.3], [3.5, 3.8]], np.float32)
        with pytest.raises(ValueError, match="no pixels"):
            mod.blob_batch(mod.BlobDomain(tiny), 1)
        with pytest.raises(ValueError, match="no pixels"):
            mod.blob_batch(mod.BlobDomain(tiny), 1, use_triangulation=False)


def test_rectangular_contour_matches_jax():
    for args in ((10, 12, 4, 3), (7.5, 9.0, 2, 6)):
        np.testing.assert_array_equal(tdom.rectangular_contour(*args),
                                      jdom.rectangular_contour(*args))


def _three_domains(mod):
    rect = mod.rectangular_batch(mod.RectangularDomain(24, 24, 72, 72, 2, 2),
                                 2)
    ann = mod.annular_batch(mod.AnnularDomain(110, 60, 10, 28, 1, 4), 2)
    blob = mod.blob_batch(mod.BlobDomain(_contour("concave") * 1.5 + 30.0),
                          2)
    return [rect, ann, blob]


def test_combine_batches_matches_jax(no_native):
    got, counts = tdom.combine_batches(_three_domains(tdom))
    ref, ref_counts = jdom.combine_batches(_three_domains(jdom))
    assert counts == ref_counts == [4, 4, 1]
    _assert_same_batch(got, ref)
    with pytest.raises(ValueError):
        tdom.combine_batches([])
    with pytest.raises(ValueError):
        tdom.combine_batches([_three_domains(tdom)[0],
                              tdom.make_batch(_ragged_lists(2, 0), None, 1)])


def test_split_result_matches_jax():
    rng = np.random.default_rng(4)
    s = 9
    fields = dict(
        params=rng.normal(size=(s, 2)).astype(np.float32),
        chi=rng.random(s).astype(np.float32),
        iterations=rng.integers(0, 9, s).astype(np.int32),
        error=rng.integers(0, 4, s).astype(np.int32),
        center=rng.normal(size=(s, 2)).astype(np.float32),
        n_points=rng.integers(1, 99, s).astype(np.int32),
    )
    counts = [4, 4, 1]
    got = tdom.split_result(
        CorrelationResult(**{k: torch.as_tensor(v)
                             for k, v in fields.items()}), counts)
    ref = jdom.split_result(JResult(**fields), counts)
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        assert isinstance(a, CorrelationResult)
        for k in fields:
            np.testing.assert_array_equal(getattr(a, k).numpy(),
                                          getattr(b, k))


@pytest.mark.parametrize("kind", list(DomainType), ids=lambda k: k.name)
def test_domain_from_dict_gives_the_same_points(no_native, kind):
    jdoms = {
        DomainType.RECTANGULAR: jdom.RectangularDomain(10, 20, 60.5, 71, 2, 3),
        DomainType.ANNULAR: jdom.AnnularDomain(50, 52, 6, 24, 2, 4),
        DomainType.BLOB: jdom.BlobDomain(_contour("concave")),
    }
    jd = jdoms[kind]
    td = domain_from_dict(int(kind), dataclasses.asdict(jd))
    build = {
        DomainType.RECTANGULAR: "rectangular_batch",
        DomainType.ANNULAR: "annular_batch",
        DomainType.BLOB: "blob_batch",
    }[kind]
    _assert_same_batch(getattr(tdom, build)(td, 2),
                       getattr(jdom, build)(jd, 2))


def test_full_size_annulus_matches_jax(no_native):
    """annular_problem's 8 x 64 sectors (r 120-400 around (512, 480)), the
    port against the JAX package, in both semantics."""
    args = (512.0, 480.0, 120.0, 400.0, 8, 64)
    for gpu in (False, True):
        _assert_same_batch(
            tdom.annular_batch(tdom.AnnularDomain(*args), 2,
                               gpu_semantics=gpu),
            jdom.annular_batch(jdom.AnnularDomain(*args), 2,
                               gpu_semantics=gpu))


@pytest.mark.parametrize("scale", [1.0, 4.0])
@pytest.mark.parametrize("name", ["convex", "concave"])
def test_crossing_matches_jax_every_call(no_native, name, scale):
    """The crossing rasterizer gives the JAX package's points in its
    raster order (y-major, then x), the same on every call."""
    contour = _contour(name) * scale
    calls = [tdom.blob_inside_points_crossing(contour) for _ in range(3)]
    for pts in calls[1:]:
        np.testing.assert_array_equal(pts, calls[0])
    np.testing.assert_array_equal(
        calls[0], jdom.blob_inside_points_crossing(contour))
    assert len(calls[0]) > 300
    order = np.lexsort((calls[0][:, 0], calls[0][:, 1]))
    np.testing.assert_array_equal(order, np.arange(len(order)))
