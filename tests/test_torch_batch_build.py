"""The subset batch built from one flat array of the point lists
(domains.FlatPoints, domains.build_batch), held bit for bit to a frozen
copy of the NumPy arithmetic it replaced: per-subset padding, a stable
argsort a level and inf-masked [S, P, 2] extents.  Then the point means
that run_sequence takes from the same array, and run_sequence's path,
which builds its batch through it."""

import dataclasses
import functools
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from correlation_tpu_torch import domains  # noqa: E402
from correlation_tpu_torch import sequence as seq  # noqa: E402
from correlation_tpu_torch.problems import sequence_problem  # noqa: E402
from correlation_tpu_torch.sequence import (  # noqa: E402
    SequenceConfig,
    run_sequence,
)
from dicbench import spec  # noqa: E402

torch.set_num_threads(2)

CELLS = ("rect_grid_1mp.eulerian_first", "annulus_512.eulerian_first",
         "blob_e8_gauge.eulerian_first")


# -- the frozen NumPy arithmetic ------------------------------------------

def _frozen_pad(point_lists, pad_to=None):
    max_p = max(max((len(p) for p in point_lists), default=0), 1)
    if pad_to is not None:
        max_p = max(max_p, pad_to)
    max_p = -(-max_p // 8) * 8
    xy = np.zeros((len(point_lists), max_p, 2), np.float32)
    mask = np.zeros((len(point_lists), max_p), bool)
    for i, pts in enumerate(point_lists):
        if len(pts):
            xy[i, :len(pts)] = pts
            mask[i, :len(pts)] = True
    return xy, mask


def _frozen_decimate(xy0, mask0, max_level, pad_to=None):
    xs, ms = [xy0], [mask0]
    s = xy0.shape[0]
    ix = np.floor(xy0[..., 0] + 0.5).astype(np.int64)
    iy = np.floor(xy0[..., 1] + 0.5).astype(np.int64)
    for level in range(1, max_level + 1):
        mag = 1 << level
        keep = mask0 & (ix % mag == 0) & (iy % mag == 0)
        cnt = keep.sum(axis=1)
        max_p = max(int(cnt.max()) if s else 0, 1)
        if pad_to:
            max_p = max(max_p, pad_to[level])
        max_p = -(-max_p // 8) * 8
        order = np.argsort(~keep, axis=1, kind="stable")[:, :max_p]
        xy_l = np.take_along_axis(xy0, order[..., None], axis=1)
        mask_l = np.arange(max_p)[None, :] < cnt[:, None]
        xs.append(np.where(mask_l[..., None], xy_l / np.float32(mag),
                           0.0).astype(np.float32))
        ms.append(mask_l)
    return xs, ms


def _frozen_extents(xs, ms):
    out = []
    for xy, mask in zip(xs, ms):
        if mask.any():
            mins = np.where(mask[..., None], xy, np.inf).min(axis=1)
            maxs = np.where(mask[..., None], xy, -np.inf).max(axis=1)
            span = np.max(np.where(mask.any(axis=1)[:, None], maxs - mins,
                                   0.0), axis=0)
            out.append((int(np.ceil(span[1])), int(np.ceil(span[0]))))
        else:
            out.append((1, 1))
    return out


def frozen_make_batch(point_lists, centers, max_level, pad_to=None):
    xy0, mask0 = _frozen_pad(
        [np.asarray(p, np.float32).reshape(-1, 2) for p in point_lists],
        pad_to[0] if pad_to else None)
    if centers is None:
        n = np.maximum(mask0.sum(axis=1), 1)[:, None]
        centers = (xy0 * mask0[..., None]).sum(axis=1, dtype=np.float64) / n
    xs, ms = _frozen_decimate(xy0, mask0, max_level, pad_to)
    return domains.SubsetBatch(xs, ms, np.asarray(centers, np.float32),
                               extents=_frozen_extents(xs, ms))


# -- helpers ----------------------------------------------------------------

def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same_batch(got, want):
    """Equal shapes, dtypes and bits (so -0.0 against 0.0 differs)."""
    assert len(got.xy) == len(want.xy) == len(got.mask)
    for a, b in zip(got.xy + got.mask + [got.center0],
                    want.xy + want.mask + [want.center0]):
        a, b = np.asarray(a), np.asarray(b)
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert got.extents == want.extents


def cell_points(cell):
    config = spec.load_cell(cell).config
    return spec.load("domains", config["domain"]["kind"]).points(
        config["domain"], config["frame"])


def _lists(seed, s=12, half=False, negative=False):
    rng = np.random.default_rng(seed)
    lists = []
    for _ in range(s):
        c = rng.integers(-40 if negative else 10, 60, 2)
        h = rng.integers(1, 7, 2)
        pts = domains.rectangular_points(int(c[0]), int(c[1]), int(h[0]),
                                         int(h[1]))
        pts = pts[rng.random(len(pts)) > 0.25]
        lists.append(pts + (0.5 if half else 0.0))
    return lists


# Each case: (point lists, explicit centers or None, pad_to or None).
def _case(name):
    if name == "negative":
        return _lists(1, negative=True), None, None
    if name == "half_integer":
        return _lists(2, half=True, negative=True), None, [0, 40, 16]
    if name == "off_grid":  # neither whole nor half pixels
        rng = np.random.default_rng(3)
        return ([p + rng.uniform(-0.7, 0.7, p.shape).astype(np.float32)
                 for p in _lists(3, negative=True)],
                rng.uniform(-9, 9, (12, 2)), None)
    if name == "no_survivors":
        # Odd coordinates: nothing survives to level 1 or 2; (2, 6)
        # survives to level 1 only.
        odd = np.array([[1, 1], [3, 5], [-1, 7]], np.float32)
        return [odd, np.array([[2, 6], [5, 5]], np.float32), odd + 2], \
            None, None
    if name == "none_at_all":
        return [np.array([[1, 3]], np.float32)], None, None
    if name == "empty_list":
        lists = _lists(4)
        lists[3] = np.zeros((0, 2), np.float32)
        return lists, None, None
    if name == "empty_at_the_end":
        return _lists(5)[:4] + [np.zeros((0, 2), np.float32)], None, None
    if name == "no_points":
        return [np.zeros((0, 2), np.float32)] * 3, None, None
    if name == "no_subsets":
        return [], None, None
    if name == "pad_above":
        return _lists(6), np.full((12, 2), 30.0), [200, 64, 24]
    if name == "pad_below":
        return _lists(7), None, [8, 1, 0]
    raise KeyError(name)


CASES = ["negative", "half_integer", "off_grid", "no_survivors",
         "none_at_all", "empty_list", "empty_at_the_end", "no_points",
         "no_subsets", "pad_above", "pad_below"]


@pytest.mark.parametrize("case", CASES)
def test_make_batch_equals_the_frozen_arithmetic(case):
    lists, centers, pad_to = _case(case)
    with np.errstate(invalid="ignore"):
        want = frozen_make_batch(lists, centers, 2, pad_to)
    assert_same_batch(domains.make_batch(lists, centers, 2, pad_to), want)


@pytest.mark.parametrize("cell, explicit", [
    (CELLS[0], True), (CELLS[0], False), (CELLS[1], False),
    (CELLS[2], False)], ids=["grid", "grid-means", "annulus", "blob"])
def test_cell_domains_equal_the_frozen_arithmetic(cell, explicit):
    """The cells' own point lists: the grid with its explicit centers and
    with point means, the annulus and the blob (point means)."""
    pts, centers = cell_points(cell)
    centers = centers if explicit else None
    assert_same_batch(domains.make_batch(pts, centers, 2),
                      frozen_make_batch(pts, centers, 2))


@pytest.mark.parametrize("case", ["half_integer", "empty_list", "pad_below"])
def test_decimate_levels_equals_the_frozen_arithmetic(case):
    lists, _, pad_to = _case(case)
    xy0, mask0 = _frozen_pad(lists)
    got = domains.decimate_levels(xy0, mask0, [0, 1, 2], pad_to)
    want = _frozen_decimate(xy0, mask0, 2, pad_to)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_build_batch_is_torch_on_the_device():
    lists, centers, _ = _case("half_integer")
    batch = domains.build_batch(domains.FlatPoints(lists), centers, 2,
                                device="cpu")
    assert all(torch.is_tensor(a) for a in batch.xy + batch.mask)
    assert [a.dtype for a in batch.xy + batch.mask + [batch.center0]] == (
        [torch.float32] * 3 + [torch.bool] * 3 + [torch.float32])
    assert_same_batch(
        dataclasses.replace(batch, xy=[a.numpy() for a in batch.xy],
                            mask=[a.numpy() for a in batch.mask],
                            center0=batch.center0.numpy()),
        frozen_make_batch(lists, centers, 2))


@pytest.mark.parametrize("case", ["half_integer", "empty_list", "no_points"])
def test_flat_points_means_equal_numpy(case):
    """run_sequence's point means (global center, track state) equal
    each list's float64 np.mean: NaN for an empty list."""
    lists, _, _ = _case(case)
    flat = domains.FlatPoints(lists)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # empty lists
        want = np.array([p.mean(axis=0, dtype=np.float64) for p in lists])
    np.testing.assert_array_equal(flat.means(), want.reshape(-1, 2))
    assert flat.xy.dtype == np.float32
    np.testing.assert_array_equal(flat.counts, [len(p) for p in lists])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_means_equal_numpy(cell):
    pts, _ = cell_points(cell)
    want = np.array([np.asarray(p).mean(axis=0, dtype=np.float64)
                     for p in pts])
    np.testing.assert_array_equal(domains.FlatPoints(pts).means(), want)


def test_blob_centre_is_the_float64_mean():
    """The E8 blob's 140,672-px subset centres on the float64 mean of its
    points, rounded to float32."""
    (pts,), _ = cell_points("blob_e8_gauge.eulerian_first")
    want = np.asarray(pts, np.float64).mean(axis=0).astype(np.float32)
    batch = domains.build_batch(domains.FlatPoints([pts]), None, 2)
    np.testing.assert_array_equal(batch.center0[0].numpy(), want)


@pytest.mark.parametrize("explicit", [True, False], ids=["centers", "means"])
def test_run_sequence_flattens_once(monkeypatch, explicit):
    """run_sequence flattens its point lists once, takes their sums once
    (none with explicit centers) and no inf-masked extents; its records
    equal a run on the frozen NumPy batch."""
    cfg, frames, pts, centers = sequence_problem(16, 2, img_hw=128)
    centers = centers if explicit else None
    scfg = SequenceConfig(solver=dataclasses.replace(cfg, backend="torch"))

    def run():
        return run_sequence(list(frames), pts, scfg, centers=centers,
                            device="cpu")

    frozen = []

    def old_path(flat, c, stop, pad_to=None, device=None):
        lists = np.split(flat.xy, np.cumsum(flat.counts)[:-1])
        frozen.append(frozen_make_batch(lists, c, stop, pad_to))
        return frozen[-1].to_device(device)

    with monkeypatch.context() as m:
        m.setattr(seq, "build_batch", old_path)
        want = run()
    assert len(frozen) == 1

    def refuse(*args, **kwargs):
        raise AssertionError("an old path ran")

    made, summed = [], []

    class Counted(domains.FlatPoints):
        def __init__(self, *args, **kwargs):
            made.append(1)
            super().__init__(*args, **kwargs)

        @functools.cached_property
        def sums(self):
            summed.append(1)
            return domains.FlatPoints.sums.func(self)

    monkeypatch.setattr(domains, "_level_extents", refuse)
    monkeypatch.setattr(seq, "FlatPoints", Counted)
    got = run()
    assert (len(made), len(summed)) == ((1, 0) if explicit else (1, 1))
    for a, b in zip(got, want):
        for f in ("params", "chi", "iterations", "error", "und_center",
                  "und_global_center", "def_global_center"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
