"""Correlation-domain geometry: padded per-level subset point sets (NumPy).

Port of the host-side part of correlation_tpu/domains.py for the main
path: SubsetBatch, the %2^l per-level decimation, make_batch and
rectangular domains.  Ragged per-subset point lists become fixed-shape
padded arrays plus masks so all subsets solve as one batch.

A point survives to level l if its rounded integer coordinates are
divisible by 2^l; its coordinates scale by 2^-l.  The JAX package sends
batches of at most 64 subsets through its native C++ decimation; the
port always uses the vectorized NumPy compaction, which gives the same
arrays (tests/test_torch_domains.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SubsetBatch:
    """A batch of S subsets as padded per-level arrays.

    xy[l]:    [S, P_l, 2] float32 undeformed positions at level l
    mask[l]:  [S, P_l] bool
    center0:  [S, 2] float32 undeformed centers at level 0
    extents:  per level (ext_y, ext_x), the largest masked point span
              (ceil), which sizes the image tiles
    """

    xy: list
    mask: list
    center0: object
    extents: list[tuple[int, int]] | None = None

    @property
    def num_subsets(self) -> int:
        return int(self.center0.shape[0])

    def to_device(self, device) -> "SubsetBatch":
        """A copy whose arrays are torch tensors on `device`."""

        def put(a, dtype):
            return torch.as_tensor(a, dtype=dtype, device=device)

        return SubsetBatch(
            xy=[put(a, torch.float32) for a in self.xy],
            mask=[put(a, torch.bool) for a in self.mask],
            center0=put(self.center0, torch.float32),
            extents=self.extents,
        )


def _level_extents(xs, ms) -> list[tuple[int, int]]:
    """Max masked point span (ceil) per level, for static tile sizing."""
    out = []
    for xy, mask in zip(xs, ms):
        if mask.any():
            mins = np.where(mask[..., None], xy, np.inf).min(axis=1)
            maxs = np.where(mask[..., None], xy, -np.inf).max(axis=1)
            span = np.max(
                np.where(mask.any(axis=1)[:, None], maxs - mins, 0.0),
                axis=0,
            )
            out.append((int(np.ceil(span[1])), int(np.ceil(span[0]))))
        else:
            out.append((1, 1))
    return out


def _pad_points(
    point_lists: list[np.ndarray],
    pad_to_multiple: int = 8,
    pad_to: int | None = None,
):
    """Pad ragged per-subset point lists to a common length (a multiple of
    8, at least pad_to)."""
    max_p = max((len(p) for p in point_lists), default=0)
    max_p = max(max_p, 1)
    if pad_to is not None:
        max_p = max(max_p, pad_to)
    max_p = -(-max_p // pad_to_multiple) * pad_to_multiple
    s = len(point_lists)
    xy = np.zeros((s, max_p, 2), np.float32)
    mask = np.zeros((s, max_p), bool)
    for i, pts in enumerate(point_lists):
        n = len(pts)
        if n:
            xy[i, :n] = pts
            mask[i, :n] = True
    return xy, mask


def decimate_levels(
    xy0: np.ndarray,
    mask0: np.ndarray,
    levels: list[int],
    pad_to: list[int] | None = None,
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Per-level point arrays by the %2^l rule.  One stable argsort per
    level brings each subset's surviving points to the front, keeping the
    x-major point order."""
    max_level = max(levels)
    xs = [None] * (max_level + 1)
    ms = [None] * (max_level + 1)
    xs[0], ms[0] = xy0, mask0
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
        xs[level] = np.where(
            mask_l[..., None], xy_l / np.float32(mag), 0.0
        ).astype(np.float32)
        ms[level] = mask_l
    return xs, ms


def make_batch(
    point_lists: list[np.ndarray],
    centers: np.ndarray | None,
    max_level: int,
    pad_to: list[int] | None = None,
) -> SubsetBatch:
    """A SubsetBatch from per-subset level-0 point lists.

    centers: [S, 2] explicit centers, or None for the mean of each
    subset's points.  pad_to: per-level padded point counts.
    """
    xy0, mask0 = _pad_points(
        [np.asarray(p, np.float32).reshape(-1, 2) for p in point_lists],
        pad_to=pad_to[0] if pad_to else None,
    )
    if centers is None:
        n = np.maximum(mask0.sum(axis=1), 1)[:, None]
        centers = (xy0 * mask0[..., None]).sum(axis=1) / n
    xs, ms = decimate_levels(xy0, mask0, list(range(max_level + 1)), pad_to)
    return SubsetBatch(
        xs, ms, np.asarray(centers, np.float32),
        extents=_level_extents(xs, ms),
    )


@dataclasses.dataclass(frozen=True)
class RectangularDomain:
    """A rectangle tiled into hs x vs sectors."""

    x_begin: float
    y_begin: float
    x_end: float
    y_end: float
    horizontal_subdivisions: int = 1
    vertical_subdivisions: int = 1

    @property
    def x_center(self):
        return (self.x_begin + self.x_end) * 0.5

    @property
    def y_center(self):
        return (self.y_begin + self.y_end) * 0.5


def rectangular_sectors(dom: RectangularDomain):
    """Sector centers and integer half-dims; sector i * vs + j.

    Returns (centers [S, 2] float32 with integer values, xdim, ydim).
    """
    hs = dom.horizontal_subdivisions
    vs = dom.vertical_subdivisions
    x0i, x1i = int(dom.x_begin), int(dom.x_end)
    y0i, y1i = int(dom.y_begin), int(dom.y_end)
    xdim = (abs(x1i - x0i) // hs - 1) // 2
    ydim = (abs(y1i - y0i) // vs - 1) // 2

    fxdim = (abs(dom.x_end - dom.x_begin) / hs - 1.0) / 2.0
    fydim = (abs(dom.y_end - dom.y_begin) / vs - 1.0) / 2.0

    centers = np.zeros((hs * vs, 2), np.float32)
    for i in range(hs):
        cx = int(0.5 + dom.x_begin + fxdim + (2.0 * fxdim + 1.0) * i)
        for j in range(vs):
            cy = int(0.5 + dom.y_begin + fydim + (2.0 * fydim + 1.0) * j)
            centers[i * vs + j] = (cx, cy)
    return centers, xdim, ydim


def rectangular_points(center_x: int, center_y: int, xdim: int, ydim: int):
    """Integer grid [cx-xdim, cx+xdim] x [cy-ydim, cy+ydim], x-major."""
    xs = np.arange(center_x - xdim, center_x + xdim + 1)
    ys = np.arange(center_y - ydim, center_y + ydim + 1)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel()], axis=-1).astype(np.float32)


def rectangular_batch(dom: RectangularDomain, max_level: int) -> SubsetBatch:
    centers, xdim, ydim = rectangular_sectors(dom)
    pts = [
        rectangular_points(int(c[0]), int(c[1]), xdim, ydim) for c in centers
    ]
    return make_batch(pts, centers, max_level)
