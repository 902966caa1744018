"""Correlation-domain geometry: padded per-level subset point sets (NumPy).

Port of the host side of correlation_tpu/domains.py: SubsetBatch, the
%2^l per-level decimation, make_batch, rectangular, annular and blob
(freehand contour) domains, and combine_batches / split_result, which
solve several domains as one batch.  Ragged per-subset point lists become
fixed-shape padded arrays plus masks so all subsets solve as one batch.

A point survives to level l if its rounded integer coordinates are
divisible by 2^l; its coordinates scale by 2^-l.  The JAX package sends
batches of at most 64 subsets through its native C++ decimation; the
port always uses the vectorized NumPy compaction, which gives the same
arrays (tests/test_torch_domains.py).  The annular and crossing-number
generators are the JAX package's NumPy versions, which give its points in
its order with its native library off; that library computes in float32
and can keep other edge pixels, so the port does not load it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

PI = math.pi


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
        # Summed in float64: a float32 sum, one point at a time, drifts
        # by tenths of a pixel over a subset of 10^5 points.
        n = np.maximum(mask0.sum(axis=1), 1)[:, None]
        centers = (xy0 * mask0[..., None]).sum(axis=1, dtype=np.float64) / n
    xs, ms = decimate_levels(xy0, mask0, list(range(max_level + 1)), pad_to)
    return SubsetBatch(
        xs, ms, np.asarray(centers, np.float32),
        extents=_level_extents(xs, ms),
    )


def combine_batches(
    batches: list[SubsetBatch],
) -> tuple[SubsetBatch, list[int]]:
    """Concatenate independent domains into one batch, solved by one call.

    Per-level point arrays pad to the widest member and concatenate along
    the subset axis; the extents are the union's, so every subset gets
    the largest member's tile.  Results split back per domain with
    split_result(result, counts).

    Returns (combined batch, per-domain subset counts).
    """
    if not batches:
        raise ValueError("no batches to combine")
    n_levels = len(batches[0].xy)
    if any(len(b.xy) != n_levels for b in batches):
        raise ValueError("batches disagree on pyramid depth")
    xs, ms = [], []
    for lvl in range(n_levels):
        p_max = max(int(np.asarray(b.xy[lvl]).shape[1]) for b in batches)
        xy_parts, m_parts = [], []
        for b in batches:
            xy = np.asarray(b.xy[lvl])
            mk = np.asarray(b.mask[lvl])
            pad = p_max - xy.shape[1]
            if pad:
                xy = np.pad(xy, ((0, 0), (0, pad), (0, 0)))
                mk = np.pad(mk, ((0, 0), (0, pad)))
            xy_parts.append(xy)
            m_parts.append(mk)
        xs.append(np.concatenate(xy_parts, axis=0))
        ms.append(np.concatenate(m_parts, axis=0))
    center0 = np.concatenate(
        [np.asarray(b.center0) for b in batches], axis=0
    )
    combined = SubsetBatch(
        xs, ms, center0.astype(np.float32), extents=_level_extents(xs, ms),
    )
    return combined, [b.num_subsets for b in batches]


def split_result(result, counts: list[int]):
    """Split a combined batch's CorrelationResult back per domain, each
    field into views on its device."""
    counts = [int(c) for c in counts]
    fields = {k: torch.split(v, counts) for k, v in result._asdict().items()}
    return [
        type(result)(**{k: fields[k][i] for k in fields})
        for i in range(len(counts))
    ]


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


def rectangular_contour(center_x, center_y, xdim, ydim):
    """The 4 corners of a rectangular sector."""
    x0, y0 = center_x - xdim, center_y - ydim
    x1, y1 = center_x + xdim, center_y + ydim
    return np.array(
        [[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float32
    )


# ---------------------------------------------------------------------------
# Annular domains
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AnnularDomain:
    """An annulus tiled into rs radial x as angular sectors."""

    x_center: float
    y_center: float
    r_inside: float
    r_outside: float
    radial_subdivisions: int = 1
    angular_subdivisions: int = 1


def annular_sector_points(
    r: float,
    dr: float,
    a: float,
    da: float,
    cx: float,
    cy: float,
    as_: int,
    gpu_semantics: bool = False,
) -> np.ndarray:
    """Integer points of one annular sector, x-major then y.

    By default the reference's CPU generator: a bounding box from the
    sector corners with the 1.2x "cheap sag" on the outer corners, the
    radius test ri^2 < r^2 < ro^2 and a two-cross-product wedge test.
    With gpu_semantics=True, its GPU functor's closed radius test and
    exact atan2 angle test instead.
    """
    ro2 = (r + dr) * (r + dr)
    ri2 = r * r
    if as_ == 1:
        x0 = int(cx - (r + dr))
        x1 = int(cx + (r + dr))
        y0 = int(cy - (r + dr))
        y1 = int(cy + (r + dr))
        c00x = c01x = c10x = c11x = c00y = c01y = c10y = c11y = 0.0
    else:
        sin0, cos0 = math.sin(a), math.cos(a)
        sin1, cos1 = math.sin(a + da), math.cos(a + da)
        sin2, cos2 = math.sin(a + da / 2.0), math.cos(a + da / 2.0)
        c00x = cx + r * cos0
        c01x = cx + r * cos1
        c10x = cx + (r + dr) * cos0 * 1.2
        c11x = cx + (r + dr) * cos1 * 1.2
        c00y = cy + r * sin0
        c01y = cy + r * sin1
        c10y = cy + (r + dr) * sin0 * 1.2
        c11y = cy + (r + dr) * sin1 * 1.2
        arc_x = cx + (r + dr) * cos2
        arc_y = cy + (r + dr) * sin2
        x0 = int(min(arc_x, c00x, c01x, c10x, c11x))
        x1 = int(max(arc_x, c00x, c01x, c10x, c11x))
        y0 = int(min(arc_y, c00y, c01y, c10y, c11y))
        y1 = int(max(arc_y, c00y, c01y, c10y, c11y))

    xs = np.arange(x0, x1, dtype=np.float32)
    ys = np.arange(y0, y1, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")  # x outer, y inner
    dx = gx - cx
    dy = gy - cy
    r2 = dx * dx + dy * dy

    if gpu_semantics:
        angle = np.arctan2(dy, dx)
        angle = np.where(angle < 0.0, angle + 2.0 * np.float32(PI), angle)
        keep = (r2 >= ri2) & (r2 <= ro2)
        if as_ != 1:
            keep &= (angle >= a) & (angle <= a + da)
    else:
        keep = (r2 > ri2) & (r2 < ro2)
        if as_ != 1:
            cross1 = (c11x - gx) * (c01y - c11y) - (c11y - gy) * (c01x - c11x)
            cross2 = (c00x - gx) * (c10y - c00y) - (c00y - gy) * (c10x - c00x)
            keep &= cross1 * cross2 > 0
    return np.stack([gx[keep], gy[keep]], axis=-1).astype(np.float32)


def annular_batch(
    dom: AnnularDomain,
    max_level: int,
    base_angle: float = 0.0,
    gpu_semantics: bool = False,
) -> SubsetBatch:
    """All rs x as sectors, sector i * as + j (radial ring i, angle j),
    centered on their point means."""
    rs, as_ = dom.radial_subdivisions, dom.angular_subdivisions
    dr = (dom.r_outside - dom.r_inside) / rs
    da = 2.0 * PI / as_
    pts = []
    for i in range(rs):
        for j in range(as_):
            r = dom.r_inside + i * dr
            a = base_angle + j * da
            pts.append(
                annular_sector_points(
                    r, dr, a, da, dom.x_center, dom.y_center, as_,
                    gpu_semantics,
                )
            )
    return make_batch(pts, None, max_level)


def annular_sector_centers(dom: AnnularDomain) -> np.ndarray:
    """Nominal sector centers (mid-radius, mid-angle; the annulus center
    for a single angular sector), for customizing the first guess."""
    rs, as_ = dom.radial_subdivisions, dom.angular_subdivisions
    dr = (dom.r_outside - dom.r_inside) / rs
    da = 2.0 * PI / as_
    centers = np.zeros((rs * as_, 2), np.float32)
    for i in range(rs):
        for j in range(as_):
            if as_ > 1:
                ca = j * da + da / 2.0
                cr = dom.r_inside + i * dr + dr / 2.0
                centers[i * as_ + j] = (
                    dom.x_center + cr * math.cos(ca),
                    dom.y_center + cr * math.sin(ca),
                )
            else:
                centers[i * as_ + j] = (dom.x_center, dom.y_center)
    return centers


# ---------------------------------------------------------------------------
# Blob (freehand contour) domains
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlobDomain:
    """A freehand contour domain, one sector."""

    contour: np.ndarray  # [N, 2]

    @property
    def x_center(self):
        return float(np.mean(self.contour[:, 0]))

    @property
    def y_center(self):
        return float(np.mean(self.contour[:, 1]))


def blob_inside_points_crossing(contour: np.ndarray) -> np.ndarray:
    """Interior integer points by crossing number, y-major then x: a
    horizontal ray from x = -1 to the point, counting proper crossings of
    the contour's edges by signed line evaluations (the reference's GPU
    rasterizer)."""
    contour = np.asarray(contour, np.float64)
    n = len(contour)
    if n < 3:
        return np.zeros((0, 2), np.float32)
    x0 = int(np.ceil(contour[:, 0].min()))
    x1 = int(np.floor(contour[:, 0].max()))
    y0 = int(np.ceil(contour[:, 1].min()))
    y1 = int(np.floor(contour[:, 1].max()))
    xs = np.arange(x0, x1 + 1, dtype=np.float64)
    ys = np.arange(y0, y1 + 1, dtype=np.float64)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")  # y-major raster order
    px = gx.ravel()
    py = gy.ravel()

    crossings = np.zeros(px.shape, np.int64)
    v2 = np.roll(contour, -1, axis=0)
    for (x_a, y_a), (x_b, y_b) in zip(contour, v2):
        # line equation of the edge: a x + b y + c = 0
        a = y_b - y_a
        b = x_a - x_b
        c = x_b * y_a - x_a * y_b
        # Reject edges fully above or below the ray (strict).
        possible = ~(((y_a > py) & (y_b > py)) | ((y_a < py) & (y_b < py)))
        temp = b * py + c
        d1 = -a + temp  # ray start at x = -1
        d2 = a * px + temp
        straddles = ~(((d1 > 0) & (d2 > 0)) | ((d1 < 0) & (d2 < 0)))
        not_collinear = ~((d1 == 0) & (d2 == 0))
        crossings += (possible & straddles & not_collinear).astype(np.int64)

    inside = crossings % 2 == 1
    return np.stack([px[inside], py[inside]], axis=-1).astype(np.float32)


def blob_batch(
    dom: BlobDomain, max_level: int, use_triangulation: bool = True
) -> SubsetBatch:
    """A one-sector batch from a freehand contour.

    use_triangulation: the reference's CPU pipeline (simple-loop check,
    ear clipping, scanline fill; polygon.py), else the crossing-number
    rasterizer.  Raises ValueError for a self-intersecting contour or one
    that encloses no pixel.
    """
    if use_triangulation:
        from correlation_tpu_torch.polygon import Polygon

        poly = Polygon(np.asarray(dom.contour, np.float32))
        if poly.error:
            raise ValueError("blob contour is self-intersecting (bad domain)")
        pts = poly.inside_points()
    else:
        pts = blob_inside_points_crossing(dom.contour)
    if len(pts) == 0:
        raise ValueError("blob contour encloses no pixels (bad domain)")
    return make_batch([pts], None, max_level)
