"""Correlation-domain geometry: padded per-level subset point sets.

Port of the host side of correlation_tpu/domains.py: SubsetBatch, the
%2^l per-level decimation, make_batch, rectangular, annular and blob
(freehand contour) domains, and combine_batches / split_result, which
solve several domains as one batch.  Ragged per-subset point lists become
fixed-shape padded arrays plus masks so all subsets solve as one batch.

A point survives to level l if its rounded integer coordinates are
divisible by 2^l; its coordinates scale by 2^-l.  The JAX package pads
the lists and compacts them in NumPy (or its native C++ decimation); the
port builds the batch in torch from one flat array of the lists
(FlatPoints, build_batch), on the device that solves it: run_sequence on
the card, make_batch on the CPU with NumPy out.  The arrays are the same
(tests/test_torch_domains.py, tests/test_torch_batch_build.py).  The
annular and crossing-number generators are the JAX package's NumPy
versions, which give its points in its order with its native library
off; that library computes in float32 and can keep other edge pixels, so
the port does not load it.
"""

from __future__ import annotations

import dataclasses
import functools
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


class FlatPoints:
    """Ragged per-subset point lists as one array: `xy` [N, 2] float32,
    the lists one after another, and `counts` [S] int64, their lengths.
    `xy` is a view of one host buffer of 4-byte words (pinned where
    `pin`): the points, a zero row, the counts, a 0 and room for [S, 2]
    centers, which upload() copies to a device in one piece."""

    def __init__(self, point_lists, pin: bool = False):
        lists = [np.asarray(p, np.float32).reshape(-1, 2)
                 for p in point_lists]
        s = len(lists)
        self.counts = np.array([len(p) for p in lists], np.int64)
        n = int(self.counts.sum())
        self._words = torch.empty(2 * n + 3 * s + 3, dtype=torch.int32,
                                  pin_memory=pin)
        words = self._words.numpy()
        self.xy = words[:2 * n].view(np.float32).reshape(n, 2)
        if n:
            np.concatenate(lists, out=self.xy)
        words[2 * n:2 * n + 2] = 0
        words[2 * n + 2:2 * n + s + 2] = self.counts
        words[2 * n + s + 2] = 0

    def upload(self, centers, device):
        """One copy of the buffer, with `centers` [S, 2] written into it,
        to `device`: views of it as the points and a zero row [N + 1, 2]
        float32, the counts and a 0 [S + 1] int32, and the centers [S, 2]
        float32."""
        s, n = len(self.counts), len(self.xy)
        words = self._words.numpy()
        words.view(np.float32)[2 * n + s + 3:] = np.reshape(centers, -1)
        up = self._words.to(device, non_blocking=True)
        return (up[:2 * n + 2].view(torch.float32).view(n + 1, 2),
                up[2 * n + 2:2 * n + s + 3],
                up[2 * n + s + 3:].view(torch.float32).view(s, 2))

    @functools.cached_property
    def sums(self) -> np.ndarray:
        """[S, 2] float64 sums of each list's points.  Summed in float64:
        a float32 sum, one point at a time, drifts by tenths of a pixel
        over a subset of 10^5 points."""
        sums = np.zeros((len(self.counts), 2))
        filled = self.counts > 0
        if filled.any():
            starts = np.cumsum(self.counts) - self.counts
            sums[filled] = np.add.reduceat(self.xy.astype(np.float64),
                                           starts[filled], axis=0)
        return sums

    def means(self) -> np.ndarray:
        """[S, 2] float64 point means; NaN for an empty list, as
        np.mean."""
        with np.errstate(invalid="ignore", divide="ignore"):
            return self.sums / self.counts[:, None]


def _survivors(xy, counts, max_level):
    """Each level's survivors of the points `xy` [N + 1, 2] with `counts`
    [S + 1], as _levels takes them: a list a level of (cnt [S], the
    survivors of each list; keep [N], whether a point survives, and
    ranks [N], the survivors up to it, both None at level 0; first [S],
    the survivors before each list), and a device array of each level's
    largest count and its (x, y) extents."""
    dev = xy.device
    n, s = xy.shape[0] - 1, counts.shape[0] - 1
    i32 = dict(dtype=torch.int32, device=dev)
    seg = torch.repeat_interleave(torch.arange(s + 1, **i32), counts,
                                  output_size=n)
    rows = seg.long()[:, None].expand(n, 2)  # scatter_reduce's index
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    starts = ends - counts
    bits = torch.floor(xy[:n] + 0.5).to(torch.int32)
    bits = bits[:, 0] | bits[:, 1]
    levels, readings = [], []
    for level in range(max_level + 1):
        scaled, cnt, keep, ranks, first = xy[:n], counts, None, None, starts
        if level:
            scaled = scaled / (1 << level)
            keep = (bits & ((1 << level) - 1)) == 0
            ranks = torch.cumsum(keep, 0, dtype=torch.int32)
            before = torch.nn.functional.pad(ranks, (1, 0))
            first = before[starts]
            cnt = before[ends] - first

        def extreme(fill, how):
            # A list's amax or amin over its survivors; row S is empty.
            vals = (scaled if keep is None
                    else torch.where(keep[:, None], scaled, fill))
            return torch.full((s + 1, 2), fill, device=dev).scatter_reduce_(
                0, rows, vals, how)

        span = extreme(-math.inf, "amax") - extreme(math.inf, "amin")
        span = torch.where(cnt[:, None] > 0, span, 0.0)
        readings.append(torch.cat([cnt.max().reshape(1).double(),
                                   torch.ceil(span.amax(0)).double()]))
        levels.append((cnt[:s], keep, ranks, first[:s]))
    return levels, torch.stack(readings)


def _levels(xy, counts, max_level, pad_to=None):
    """Per-level padded point arrays of the points `xy` [N + 1, 2] (the
    lists one after another, then a zero row) with `counts` [S + 1] int32
    (the lists' lengths, then 0), both on one device: (xs, ms, extents)
    as SubsetBatch holds them.

    A point survives to level l when floor(x + 0.5) and floor(y + 0.5)
    are both divisible by 2^l; it keeps its list's order.  One copy to
    the host brings every level's largest count and extents, which size
    its padding; the rest stays on the device.  No two points write one
    address, but for the extents' amax and amin within a list."""
    n = xy.shape[0] - 1
    levels, readings = _survivors(xy, counts, max_level)
    readings = readings.cpu().tolist()  # the one read-back
    points = torch.arange(n, dtype=torch.int32, device=xy.device)
    xs, ms, extents = [], [], []
    for level, ((cnt, keep, ranks, first), (most, ext_x, ext_y)) in enumerate(
            zip(levels, readings)):
        width = max(int(most), 1, pad_to[level] if pad_to else 0)
        width = -(-width // 8) * 8
        slot = torch.arange(width, dtype=torch.int32, device=xy.device)
        mask = slot < cnt[:, None]
        k = torch.where(mask, first[:, None] + slot, n)  # n: the zero row
        if level:
            # pos[k]: the index of the level's k-th survivor; pos[n] = n;
            # point j, dropped, writes pos[n + 1 + j].
            pos = points.new_full((2 * n + 1,), n)
            pos.index_put_((torch.where(keep, ranks - 1, points + n + 1),),
                           points)
            k = pos[k]
        xs.append(xy[k] / (1 << level) if level else xy[k])
        ms.append(mask)
        extents.append((int(ext_y), int(ext_x)) if most else (1, 1))
    return xs, ms, extents


def build_batch(
    flat: FlatPoints,
    centers: np.ndarray | None,
    max_level: int,
    pad_to: list[int] | None = None,
    device="cpu",
) -> SubsetBatch:
    """A SubsetBatch of torch tensors on `device`, built there from one
    copy of the flat point lists (FlatPoints.upload).

    centers: [S, 2] explicit centers, or None for each list's point mean
    (FlatPoints.sums over the count; zero for an empty list).  pad_to:
    per-level padded point counts (each level pads to a multiple of 8,
    at least pad_to[l])."""
    if centers is None:
        centers = flat.sums / np.maximum(flat.counts, 1)[:, None]
    xy, counts, center0 = flat.upload(centers, device)
    xs, ms, extents = _levels(xy, counts, max_level, pad_to)
    return SubsetBatch(xs, ms, center0.clone(), extents=extents)


def decimate_levels(
    xy0: np.ndarray,
    mask0: np.ndarray,
    levels: list[int],
    pad_to: list[int] | None = None,
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Per-level point arrays by the %2^l rule (make_batch's); level 0
    is xy0 and mask0 as given."""
    flat = FlatPoints([xy[m] for xy, m in zip(xy0, mask0)])
    batch = build_batch(flat, np.zeros((len(mask0), 2)), max(levels),
                        pad_to)
    return ([xy0] + [a.numpy() for a in batch.xy[1:]],
            [mask0] + [a.numpy() for a in batch.mask[1:]])


def make_batch(
    point_lists: list[np.ndarray],
    centers: np.ndarray | None,
    max_level: int,
    pad_to: list[int] | None = None,
) -> SubsetBatch:
    """A SubsetBatch of NumPy arrays from per-subset level-0 point lists
    (build_batch on the CPU).

    centers: [S, 2] explicit centers, or None for the mean of each
    subset's points.  pad_to: per-level padded point counts.
    """
    batch = build_batch(FlatPoints(point_lists), centers, max_level, pad_to)
    return SubsetBatch([a.numpy() for a in batch.xy],
                       [a.numpy() for a in batch.mask],
                       batch.center0.numpy(), extents=batch.extents)


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
