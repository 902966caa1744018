"""A freehand blob traced around a tension specimen's reduced section: the
outline of an ASTM E8/E8M sheet-type specimen's gauge region (the reduced
section and both fillets, out to the grip width, closed across the grips),
rasterized by a frozen copy of
correlation_tpu_torch.domains.blob_inside_points_crossing (the reference
application's GPU rule: crossing numbers of a ray from x = -1, by signed
line evaluations).  One blob is one subset.

domain keys: dimensions_mm {A: reduced section length, W: its width,
R: fillet radius, C: grip width}, px_per_mm, center [x, y] (the middle of
the reduced section), axis ("x": the specimen's length along the frame's
x), arc_vertices (points on each fillet arc, both ends included).  The
centre is the point mean (None).

A fillet is the arc of radius R tangent to the reduced section's edge at
its end, out to where the half-width reaches C / 2: it spans
sqrt(R^2 - (R - (C - W) / 2)^2) along the axis.
"""

from __future__ import annotations

import math

import numpy as np


def contour(domain: dict) -> np.ndarray:
    """The outline [N, 2] (float64, x, y), once around, not closed."""
    if domain.get("axis", "x") != "x":
        raise ValueError("the specimen's axis must be x")
    dims, s = domain["dimensions_mm"], float(domain["px_per_mm"])
    a = float(dims["A"]) / 2.0 * s
    hw = float(dims["W"]) / 2.0 * s
    hc = float(dims["C"]) / 2.0 * s
    r = float(dims["R"]) * s
    step = hc - hw
    if not 0.0 < step < r:
        raise ValueError("the grip must be wider than the reduced section "
                         "by less than two fillet radii")
    theta = math.acos((r - step) / r)  # the arc's angle at its centre
    cx, cy = (float(v) for v in domain["center"])
    n = int(domain["arc_vertices"])
    if n < 2:
        raise ValueError("a fillet arc needs at least its two ends")
    t = np.linspace(0.0, theta, n)
    # One fillet, from the reduced section's end outwards, about (0, 0):
    # dx along the axis, dy away from the axis.
    dx = a + r * np.sin(t)
    dy = hw + r * (1.0 - np.cos(t))
    # Right bottom (outwards), left bottom (inwards), left top (outwards),
    # right top (inwards): once around.
    pts = np.concatenate([
        np.stack([cx + dx, cy + dy], -1)[::-1],
        np.stack([cx - dx, cy + dy], -1),
        np.stack([cx - dx, cy - dy], -1)[::-1],
        np.stack([cx + dx, cy - dy], -1),
    ])
    return pts


def inside_points_crossing(contour: np.ndarray) -> np.ndarray:
    """Interior integer points by crossing number, y-major then x: a
    horizontal ray from x = -1 to the point, counting proper crossings of
    the contour's edges by signed line evaluations (a frozen copy of
    correlation_tpu_torch.domains.blob_inside_points_crossing)."""
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


def points(domain: dict, frame: dict):
    pts = inside_points_crossing(contour(domain))
    if len(pts) == 0:
        raise ValueError("the outline encloses no pixel")
    return [pts], None
