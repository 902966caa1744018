"""Freehand-polygon triangulation and rasterization (host-side).

The port's own copy of correlation_tpu/polygon.py (which it may not
import: that package pulls in jax), with the same arithmetic and the same
point order.  Reimplements the reference's blob pipeline
(polygon_class.cpp):
  * O(n^2) self-intersection rejection of the closed contour
    (simpleLoop, polygon_class.cpp:195-222),
  * counter-clockwise orientation fix by signed area
    (polygon_class.cpp:71-98, 231-233),
  * ear-clipping triangulation with in-cone + diagonal visibility tests
    (polygon_class.cpp:100-191, 224-281),
  * scanline rasterization of each triangle, split at the middle vertex into
    two flat-base triangles (polygon_class.cpp:283-403).

Runs once per run on the host; plain NumPy/Python is fine here (the reference
also runs this serially on the CPU).
"""

from __future__ import annotations

import numpy as np


def _area2(a, b, c) -> float:
    """Twice the signed triangle area (cross product),
    polygon_class.cpp:52-60."""
    return (b[0] - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (b[1] - a[1])


def _left(a, b, c) -> bool:
    return _area2(a, b, c) > 0.0


def _left_on(a, b, c) -> bool:
    return _area2(a, b, c) >= 0.0


def _collinear(a, b, c) -> bool:
    return _area2(a, b, c) == 0.0


def _between(a, b, c) -> bool:
    if not _collinear(a, b, c):
        return False
    if a[0] != b[0]:
        return (a[0] <= c[0] <= b[0]) or (a[0] >= c[0] >= b[0])
    return (a[1] <= c[1] <= b[1]) or (a[1] >= c[1] >= b[1])


def _intersect_prop(a, b, c, d) -> bool:
    if (
        _collinear(a, b, c)
        or _collinear(a, b, d)
        or _collinear(c, d, a)
        or _collinear(c, d, b)
    ):
        return False
    return ((not _left(a, b, c)) ^ (not _left(a, b, d))) and (
        (not _left(c, d, a)) ^ (not _left(c, d, b))
    )


def _intersect(a, b, c, d) -> bool:
    if _intersect_prop(a, b, c, d):
        return True
    return (
        _between(a, b, c)
        or _between(a, b, d)
        or _between(c, d, a)
        or _between(c, d, b)
    )


class Polygon:
    """Circular-vertex polygon with triangulation, mirroring
    polygonBlob_class."""

    def __init__(self, contour: np.ndarray):
        self.pts = [tuple(map(float, p)) for p in np.asarray(contour)]
        self.error = False
        self.triangles: list[tuple[int, int, int]] = []
        self._triangulate()

    # -- topology helpers over a live index ring ---------------------------

    def _simple_loop(self, ring) -> bool:
        """Reject self-intersecting contours (polygon_class.cpp:195-222)."""
        n = len(ring)
        if n < 4:
            return True
        p = self.pts
        for i in range(n):
            a, b = ring[i], ring[(i + 1) % n]
            for j in range(i + 2, n):
                c, d = ring[j], ring[(j + 1) % n]
                if c == a or d == a or c == b or d == b:
                    continue
                if _intersect(p[a], p[b], p[c], p[d]):
                    return False
        return True

    def _diagonal_ie(self, ring, i1, i2) -> bool:
        p = self.pts
        n = len(ring)
        for k in range(n):
            c, c1 = ring[k], ring[(k + 1) % n]
            if c in (i1, i2) or c1 in (i1, i2):
                continue
            if _intersect(p[i1], p[i2], p[c], p[c1]):
                return False
        return True

    def _in_cone(self, ring, i1, i2) -> bool:
        p = self.pts
        pos = ring.index(i1)
        a1 = ring[(pos + 1) % len(ring)]
        a0 = ring[(pos - 1) % len(ring)]
        if _left_on(p[i1], p[a1], p[a0]):
            return _left(p[i1], p[i2], p[a0]) and _left(p[i2], p[i1], p[a1])
        return not (
            _left_on(p[i1], p[i2], p[a1]) and _left_on(p[i2], p[i1], p[a0])
        )

    def _diagonal(self, ring, i1, i2) -> bool:
        return (
            self._in_cone(ring, i1, i2)
            and self._in_cone(ring, i2, i1)
            and self._diagonal_ie(ring, i1, i2)
        )

    def _triangulate(self):
        ring = list(range(len(self.pts)))
        if len(ring) < 3:
            self.error = True
            return
        if not self._simple_loop(ring):
            self.error = True
            return
        # Orientation fix: fan signed area from vertex 0
        # (polygon_class.cpp:71-98).
        p = self.pts
        area = sum(
            _area2(p[ring[0]], p[ring[k]], p[ring[k + 1]])
            for k in range(1, len(ring) - 1)
        )
        if area < 0:
            ring.reverse()

        ear = {
            ring[k]: self._diagonal(
                ring, ring[(k - 1) % len(ring)], ring[(k + 1) % len(ring)]
            )
            for k in range(len(ring))
        }

        guard = len(ring) * len(ring) + 8
        while len(ring) > 3 and guard > 0:
            guard -= 1
            clipped = False
            for k in range(len(ring)):
                v2 = ring[k]
                if not ear[v2]:
                    continue
                v1 = ring[(k - 1) % len(ring)]
                v3 = ring[(k + 1) % len(ring)]
                self.triangles.append((v1, v2, v3))
                ring.pop(k)
                v0 = ring[(ring.index(v1) - 1) % len(ring)]
                v4 = ring[(ring.index(v3) + 1) % len(ring)]
                ear[v1] = self._diagonal(ring, v0, v3)
                ear[v3] = self._diagonal(ring, v1, v4)
                clipped = True
                break
            if not clipped:  # degenerate polygon; bail out like an error
                self.error = True
                return
        self.triangles.append((ring[0], ring[1], ring[2]))

    # -- rasterization -----------------------------------------------------

    def inside_points(self) -> np.ndarray:
        """Interior integer pixels of all triangles
        (polygonBlob_class::getInsidePoints, polygon_class.cpp:418-429)."""
        out = []
        for t in self.triangles:
            out.append(self._triangle_points(*(self.pts[i] for i in t)))
        if not out:
            return np.zeros((0, 2), np.float32)
        return np.concatenate(out, axis=0)

    @staticmethod
    def _line(v1, v2):
        """x = dxdy * y + x0 through two vertices
        (polygon_class.cpp:405-416)."""
        den = v2[1] - v1[1]
        if den == 0:
            return None
        dxdy = (v2[0] - v1[0]) / den
        return dxdy, v1[0] - dxdy * v1[1]

    @classmethod
    def _flat_triangle_points(cls, v1, v2, v3) -> np.ndarray:
        """Scanline fill of a triangle whose v1-v2 edge is horizontal
        (polygon_class.cpp:357-403)."""
        dy = int(np.floor(v3[1])) - int(np.floor(v1[1]))
        dx = int(np.floor(v2[0])) - int(np.floor(v1[0]))
        if dx == 0 or dy == 0:
            return np.zeros((0, 2), np.float32)
        small, big = (v1, v2) if dx > 0 else (v2, v1)
        line_s = cls._line(small, v3)
        line_b = cls._line(big, v3)
        j0 = int(np.ceil(v1[1] if dy > 0 else v3[1]))
        j1 = int(np.ceil(v3[1] if dy > 0 else v1[1]))
        pts = []
        for j in range(j0, j1):
            i0 = int(np.ceil(line_s[0] * j + line_s[1]))
            i1 = int(np.ceil(line_b[0] * j + line_b[1]))
            for i in range(i0, i1):
                pts.append((i, j))
        return np.array(pts, np.float32).reshape(-1, 2)

    @classmethod
    def _triangle_points(cls, v1, v2, v3) -> np.ndarray:
        """General triangle: split at the middle vertex into two flat
        triangles (polygon_class.cpp:283-355)."""
        if v2[1] == v1[1]:
            return cls._flat_triangle_points(v1, v2, v3)
        if v3[1] == v1[1]:
            return cls._flat_triangle_points(v3, v1, v2)
        if v3[1] == v2[1]:
            return cls._flat_triangle_points(v2, v3, v1)

        vs = sorted([v1, v2, v3], key=lambda v: v[1])
        ymin, ymid, ymax = vs
        line = cls._line(ymin, ymax)
        if line is None:
            return np.zeros((0, 2), np.float32)
        ynew = (line[0] * ymid[1] + line[1], ymid[1])
        upper = cls._flat_triangle_points(ymid, ynew, ymax)
        lower = cls._flat_triangle_points(ymid, ynew, ymin)
        return np.concatenate([upper, lower], axis=0)
