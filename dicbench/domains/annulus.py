"""An annulus cut into radial x angular sectors: a frozen copy of
correlation_tpu_torch.domains.annular_sector_points (the reference
application's CPU generator: a bounding box from the sector's corners with
the 1.2x sag on the outer ones, the open radius test and a two-cross-
product wedge test) and of annular_batch's sector order (ring i, angle j
-> sector i * angular + j).

domain keys: center [x, y], radii [inside, outside], subdivisions
[radial, angular].  Centers are the sectors' point means (None).
"""

from __future__ import annotations

import math

import numpy as np


def _sector(r, dr, a, da, cx, cy, angular):
    ro2, ri2 = (r + dr) * (r + dr), r * r
    if angular == 1:
        x0, x1 = int(cx - (r + dr)), int(cx + (r + dr))
        y0, y1 = int(cy - (r + dr)), int(cy + (r + dr))
        c = (0.0,) * 8
    else:
        s0, c0 = math.sin(a), math.cos(a)
        s1, c1 = math.sin(a + da), math.cos(a + da)
        s2, c2 = math.sin(a + da / 2.0), math.cos(a + da / 2.0)
        c = (cx + r * c0, cx + r * c1, cx + (r + dr) * c0 * 1.2,
             cx + (r + dr) * c1 * 1.2, cy + r * s0, cy + r * s1,
             cy + (r + dr) * s0 * 1.2, cy + (r + dr) * s1 * 1.2)
        arc_x, arc_y = cx + (r + dr) * c2, cy + (r + dr) * s2
        x0, x1 = int(min(arc_x, *c[:4])), int(max(arc_x, *c[:4]))
        y0, y1 = int(min(arc_y, *c[4:])), int(max(arc_y, *c[4:]))
    c00x, c01x, c10x, c11x, c00y, c01y, c10y, c11y = c
    gx, gy = np.meshgrid(np.arange(x0, x1, dtype=np.float32),
                         np.arange(y0, y1, dtype=np.float32), indexing="ij")
    dx, dy = gx - cx, gy - cy
    r2 = dx * dx + dy * dy
    keep = (r2 > ri2) & (r2 < ro2)
    if angular != 1:
        cross1 = (c11x - gx) * (c01y - c11y) - (c11y - gy) * (c01x - c11x)
        cross2 = (c00x - gx) * (c10y - c00y) - (c00y - gy) * (c10x - c00x)
        keep &= cross1 * cross2 > 0
    return np.stack([gx[keep], gy[keep]], axis=-1).astype(np.float32)


def points(domain: dict, frame: dict):
    cx, cy = (float(v) for v in domain["center"])
    r_in, r_out = (float(v) for v in domain["radii"])
    radial, angular = (int(v) for v in domain["subdivisions"])
    dr = (r_out - r_in) / radial
    da = 2.0 * math.pi / angular
    pts = [_sector(r_in + i * dr, dr, j * da, da, cx, cy, angular)
           for i in range(radial) for j in range(angular)]
    return pts, None
