"""A dense grid of square subsets: a frozen copy of
correlation_tpu_torch.problems._grid, with the frame's height and width
apart.

domain keys: subsets (S), half (a subset is 2 half + 1 px square).  The
grid is ceil(sqrt(S)) subsets a side, from 4 half px off each edge;
centers are whole pixels and are passed to the solver explicitly.
"""

from __future__ import annotations

import numpy as np


def points(domain: dict, frame: dict):
    num, half = int(domain["subsets"]), int(domain["half"])
    side = int(np.ceil(np.sqrt(num)))
    margin = 4 * half
    xs = np.linspace(margin, frame["width"] - margin, side)
    ys = np.linspace(margin, frame["height"] - margin, side)
    centers = [(int(cx), int(cy)) for cy in ys for cx in xs][:num]
    offs = np.arange(-half, half + 1)
    gx, gy = np.meshgrid(offs, offs, indexing="ij")  # x-major
    square = np.stack([gx.ravel(), gy.ravel()], -1)
    pts = [(square + np.array(c)).astype(np.float32) for c in centers]
    return pts, np.array(centers, np.float32)
