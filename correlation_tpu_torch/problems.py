"""The dense-grid problem that bench.py measures, rebuilt with NumPy.

A 1024x1024 uint8-valued speckle (blurred uniform noise from seed 0), the
deformed frame the same texture shifted by one row (true warp u = 0,
v = +1), and a dense grid of 21x21-pixel subsets, solved AFFINE/BICUBIC
over pyramid levels 2-1-0 at the reference's stopping rule (max 50
iterations, precision 1e-3).  Arrays equal bench.build_problem's
(tests/test_torch_domains.py).
"""

from __future__ import annotations

import numpy as np

from correlation_tpu_torch.config import (
    FittingModel,
    Interpolation,
    PyramidConfig,
    SolverConfig,
)
from correlation_tpu_torch.domains import SubsetBatch, make_batch


def speckle(h: int, w: int, seed: int, row_shift: int = 0) -> np.ndarray:
    """[h, w] float32 uint8-valued speckle: uniform noise from `seed`,
    box-blurred 5 wide along both axes, scaled by 2 modulo 255, floored.
    row_shift = 1 gives the same texture moved down by one row."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h + 8, w + 8))
    k = np.ones(5) / 5.0
    base = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 0, base)
    base = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, base)
    y0 = 4 - row_shift
    return np.floor(base[y0 : y0 + h, 4 : w + 4] * 2.0 % 255.0).astype(
        np.float32
    )


def dense_grid_problem(
    num_subsets: int = 4096, img_hw: int = 1024, half: int = 10,
    stop: int = 2,
) -> tuple[SolverConfig, np.ndarray, np.ndarray, SubsetBatch, np.ndarray]:
    """Returns (cfg, und [H, W] float32, dfm [H, W] float32, batch,
    params0 [S, 6] zeros)."""
    und = speckle(img_hw, img_hw, 0)
    dfm = speckle(img_hw, img_hw, 0, row_shift=1)

    cfg = SolverConfig(
        model=FittingModel.AFFINE,
        interpolation=Interpolation.BICUBIC,
        pyramid=PyramidConfig(0, 1, stop),
        max_iterations=50,
        precision=1e-3,
    )
    side = int(np.ceil(np.sqrt(num_subsets)))
    margin = 4 * half
    coords = np.linspace(margin, img_hw - margin, side)
    centers = [(int(cx), int(cy)) for cy in coords for cx in coords]
    centers = centers[:num_subsets]
    pts = []
    for cx, cy in centers:
        gx, gy = np.meshgrid(
            np.arange(cx - half, cx + half + 1),
            np.arange(cy - half, cy + half + 1),
            indexing="ij",
        )
        pts.append(np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32))
    batch = make_batch(pts, np.array(centers, np.float32), stop)
    params0 = np.zeros((num_subsets, cfg.num_params), np.float32)
    return cfg, und, dfm, batch, params0
