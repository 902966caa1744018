"""Image pyramids: 5x5 binomial downsample with uint8 requantization.

Port of correlation_tpu/ops/pyramid.py with the same semantics:
  * 5x5 kernel, outer product of float32 [.05, .25, .4, .25, .05],
  * each level is half the previous (integer division of dims),
  * target pixel (ti, tj) averages the 5x5 source window centred at
    (2*ti, 2*tj); the one-pixel border of every level is zero,
  * every level is floored to integers, and the next level is built from
    the floored one.

The 25 products are summed in float64.  For uint8-valued inputs every
product (8-bit value times 24-bit weight) and every partial sum (below
2^9, a multiple of 2^-32) is exact in float64, so the sum is the exact
value of the float32-weighted window, whatever the order of summation:
the CPU and the GPU give identical levels.  No F.conv2d is used, so
cuDNN's TF32 mode cannot reach this code.

The JAX package sums in float32 in the order of its convolution, which
differs by image shape.  The two agree except where the exact sum lies
within float32 rounding of an integer; there `floor` may differ by one.
"""

from __future__ import annotations

import numpy as np
import torch

BINOMIAL_1D = np.array([0.05, 0.25, 0.4, 0.25, 0.05], np.float32)
_KERNEL = np.outer(BINOMIAL_1D, BINOMIAL_1D).astype(np.float32)


def downsample(image: torch.Tensor) -> torch.Tensor:
    """One pyramid level: [..., H, W, C] -> [..., H//2, W//2, C] float32."""
    h, w = image.shape[-3], image.shape[-2]
    th, tw = h // 2, w // 2
    out = torch.zeros(
        image.shape[:-3] + (th, tw, image.shape[-1]),
        dtype=torch.float32,
        device=image.device,
    )
    if th < 3 or tw < 3:
        return out
    src = image.to(torch.float64)
    acc = None
    for dj in range(5):
        for di in range(5):
            tap = src[..., dj : dj + 2 * (th - 2) : 2,
                      di : di + 2 * (tw - 2) : 2, :] * float(_KERNEL[dj, di])
            acc = tap if acc is None else acc + tap
    out[..., 1 : th - 1, 1 : tw - 1, :] = torch.floor(acc).to(torch.float32)
    return out


def build_pyramid(image: torch.Tensor, num_levels: int) -> list[torch.Tensor]:
    """Levels 0..num_levels of the pyramid of a [..., H, W, C] float32 image
    with integer (uint8) values; level 0 is the image itself."""
    levels = [image]
    for _ in range(num_levels):
        levels.append(downsample(levels[-1]))
    return levels
