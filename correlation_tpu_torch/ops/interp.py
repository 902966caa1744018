"""Integer-position sampling of the undeformed image.

Only `sample_integer` is ported so far; the coefficient-field sampler of
correlation_tpu/ops/interp.py is not on the tiled main path.
"""

from __future__ import annotations

import torch


def sample_integer(image: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensities at rounded integer positions int(x + 0.5), clipped to the
    image: image [H, W, C], xy [..., 2] -> [..., C]."""
    h, w, c = image.shape
    ix = torch.clamp(torch.floor(xy[..., 0] + 0.5), 0, w - 1).long()
    iy = torch.clamp(torch.floor(xy[..., 1] + 0.5), 0, h - 1).long()
    return image.reshape(h * w, c)[iy * w + ix]
