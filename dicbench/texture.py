"""The benchmark's texture: blurred uniform speckle drawn from a seed.

After correlation_tpu_torch.problems.speckle_frames's noise, with the
seed as an argument and the drawing done on the solve's device by a
torch.Generator, in a few large calls: uniform noise in [0, 255), blurred
by a box 5 wide along each axis, here twice (a triangle 9 wide, so a
speckle spans about 5 px), with zero padding.  Its contrast is stretched
linearly about mid-gray, clamped to [0, 255] and floored, where the
program's copy blurs once and takes twice the value modulo 255: its
sharper grain and the modulo's jumps of a whole gray range leave a frame
rendered at fractional positions (dicbench/motions) with no clean
subpixel answer (chi about 100-800 where this texture gives about 4).
"""

from __future__ import annotations

import torch

# The blurred noise's spread (about 10 gray levels) stretched to about 50.
CONTRAST = 5.0


def _box5(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The mean of 5 neighbours along `dim`, zero outside: five shifted
    slices added in a fixed order."""
    n = x.shape[dim]
    pad = [0, 0] * (x.dim() - 1 - dim) + [2, 2]
    xp = torch.nn.functional.pad(x, pad)
    acc = xp.narrow(dim, 0, n)
    for k in range(1, 5):
        acc = acc + xp.narrow(dim, k, n)
    return acc / 5.0


def speckle(height: int, width: int, seed: int, device) -> torch.Tensor:
    """[height, width] float64 speckle of `seed` on `device`, each value a
    whole number in [0, 255]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    base = torch.rand((height + 8, width + 8), generator=gen,
                      device=device, dtype=torch.float64) * 255.0
    base = _box5(_box5(_box5(_box5(base, 0), 0), 1), 1)
    return torch.floor((base - 127.5) * CONTRAST + 128.0).clamp(0.0, 255.0)[
        4:-4, 4:-4]
