"""A homogeneous deformation about a centre that changes from frame to
frame, rendered at mapped coordinates, after the DIC Challenge 2D
synthetic series (Reu et al., Exp. Mech. 58, 2018): a speckle texture
read at each pixel's mapped position and rounded to 8 bits.

motion keys: `period_frames` P, and `rate` and `amplitude`, each a map
from a component to a number: tx, ty (px), exx, eyy, exy (strain), rot
(rad); a missing one is 0.  Component g at frame t is

    g(t) = rate[g] t + amplitude[g] sin(2 pi t / P),

and frame t maps a frame-0 position X to

    x = c + R(rot) S (X - c) + (tx, ty),  S = [[1 + exx, exy],
                                               [exy, 1 + eyy]],

c the frame's centre ((W - 1) / 2, (H - 1) / 2).  Frame t is the texture (dicbench.texture) at the inverse map of
each pixel, by bicubic interpolation, clamped to [0, 255] and rounded;
frame 0 is the texture itself.  Every subset's answer differs (u and v
grow with its distance from c), is a fraction of a pixel, and departs
from a constant-velocity extrapolation wherever an amplitude is not 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dicbench import texture

COMPONENTS = ("tx", "ty", "exx", "eyy", "exy", "rot")


def components(motion: dict, t: int) -> dict:
    """Each component's value at frame t."""
    period = float(motion["period_frames"])
    rate, amp = motion.get("rate", {}), motion.get("amplitude", {})
    unknown = (set(rate) | set(amp)) - set(COMPONENTS)
    if unknown:
        raise ValueError(f"unknown motion components {sorted(unknown)}")
    s = math.sin(2.0 * math.pi * t / period)
    return {g: float(rate.get(g, 0.0)) * t + float(amp.get(g, 0.0)) * s
            for g in COMPONENTS}


def mapping(motion: dict, frame: dict, t: int):
    """(F [2, 2], d [2], c [2]) float64: frame t's x = c + F (X - c) + d."""
    g = components(motion, t)
    c = np.array([(frame["width"] - 1) / 2.0, (frame["height"] - 1) / 2.0])
    cr, sr = math.cos(g["rot"]), math.sin(g["rot"])
    rot = np.array([[cr, -sr], [sr, cr]])
    strain = np.array([[1.0 + g["exx"], g["exy"]],
                       [g["exy"], 1.0 + g["eyy"]]])
    return rot @ strain, np.array([g["tx"], g["ty"]]), c


def pad(motion: dict, frame: dict, pairs: int) -> int:
    """How far (px) the texture reaches past the frame: every corner's
    frame-0 position and the interpolation's stencil."""
    h, w = int(frame["height"]), int(frame["width"])
    corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]],
                       np.float64)
    reach = 0.0
    for t in range(pairs + 1):
        f, d, c = mapping(motion, frame, t)
        x0 = (corners - c - d) @ np.linalg.inv(f).T + c
        reach = max(reach, float(np.abs(x0 - corners).max()))
    return int(math.ceil(reach)) + 4


def frames(frame: dict, mix: dict, seed: int, device) -> torch.Tensor:
    if frame["bit_depth"] != 8 or frame["channels"] != 1:
        raise ValueError("the speckle generator makes 8-bit mono frames")
    h, w = int(frame["height"]), int(frame["width"])
    motion, pairs = mix["motion"], int(mix["pairs"])
    pad_px = pad(motion, frame, pairs)
    tex = texture.speckle(h + 2 * pad_px, w + 2 * pad_px, seed, device)
    tex = tex[None, None]
    ys = torch.arange(h, dtype=torch.float64, device=device)
    xs = torch.arange(w, dtype=torch.float64, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    out = []
    for t in range(pairs + 1):
        # Each pixel's frame-0 position X = c + F^-1 (x - c - d).
        f, d, c = mapping(motion, frame, t)
        a = np.linalg.inv(f).tolist()
        rx, ry = gx - float(c[0] + d[0]), gy - float(c[1] + d[1])
        px = a[0][0] * rx + a[0][1] * ry + float(c[0] + pad_px)
        py = a[1][0] * rx + a[1][1] * ry + float(c[1] + pad_px)
        # grid_sample's coordinates, align_corners: -1 and 1 are the
        # centres of the texture's first and last pixels.
        grid = torch.stack([px * (2.0 / (w + 2 * pad_px - 1)) - 1.0,
                            py * (2.0 / (h + 2 * pad_px - 1)) - 1.0], -1)
        img = torch.nn.functional.grid_sample(
            tex, grid[None], mode="bicubic", padding_mode="border",
            align_corners=True)[0, 0]
        out.append(torch.round(img.clamp(0.0, 255.0)).to(torch.uint8))
    return torch.stack(out)[..., None].contiguous()
