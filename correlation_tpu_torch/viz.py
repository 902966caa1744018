"""Headless visualisation (port of correlation_tpu/viz.py).

  * rect_outline / annular_sector_outline / annulus_outlines: per-sector
    domain outlines as dense polylines;
  * preview_warp: an outline warped under the current parameters about
    the domain center;
  * render_overlay: polylines, crosses and dots drawn onto a frame (PIL,
    imported on use);
  * save_sequence_overlays: one annotated PNG per frame pair.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

from correlation_tpu_torch.config import FittingModel
from correlation_tpu_torch.models.warp import warp_points


def rect_outline(x0: float, y0: float, x1: float, y1: float,
                 points_per_edge: int = 16) -> np.ndarray:
    """Closed rectangle outline as a dense polyline [N, 2] (dense, so that
    non-rigid warps curve the edges in previews)."""
    t = np.linspace(0.0, 1.0, points_per_edge, endpoint=False)
    top = np.stack([x0 + (x1 - x0) * t, np.full_like(t, y0)], -1)
    right = np.stack([np.full_like(t, x1), y0 + (y1 - y0) * t], -1)
    bottom = np.stack([x1 - (x1 - x0) * t, np.full_like(t, y1)], -1)
    left = np.stack([np.full_like(t, x0), y1 - (y1 - y0) * t], -1)
    out = np.concatenate([top, right, bottom, left, top[:1]], 0)
    return out.astype(np.float32)


def annular_sector_outline(
    cx: float,
    cy: float,
    r_in: float,
    r_out: float,
    a0: float,
    a1: float,
    points_per_arc: int = 24,
) -> np.ndarray:
    """Closed outline polyline [N, 2] of one annular sector."""
    ang = np.linspace(a0, a1, points_per_arc)
    inner = np.stack([cx + r_in * np.cos(ang), cy + r_in * np.sin(ang)], -1)
    outer = np.stack(
        [cx + r_out * np.cos(ang[::-1]), cy + r_out * np.sin(ang[::-1])], -1
    )
    out = np.concatenate([inner, outer, inner[:1]], 0)
    return out.astype(np.float32)


def annulus_outlines(cx, cy, r_in, r_out, radial_subdivisions=1,
                     angular_subdivisions=1) -> list[np.ndarray]:
    """Per-sector outlines of a subdivided annulus, radial rings outer
    loop, angular sectors inner."""
    outs = []
    dr = (r_out - r_in) / radial_subdivisions
    da = 2.0 * math.pi / angular_subdivisions
    for ri in range(radial_subdivisions):
        for ai in range(angular_subdivisions):
            outs.append(
                annular_sector_outline(
                    cx, cy, r_in + ri * dr, r_in + (ri + 1) * dr,
                    ai * da, (ai + 1) * da,
                )
            )
    return outs


def preview_warp(
    model: FittingModel,
    params: np.ndarray,
    outline: np.ndarray,
    center: np.ndarray,
) -> np.ndarray:
    """An outline polyline [N, 2] warped under `params` [NP] about
    `center` [2] (on CPU tensors)."""

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    return warp_points(model, t(params), t(outline), t(center)).numpy()


def _to_rgb(frame: np.ndarray) -> np.ndarray:
    img = np.asarray(frame)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    return img


def render_overlay(
    frame: np.ndarray,
    polylines: list[np.ndarray] | None = None,
    points: np.ndarray | None = None,
    line_color=(0, 255, 0),
    point_color=(255, 64, 64),
    dots: np.ndarray | None = None,
    dot_color=(64, 128, 255),
):
    """Draw polylines, cross markers and single-pixel dots onto a frame.

    frame: [H, W] or [H, W, C] uint8-valued; polylines: [N, 2] (x, y)
    each; points: [M, 2] cross positions; dots: [M, 2] dense markers (the
    warped subset pixels), written straight into the bitmap.  Returns a
    PIL.Image in RGB.
    """
    from PIL import Image, ImageDraw

    rgb = _to_rgb(frame).copy()
    if dots is not None and len(dots):
        d = np.floor(np.asarray(dots, np.float64) + 0.5).astype(np.int64)
        h, w = rgb.shape[:2]
        keep = (
            (d[:, 0] >= 0) & (d[:, 0] < w) & (d[:, 1] >= 0) & (d[:, 1] < h)
        )
        d = d[keep]
        rgb[d[:, 1], d[:, 0]] = np.asarray(dot_color, np.uint8)
    img = Image.fromarray(rgb)
    draw = ImageDraw.Draw(img)
    for line in polylines or []:
        pts = [(float(x), float(y)) for x, y in np.asarray(line)]
        if len(pts) >= 2:
            draw.line(pts, fill=line_color, width=1)
    if points is not None:
        for x, y in np.asarray(points):
            x, y = float(x), float(y)
            draw.line([(x - 2, y), (x + 2, y)], fill=point_color, width=1)
            draw.line([(x, y - 2), (x, y + 2)], fill=point_color, width=1)
    return img


def save_sequence_overlays(
    frames,
    records,
    out_dir: str,
    prefix: str = "overlay",
    point_lists: list[np.ndarray] | None = None,
    model=None,
    eulerian: bool = True,
) -> list[str]:
    """Write one annotated PNG per frame pair and return their paths.

    `<prefix>_und.png` is frame 0 with the undeformed contours and
    centers; `<prefix>_<frame + 1:05d>.png` is each pair's deformed frame
    with the tracked deformed contours and centers.

    point_lists + model: each overlay also shows subset pixels as dots:
    the undeformed ones on frame 0, the warped ones
    (sequence.warped_inside_points) on each pair; without `model`, none.
    A record's own und_points (SequenceConfig.record_points) come first.
    Without them, an Eulerian run (`eulerian`) warps the frame-0
    point_lists, which stay put; any other description moves the points
    every frame, so such a record gets no dots, and a warning on stderr
    says how many.
    """
    from correlation_tpu_torch.sequence import warped_inside_points

    os.makedirs(out_dir, exist_ok=True)
    written = []
    if records:
        rec0 = records[0]
        path = os.path.join(out_dir, f"{prefix}_und.png")
        lists0 = rec0.und_points if rec0.und_points is not None else point_lists
        und_dots = (
            np.concatenate(lists0, axis=0)
            if lists0 is not None and model is not None else None
        )
        render_overlay(
            frames[0], rec0.und_contours, rec0.und_center, dots=und_dots
        ).save(path)
        written.append(path)
    undrawn = 0
    for rec in records:
        img = frames[rec.frame + 1]
        path = os.path.join(out_dir, f"{prefix}_{rec.frame + 1:05d}.png")
        dots = None
        lists = rec.und_points
        if lists is None and eulerian:
            lists = point_lists
        if lists is not None and model is not None:
            warped = warped_inside_points(
                model, rec.params, lists, rec.und_center
            )
            dots = np.concatenate(warped, axis=0)
        elif model is not None and not eulerian:
            undrawn += 1
        render_overlay(
            img, rec.def_contours, rec.def_center, dots=dots
        ).save(path)
        written.append(path)
    if undrawn:
        print(f"warning: {undrawn} overlay(s) drawn without subset points: "
              "their records carry no per-frame point lists, and the "
              "frame-0 lists are wrong once the domain follows the "
              "material (run with record_points to draw them)",
              file=sys.stderr)
    return written
