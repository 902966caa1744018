"""Lagrangian description, reference Previous: pair i solves frame i
against frame i + 1 on the domain moved with the material, from the
previous pair's result (zero for the first pair).

The method (the reference application's adjust_*_domain,
manager_class.cpp:2018-2310, and its GPU updatePolygon,
cuda_polygon.cu:268-340, as this repository's survey describes them):
before every pair but the first, each subset's points are translated by
its (u, v) rounded to whole pixels, floor(u + 0.5), and its centre is
shifted by the (u, v) itself; the previous frame is the reference.

Departures, each the rule of the program's chained solve
(correlate_frames), against which this chain was checked:
  * the rounded translations add up: off, the sum of the pairs' rounded
    (u, v), moves the frame-0 points, and the level-l points are the
    frame-0 level-l points moved by floor(off / 2^l + 0.5) level-l
    pixels, not the moved level-0 points decimated anew.  The
    application keeps a point set a level and translates each; the
    survey does not say how it rounds at the coarser levels;
  * a centre always shifts by the float (u, v), also where the centres
    are the point means, which the program moves by off instead.  The
    grid domain gives explicit centres, where the two rules agree.
Each moved point set gets a PairSolver of its own, whose undeformed
levels are the frame-0 levels (solver.make_level) moved whole: positions
and bounding boxes shifted, intensities read anew from the pair's
reference frame at the moved points, as make_level reads them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dicbench.reference.solver import Level, PairSolver, make_level


def _moved(base: Level, und_img: torch.Tensor, shift: torch.Tensor,
           centers: torch.Tensor) -> Level:
    """The level `base` with every subset's points moved by its whole
    level pixels shift [S, 2], its centres `centers` [S, 2] (this level's
    scale) and its intensities read from und_img [H_l, W_l, C]."""
    dx, dy = shift[:, 0:1], shift[:, 1:2]
    x, y = base.x + dx, base.y + dy
    h, w = und_img.shape[0], und_img.shape[1]
    ix = torch.clamp(torch.floor(x + 0.5), 0, w - 1).long()
    iy = torch.clamp(torch.floor(y + 0.5), 0, h - 1).long()
    und = und_img[iy, ix].to(x.dtype) * base.mask[..., None]
    x0, x1, y0, y1 = base.bbox
    return dataclasses.replace(
        base, x=x, y=y, und=und, cx=centers[:, 0:1], cy=centers[:, 1:2],
        bbox=(x0 + dx, x1 + dx, y0 + dy, y1 + dy))


def run(solver, frames, pairs: int, num_params: int) -> dict:
    st, dev, dt = solver.st, solver.dev, solver.dtype
    s = len(solver.points)
    pyr0 = solver.levels_of(frames[0])
    base = {lvl: make_level(pyr0[lvl], solver.points, solver.centers0, lvl,
                            st.tile_margin, dt) for lvl in st.levels}
    off = torch.zeros((s, 2), dtype=dt, device=dev)
    centers = torch.as_tensor(solver.centers0, dtype=dt, device=dev)
    p = torch.zeros((s, num_params), dtype=dt, device=dev)
    out = {k: [] for k in ("params", "chi", "iterations", "error")}
    for i in range(pairs):
        if i > 0:
            uv = p[:, :2]
            off = off + torch.floor(uv + 0.5)
            centers = centers + uv
        moved = off.cpu().numpy()
        pair = PairSolver(st, [q + o for q, o in zip(solver.points, moved)],
                          centers.cpu().numpy(), dev, dt, solver.pixel_dtype)
        und = pair.levels_of(frames[i])
        pair._und = (i, {
            lvl: _moved(base[lvl], und[lvl].to(dt),
                        torch.floor(off / float(1 << lvl) + 0.5),
                        centers / float(1 << lvl))
            for lvl in st.levels})
        res = pair.solve(i, frames[i], frames[i + 1], p)
        p = res[0]
        for key, val in zip(out, res):
            out[key].append(val.cpu().numpy())
    return {k: np.stack(v) for k, v in out.items()}
