"""The two hand-written kernels of the solve path at a cell's own shapes,
for the roofline readers: the fused assembly (K1) and the LM step, each
on the cell's level-0 subsets of its first frame pair, at the parameters
the timed path served for that pair, built through the program's own
level preparation, and the bytes and operations their work needs,
counted from the data (dicbench.roofline)."""

from __future__ import annotations

import dataclasses

import torch

from dicbench import roofline
from dicbench.reference.solver import warp


@dataclasses.dataclass
class Level0:
    cfg: object  # the program's SolverConfig
    args: tuple  # fused_assemble's arguments before idx and count
    n_points: torch.Tensor  # [S] float32
    image_pixels: int  # deformed-image pixels the stencils touch


def level0(run) -> Level0:
    """The level-0 assembly arguments of the run's first pair."""
    from correlation_tpu_torch.domains import make_batch
    from correlation_tpu_torch.engine import (
        compute_level_statics,
        prepare_levels,
    )
    from correlation_tpu_torch.ops.pyramid import build_pyramid

    dev, cfg = run.device, run.scfg.solver
    stop = cfg.pyramid.stop
    pair = torch.as_tensor(run.inputs.frames[:2], device=dev).float()
    pyr = build_pyramid(pair, stop)
    batch = make_batch(run.inputs.points, run.inputs.centers, stop)
    statics = compute_level_statics(cfg, batch, pyr)
    gb = batch.to_device(dev)
    lv = prepare_levels(cfg, [p[0] for p in pyr], [p[1] for p in pyr],
                        gb.xy, gb.mask, gb.center0, statics)[0]
    st = statics[0]
    served = next(iter(run.outputs.distinct.values()))["params"][0]
    params = torch.as_tensor(served, dtype=torch.float32, device=dev)
    args = (cfg.model, cfg.interpolation, st.tile_h, st.tile_w, st.img_h,
            st.img_w, lv.def_img, lv.pix, lv.center, params.contiguous(),
            lv.bbox)
    # The distinct image pixels that the 4 x 4 bicubic stencils of the
    # subsets' pixels read.
    taps, halo = 4, 1
    m = gb.mask[0]
    x, y = gb.xy[0][..., 0], gb.xy[0][..., 1]
    xd, yd = warp(params, x, y, lv.center[:, 0:1], lv.center[:, 1:2])
    fx, fy = torch.floor(xd)[m].long() - halo, torch.floor(yd)[m].long() - halo
    touched = torch.zeros((st.img_h, st.img_w), dtype=torch.bool, device=dev)
    for j in range(taps):
        for k in range(taps):
            ok = ((fy + j >= 0) & (fy + j < st.img_h) & (fx + k >= 0)
                  & (fx + k < st.img_w))
            touched[(fy + j)[ok], (fx + k)[ok]] = True
    return Level0(cfg, args, lv.n_points.contiguous(),
                  int(touched.sum()))


def k1_share(run) -> float:
    """K1's share (%) of its bound: one assembly of every subset, listed
    with its length on the device, replayed from a CUDA graph with its
    inputs from HBM."""
    from correlation_tpu_torch.ops import assemble_v2 as v2

    lv = level0(run)
    head, (img, pix, center, params, bbox) = lv.args[:6], lv.args[6:]
    n = params.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=params.device)
    count = torch.tensor([n], dtype=torch.int32, device=params.device)
    ms = roofline.graph_ms_cold(
        lambda *a: v2.fused_assemble(*head, *a),
        (img, pix, center, params, bbox, idx, count))
    moved, ops = roofline.assembly_work(
        lv.cfg.model.name, lv.cfg.interpolation.name, img.shape[-1],
        int(lv.n_points.sum()), lv.image_pixels, n, params.shape[1])
    return 100.0 * roofline.bound_ms(moved, ops) / ms


def lm_step_share(run) -> float:
    """The LM-step kernel's share (%) of its bound: the loop's first
    iteration after a level's initial step on the cell's level-0 subsets,
    over the device list that the initial step wrote, with the next list
    written, replayed from a CUDA graph with its inputs from HBM."""
    from correlation_tpu_torch.ops import assemble_v2 as v2
    from correlation_tpu_torch.ops import solve

    lv = level0(run)
    cfg = lv.cfg
    head, (img, pix, center, params, bbox) = lv.args[:6], lv.args[6:]
    dev, n, num_p = params.device, params.shape[0], params.shape[1]
    img_hw = (lv.args[4], lv.args[5])
    n_points = lv.n_points
    scaling = torch.where(n_points > 0, 1.0 / n_points.clamp(min=1.0), 0.0)
    every = torch.arange(n, dtype=torch.int32, device=dev)
    whole = torch.tensor([n], dtype=torch.int32, device=dev)
    state = solve.LMState.start(cfg, params)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    out0 = v2.fused_assemble(*head, img, pix, center, state.p_cur, bbox,
                             every, whole)
    solve.lm_step(cfg, state, out0, every, whole, scaling, n_points, bbox,
                  center, img_hw, True, idx, count)
    out = v2.fused_assemble(*head, img, pix, center, state.p_cur, bbox,
                            idx, count)
    nxt = torch.empty(n, dtype=torch.int32, device=dev)
    nxt_count = torch.empty(1, dtype=torch.int32, device=dev)
    # What one step over this list moves, read from a step on a copy.
    listed = int(count)
    rows = idx[:listed].long()
    after = solve.LMState(*(x.clone() for x in state))
    solve.lm_step(cfg, after, out, idx, count, scaling, n_points, bbox,
                  center, img_hw, False, nxt.clone(), nxt_count.clone())
    o = out[:listed]
    err_now = o[:, num_p + 1, num_p + 1] > 0
    diverging = ~(o[:, num_p, num_p] * scaling[rows] <= state.chi_lg[rows])
    stepped = after.iteration[rows] != state.iteration[rows]
    moved = roofline.lm_step_bytes(
        listed, num_p, int(err_now.sum()), int(stepped.sum()),
        int((diverging | stepped).sum()), int(after.active[rows].sum()))

    def step(*c):
        solve.lm_step(cfg, solve.LMState(*c[:10]), *c[10:17], img_hw, False,
                      *c[17:])

    ms = roofline.graph_ms_cold(step, (*state, out, idx, count, scaling,
                                       n_points, bbox, center, nxt,
                                       nxt_count))
    return 100.0 * roofline.bound_ms(moved) / ms
