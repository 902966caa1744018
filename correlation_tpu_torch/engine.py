"""Batched coarse-to-fine Levenberg-Marquardt Gauss-Newton solver (PyTorch).

Port of correlation_tpu/engine.py for the main path: the tiled fused
assembly, reference-First Eulerian chaining.  The semantics are the JAX
engine's:
  * lambda schedule: start 1e-4, x0.4 on a converging step, x10 on a
    diverging one, clamped to [1e-9, 1e9];
  * the saved-parameter step: the next update is computed from the same
    assembly as the chi evaluation, and a diverging step reverts to the
    last-good parameters and reuses their cached A/b instead of
    assembling again;
  * delta-chi stopping |lg - chi| / (max(lg, chi) + precision);
  * per-subset error codes; an error in a level's initial assembly
    freezes the subset for the remaining levels, with its guess returned
    at level-0 scale and chi = FLT_MAX;
  * u, v scale by powers of two between pyramid levels.

Host loop instead of a device while loop.  JAX runs the LM iterations in a
lax.while_loop and shrinks the batch with a compaction cascade.  Here each
iteration takes the index list of the still-active subsets
(torch.nonzero, the one host sync per iteration) and works on exactly
those: the assembly kernel reads its subsets through that list, so nothing
is gathered for it, and the LM update touches only the listed rows.  A
subset's trajectory depends on its own state alone, so this is the same
arithmetic as the JAX loop (whose compaction is tested bit-identical to
the monolithic loop).  Capturing fixed blocks of iterations in CUDA graphs
is later work.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from correlation_tpu_torch.config import ErrorCode, SolverConfig
from correlation_tpu_torch.models.warp import translate_params, warp_points
from correlation_tpu_torch.ops import assemble_v2 as v2
from correlation_tpu_torch.ops.interp import sample_integer
from correlation_tpu_torch.ops.pyramid import build_pyramid
from correlation_tpu_torch.ops.solve import lm_delta

_FLT_MAX = float(np.finfo(np.float32).max)


class LevelArrays(NamedTuple):
    """Per-pyramid-level solver inputs for a subset batch."""

    center: torch.Tensor  # [S, 2] subset centers at this level
    n_points: torch.Tensor  # [S] float32
    pix: torch.Tensor  # [S, 8, P] packed pixel rows (v2.pack_pixels)
    bbox: torch.Tensor  # [S, 4, 2] undeformed bounding-box corners
    def_img: torch.Tensor | None  # [Hp, Wp, C] padded deformed image
    img_hw: tuple[int, int]  # true deformed-image dims


class LevelStatic(NamedTuple):
    """Per-level tile and image dims."""

    tile_h: int
    tile_w: int
    img_h: int
    img_w: int


class LevelResult(NamedTuple):
    params: torch.Tensor  # [S, NP] the saved parameters at exit
    last_good_chi: torch.Tensor  # [S]
    reached: torch.Tensor  # [S] int32 completed iterations
    error: torch.Tensor  # [S] int32 ErrorCode for this level
    init_fail: torch.Tensor  # [S] bool: the initial assembly failed


class CorrelationResult(NamedTuple):
    params: torch.Tensor  # [S, NP] at level-0 scale
    chi: torch.Tensor  # [S] last-good chi of the finest level solved
    iterations: torch.Tensor  # [S] int32
    error: torch.Tensor  # [S] int32 ErrorCode
    center: torch.Tensor  # [S, 2] undeformed centers (level 0)
    n_points: torch.Tensor  # [S] int32 level-0 point counts


def _make_assemble(cfg: SolverConfig, level: LevelArrays, static: LevelStatic):
    """assemble(params [S, NP], idx int32 [n]) -> [n, 8, 8]."""
    device = level.def_img.device
    need = {"cuda": "cuda", "torch": "cpu"}.get(cfg.backend)
    if need is not None and device.type != need:
        raise ValueError(
            f"backend {cfg.backend!r} needs {need} tensors, got {device}"
        )

    def assemble(params, idx):
        return v2.fused_assemble(
            cfg.model, cfg.interpolation, static.tile_h, static.tile_w,
            static.img_h, static.img_w, level.def_img, level.pix,
            level.center, params, level.bbox, idx,
        )

    return assemble


def _oob_code(cfg: SolverConfig, level: LevelArrays, params, rows):
    """MODEL_OUT_OF_IMAGE when a warped bounding-box corner leaves the
    image, else INTERPOLATION_OUT_OF_IMAGE, for the subsets `rows`."""
    img_h, img_w = level.img_hw
    corners = warp_points(cfg.model, params, level.bbox[rows], level.center[rows])
    x, y = corners[..., 0], corners[..., 1]
    out = (
        ~torch.isfinite(x) | ~torch.isfinite(y)
        | (x < 0.0) | (x > img_w - 1.0) | (y < 0.0) | (y > img_h - 1.0)
    )
    return torch.where(
        out.any(dim=1),
        int(ErrorCode.MODEL_OUT_OF_IMAGE),
        int(ErrorCode.INTERPOLATION_OUT_OF_IMAGE),
    ).to(torch.int32)


def _code(code: ErrorCode, like):
    return torch.full_like(like, int(code), dtype=torch.int32)


def solve_level(
    cfg: SolverConfig,
    level: LevelArrays,
    params0: torch.Tensor,
    skip: torch.Tensor,
    static: LevelStatic,
) -> LevelResult:
    """The LM loop of one pyramid level over all subsets.

    params0: [S, NP] guesses at this level's scale; skip: [S] bool, subsets
    frozen by earlier failures, left untouched (their rows of the result
    are not meaningful and are not read by correlate_prepared).
    """
    s, num_p = params0.shape
    dev = params0.device
    f32 = torch.float32
    assemble = _make_assemble(cfg, level, static)

    n_ok = level.n_points > 0
    scaling = torch.where(n_ok, 1.0 / level.n_points.clamp(min=1.0), 0.0)

    p_cur = params0.clone()
    p_lg = params0.clone()
    lam = torch.full((s,), cfg.lambda_init, dtype=f32, device=dev)
    chi_lg = torch.zeros(s, dtype=f32, device=dev)
    iteration = torch.ones(s, dtype=torch.int32, device=dev)
    reached = torch.zeros(s, dtype=torch.int32, device=dev)
    error = torch.zeros(s, dtype=torch.int32, device=dev)
    active = torch.zeros(s, dtype=torch.bool, device=dev)
    init_fail = torch.zeros(s, dtype=torch.bool, device=dev)
    ab = torch.zeros((s, 8, 8), dtype=f32, device=dev)

    # ---- initial assembly at the initial guess ---------------------------
    rows = torch.nonzero(~skip).flatten()
    if rows.numel():
        out0 = assemble(params0, rows.to(torch.int32))
        sc = scaling[rows]
        p0 = params0[rows]
        chi0 = out0[:, num_p, num_p] * sc
        interp_err = out0[:, num_p + 1, num_p + 1] > 0.0
        dp0 = lm_delta(out0[:, :num_p, :num_p], out0[:, :num_p, num_p],
                       lam[rows], sc)
        nok = n_ok[rows]
        solver0 = ~interp_err & nok & ~torch.isfinite(dp0).all(dim=-1)
        fail = interp_err | ~nok | solver0
        init_error = torch.where(
            interp_err,
            _oob_code(cfg, level, p0, rows),
            torch.where(
                ~nok,
                _code(ErrorCode.BAD_DOMAIN, rows),
                torch.where(solver0, _code(ErrorCode.SOLVER, rows),
                            _code(ErrorCode.NONE, rows)),
            ),
        )
        p_cur[rows] = torch.where(fail[:, None], p0, p0 + dp0)
        chi_lg[rows] = torch.where(fail, _FLT_MAX, chi0)
        error[rows] = init_error
        active[rows] = ~fail
        init_fail[rows] = fail
        ab[rows] = out0

    # ---- LM iterations over the still-active subsets ---------------------
    prec = cfg.precision
    for _ in range(cfg.max_iterations + 2):  # the JAX loop's step bound
        rows = torch.nonzero(active).flatten()  # the per-iteration sync
        if rows.numel() == 0:
            break
        out = assemble(p_cur, rows.to(torch.int32))
        sc = scaling[rows]
        q = p_cur[rows]
        plg = p_lg[rows]
        lam_c = lam[rows]
        lgc = chi_lg[rows]
        it = iteration[rows]

        chi = out[:, num_p, num_p] * sc
        err_now = out[:, num_p + 1, num_p + 1] > 0.0
        delta_chi = torch.abs((lgc - chi) / (torch.maximum(lgc, chi) + prec))
        converging = chi <= lgc
        lam_next = torch.where(
            converging,
            torch.clamp(lam_c * cfg.lambda_down, min=cfg.lambda_min),
            torch.clamp(lam_c * cfg.lambda_up, max=cfg.lambda_max),
        )
        ab_old = ab[rows]
        ab_sel = torch.where(converging[:, None, None], out, ab_old)
        dp = lm_delta(ab_sel[:, :num_p, :num_p], ab_sel[:, :num_p, num_p],
                      lam_next, sc)
        p_new = torch.where(converging[:, None], q, plg) + dp
        solver_now = ~err_now & ~torch.isfinite(dp).all(dim=-1)
        do_step = ~(err_now | solver_now)
        converged = delta_chi < prec
        next_iter = it + 1
        exhausted = (next_iter > cfg.max_iterations) | (lam_next >= cfg.lambda_max)
        accept = do_step & converging

        p_cur[rows] = torch.where(do_step[:, None], p_new, q)
        p_lg[rows] = torch.where(accept[:, None], q, plg)
        ab[rows] = torch.where(accept[:, None, None], out, ab_old)
        chi_lg[rows] = torch.where(accept, chi, lgc)
        lam[rows] = torch.where(do_step, lam_next, lam_c)
        iteration[rows] = torch.where(do_step, next_iter, it)
        reached[rows] = torch.where(do_step, it, reached[rows])
        active[rows] = do_step & ~(converged | exhausted)
        error[rows] = torch.where(
            err_now,
            _oob_code(cfg, level, q, rows),
            torch.where(
                solver_now,
                _code(ErrorCode.SOLVER, rows),
                torch.where(
                    do_step & exhausted & ~converged,
                    _code(ErrorCode.MAX_ITERS_REACHED, rows),
                    error[rows],
                ),
            ),
        )

    return LevelResult(p_cur, chi_lg, reached, error, init_fail)


def compute_level_statics(
    cfg: SolverConfig, subsets, def_pyramid
) -> dict[int, LevelStatic]:
    """Tile dims per level: the subset extent + halo + tile_margin, in
    multiples of 8, capped at the image dims rounded up to 8."""
    out = {}
    for lvl in cfg.pyramid.levels_coarse_to_fine():
        ext_y, ext_x = subsets.extents[lvl]
        h, w = int(def_pyramid[lvl].shape[-3]), int(def_pyramid[lvl].shape[-2])
        hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
        th, tw = v2.choose_tile(ext_y, ext_x, hp, wp, cfg.tile_margin)
        out[lvl] = LevelStatic(th, tw, h, w)
    return out


def prepare_levels(
    cfg: SolverConfig,
    und_pyramid: list,
    def_pyramid: list,
    xy_levels: list,
    mask_levels: list,
    center0: torch.Tensor,
    statics: dict[int, LevelStatic],
    skip_def: bool = False,
) -> dict[int, LevelArrays]:
    """LevelArrays for every level in the schedule: undeformed intensities
    sampled once per level, pixel rows packed for the kernel, and (unless
    skip_def) the deformed image padded to the tile dims."""
    out = {}
    for lvl in cfg.pyramid.levels_coarse_to_fine():
        xy, mask = xy_levels[lvl], mask_levels[lvl]
        st = statics[lvl]
        center = center0 / float(1 << lvl)
        und_w = sample_integer(und_pyramid[lvl], xy) * mask[..., None]
        out[lvl] = LevelArrays(
            center=center,
            n_points=mask.sum(dim=-1).to(torch.float32),
            pix=v2.pack_pixels(xy, mask, und_w, center),
            bbox=v2.subset_bbox(xy, mask),
            def_img=(
                None if skip_def
                else v2.prepare_image(def_pyramid[lvl], st.tile_h, st.tile_w)
            ),
            img_hw=(st.img_h, st.img_w),
        )
    return out


def correlate_prepared(
    cfg: SolverConfig,
    levels: dict[int, LevelArrays],
    params0: torch.Tensor,
    center0: torch.Tensor,
    n_points0: torch.Tensor,
    statics: dict[int, LevelStatic],
) -> CorrelationResult:
    """Coarse-to-fine solve given prepared per-level arrays.

    params0: [S, NP] guesses at level-0 scale.
    """
    s = params0.shape[0]
    dev = params0.device
    p = params0
    prev_level = 0
    frozen = torch.zeros(s, dtype=torch.bool, device=dev)
    final_params = torch.zeros_like(params0)
    frozen_chi = torch.zeros(s, dtype=torch.float32, device=dev)
    frozen_error = torch.zeros(s, dtype=torch.int32, device=dev)
    chi = torch.zeros(s, dtype=torch.float32, device=dev)
    reached = torch.zeros(s, dtype=torch.int32, device=dev)
    error = torch.zeros(s, dtype=torch.int32, device=dev)

    for lvl in cfg.pyramid.levels_coarse_to_fine():
        p = translate_params(p, prev_level, lvl)
        res = solve_level(cfg, levels[lvl], p, frozen, statics[lvl])
        newly = res.init_fail & ~frozen
        final_params = torch.where(
            newly[:, None], translate_params(p, lvl, 0), final_params
        )
        frozen_chi = torch.where(newly, res.last_good_chi, frozen_chi)
        frozen_error = torch.where(newly, res.error, frozen_error)
        frozen = frozen | newly
        live = ~frozen
        p = torch.where(live[:, None], res.params, p)
        chi = torch.where(live, res.last_good_chi, chi)
        reached = torch.where(live, res.reached, reached)
        error = torch.where(live, res.error, error)
        prev_level = lvl

    return CorrelationResult(
        params=torch.where(
            frozen[:, None], final_params, translate_params(p, prev_level, 0)
        ),
        chi=torch.where(frozen, frozen_chi, chi),
        iterations=reached,
        error=torch.where(frozen, frozen_error, error),
        center=center0,
        n_points=n_points0.to(torch.int32),
    )


def _as_f32(a, device):
    """A float32 tensor on `device`; numpy input is copied (it may be a
    read-only view) and moved in its own dtype, then cast on the device."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.array(a))
    return a.to(device=device).to(torch.float32)


def correlate(
    cfg: SolverConfig,
    und_pyramid,
    def_pyramid,
    subsets,
    params0,
    device=None,
) -> CorrelationResult:
    """Batched correlation of one frame pair.

    und_pyramid / def_pyramid: lists of [H_l, W_l, C] images (numpy or
    tensors; see ops.pyramid.build_pyramid).  subsets: a
    domains.SubsetBatch.  params0: [S, NP] guesses at level-0 scale.
    device: where to solve (default: the device of und_pyramid[0]).
    """
    if device is None:
        device = (und_pyramid[0].device if torch.is_tensor(und_pyramid[0])
                  else torch.device("cpu"))
    und = [_as_f32(a, device) for a in und_pyramid]
    dfm = [_as_f32(a, device) for a in def_pyramid]
    statics = compute_level_statics(cfg, subsets, dfm)
    batch = subsets.to_device(device)
    levels = prepare_levels(
        cfg, und, dfm, batch.xy, batch.mask, batch.center0, statics
    )
    return correlate_prepared(
        cfg, levels, _as_f32(params0, device), batch.center0,
        batch.mask[0].sum(dim=-1), statics,
    )


def correlate_frames(
    cfg: SolverConfig,
    frames_stack,
    subsets,
    guess0,
    *,
    reference_first: bool = True,
    stop_frame: bool = False,
    lagrangian: bool = False,
    first_chunk: bool = True,
    p_seed=None,
    prev_seed=None,
    chi_seed=None,
    it_seed=None,
    device=None,
) -> dict:
    """Chained Eulerian, reference-First solve of K frame pairs.

    frames_stack: [K+1, H, W, C] uint8 or float32 frames; element 0 is
    the undeformed reference, 1..K the deformed frames.  The stack is cast
    to float32 on `device` (default: its own device, or the CPU for numpy
    input).  Each pair's guess is the constant-velocity extrapolation
    p + (p - prev); with first_chunk the first pair starts from guess0.
    p_seed / prev_seed / chi_seed / it_seed: chained state entering the
    chunk (interop.chain_seed_from_numpy converts a JAX carry).

    Returns the stacked per-frame params, guess, chi, iterations, error
    ([K, S, ...]), the packed [K, S, NP + 3] output (params, chi,
    iterations, error), and the carry (p, prev, chi, iterations) for the
    next chunk.
    """
    if not reference_first or stop_frame or lagrangian:
        raise NotImplementedError(
            "only the Eulerian reference-First chain without STOP_FRAME "
            "is ported"
        )
    if device is None:
        device = (frames_stack.device if torch.is_tensor(frames_stack)
                  else torch.device("cpu"))
    frames = _as_f32(frames_stack, device)
    k = frames.shape[0] - 1
    pyr = build_pyramid(frames, cfg.pyramid.stop)
    statics = compute_level_statics(cfg, subsets, pyr)
    batch = subsets.to_device(device)
    s = batch.num_subsets
    schedule = cfg.pyramid.levels_coarse_to_fine()

    # Frame-invariant work leaves the frame loop: the padded deformed
    # levels of the whole stack, and the reference frame's level arrays.
    prepped = {
        lvl: v2.prepare_image(pyr[lvl], statics[lvl].tile_h,
                              statics[lvl].tile_w)
        for lvl in schedule
    }
    und0 = [level[0] for level in pyr]
    base = prepare_levels(
        cfg, und0, und0, batch.xy, batch.mask, batch.center0, statics,
        skip_def=True,
    )
    n_points0 = batch.mask[0].sum(dim=-1)

    guess0 = _as_f32(guess0, device)
    if first_chunk:
        p = guess0 if p_seed is None else _as_f32(p_seed, device)
        prev = guess0 if prev_seed is None else _as_f32(prev_seed, device)
        override = 0
    else:
        p = _as_f32(p_seed, device)
        prev = _as_f32(prev_seed, device)
        override = -1
    chi_c = (torch.zeros(s, dtype=torch.float32, device=device)
             if chi_seed is None else _as_f32(chi_seed, device))
    it_c = (torch.zeros(s, dtype=torch.int32, device=device)
            if it_seed is None
            else torch.as_tensor(it_seed, device=device).to(torch.int32))

    ys = {"params": [], "guess": [], "chi": [], "iterations": [], "error": []}
    for i in range(k):
        guess = guess0 if i == override else p + (p - prev)
        levels = {
            lvl: base[lvl]._replace(def_img=prepped[lvl][i + 1])
            for lvl in schedule
        }
        res = correlate_prepared(
            cfg, levels, guess, batch.center0, n_points0, statics
        )
        prev, p = p, res.params
        chi_c, it_c = res.chi, res.iterations
        for key, val in (("params", res.params), ("guess", guess),
                         ("chi", res.chi), ("iterations", res.iterations),
                         ("error", res.error)):
            ys[key].append(val)
    out = {key: torch.stack(val) for key, val in ys.items()}
    out["packed"] = torch.cat(
        [
            out["params"],
            out["chi"][..., None],
            out["iterations"].to(torch.float32)[..., None],
            out["error"].to(torch.float32)[..., None],
        ],
        dim=-1,
    )
    out["carry"] = (p, prev, chi_c, it_c)
    out["center0"] = batch.center0
    out["n_points0"] = n_points0.to(torch.int32)
    return out
