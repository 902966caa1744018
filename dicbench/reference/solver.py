"""The plain reference: batched coarse-to-fine Levenberg-Marquardt digital
image correlation, written from the method's description in plain
PyTorch.  It imports nothing of the program and takes nothing the
program made: it builds its own pyramids from the frames, its own
per-level point sets from the level-0 point lists, its own tiles and its
own LM state.

The method (the reference application's, which the program follows):
  * pyramid: level l + 1 is the 5 x 5 binomial window ([.05 .25 .4 .25
    .05] outer itself, float32 weights) of level l at every other pixel,
    summed exactly (float64), floored, with a zero one-pixel border;
  * level-l points: the level-0 points whose rounded coordinates are
    multiples of 2^l, scaled by 2^-l; the undeformed intensities are
    read at the rounded points;
  * warp: forward-additive AFFINE about the subset center, u and v
    scaled by 2 between levels;
  * deformed intensities and gradients by Catmull-Rom bicubic
    interpolation; a pixel counts when its warped
    position lies inside the interpolation window and its stencil inside
    the subset's tile (tile: the subsets' largest extent + 4 + the
    margin, in multiples of 8, placed at the floor of the warped bounding
    box minus halo + 1, clipped to the image); a point that does not
    count is an interpolation error;
  * the Gauss-Newton sums A = H'H, b = H'V, chi = V'V / N over the
    counted pixels (V = undeformed - deformed, H the steepest-descent
    rows);
  * LM: lambda from 1e-4, x0.4 on a step that does not raise chi, x10 on
    one that does, clamped to [1e-9, 1e9]; the damped system (A / N with
    its diagonal times 1 + lambda) solved by Cholesky; a step that raises
    chi goes back to the last good parameters and their cached sums;
    stop on |lg - chi| / (max(lg, chi) + precision) < precision, on
    max_iterations, on lambda at its cap, or on an error; an error in a
    level's first assembly freezes the subset for the finer levels with
    its guess and chi = FLT_MAX.

`dtype` is the precision of everything; `pixel_dtype`, where given, that
of the assembly's pixel arithmetic (intensities, taps, gradients,
residuals, the Gram's products and sums) while positions and the LM
update stay in `dtype`: the control computes so in bfloat16.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

FLT_MAX = float(np.finfo(np.float32).max)
# Error codes (the reference application's).
NONE, MODEL_OUT, INTERP_OUT, MAX_ITERS, BAD_DOMAIN, SOLVER = 0, 1, 2, 3, 4, 5
_BINOMIAL = np.array([0.05, 0.25, 0.4, 0.25, 0.05], np.float32)


@dataclasses.dataclass(frozen=True)
class Settings:
    """The solver settings of a configuration file's "solver" group."""

    model: str = "AFFINE"
    interpolation: str = "BICUBIC"
    levels: tuple = (0, 1, 2)  # every level solved, any order
    max_iterations: int = 50
    precision: float = 1e-3
    lambda_init: float = 1e-4
    lambda_min: float = 1e-9
    lambda_max: float = 1e9
    lambda_up: float = 10.0
    lambda_down: float = 0.4
    tile_margin: int = 8

    @classmethod
    def of(cls, solver: dict) -> "Settings":
        keys = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in solver.items() if k in keys}
        if "pyramid" in solver:
            kw["levels"] = tuple(solver["pyramid"])
        st = cls(**kw)
        if (st.model, st.interpolation) != ("AFFINE", "BICUBIC"):
            raise ValueError("the reference solves AFFINE / BICUBIC only, "
                             f"not {st.model} / {st.interpolation}")
        return st

    @property
    def num_params(self) -> int:
        return 6

    @property
    def coarse_to_fine(self) -> list[int]:
        return sorted(self.levels, reverse=True)


def pyramid(frame: torch.Tensor, top: int) -> list[torch.Tensor]:
    """Levels 0..top of a [H, W, C] uint8 (or integer-valued) frame, each
    [H_l, W_l, C] float64."""
    k2 = torch.as_tensor(np.outer(_BINOMIAL, _BINOMIAL).astype(np.float32),
                         dtype=torch.float64, device=frame.device)
    levels = [frame.to(torch.float64)]
    for _ in range(top):
        src = levels[-1]
        h, w = src.shape[0] // 2, src.shape[1] // 2
        out = torch.zeros((h, w, src.shape[2]), dtype=torch.float64,
                          device=src.device)
        if h >= 3 and w >= 3:
            acc = torch.zeros_like(out[1:h - 1, 1:w - 1])
            for dy in range(5):
                for dx in range(5):
                    acc += src[dy:dy + 2 * (h - 2):2,
                               dx:dx + 2 * (w - 2):2] * k2[dy, dx]
            out[1:h - 1, 1:w - 1] = torch.floor(acc)
        levels.append(out)
    return levels


def warp(p: torch.Tensor, x, y, cx, cy):
    """AFFINE-warped (x', y') of points (x, y) [S, P] about centers
    (cx, cy) [S, 1] under parameters p [S, 6] = (u, v, ux, uy, vx, vy)."""
    dx, dy = x - cx, y - cy
    u, v, ux, uy, vx, vy = (p[:, i:i + 1] for i in range(6))
    return x + u + ux * dx + uy * dy, y + v + vx * dx + vy * dy


def _taps(t):
    """Catmull-Rom weights and their derivatives at offsets -1, 0, 1, 2
    from floor(x), for the fraction t."""
    t2, t3 = t * t, t * t * t
    k = ((-t3 + 2 * t2 - t) / 2, (3 * t3 - 5 * t2 + 2) / 2,
         (-3 * t3 + 4 * t2 + t) / 2, (t3 - t2) / 2)
    dk = ((-3 * t2 + 4 * t - 1) / 2, (9 * t2 - 10 * t) / 2,
          (-9 * t2 + 8 * t + 1) / 2, (3 * t2 - 2 * t) / 2)
    return k, dk


@dataclasses.dataclass
class Level:
    """One pyramid level of the subsets, padded to the longest list."""

    x: torch.Tensor  # [S, P] undeformed positions
    y: torch.Tensor
    mask: torch.Tensor  # [S, P] bool
    und: torch.Tensor  # [S, P, C] undeformed intensities
    cx: torch.Tensor  # [S, 1] centers at this level
    cy: torch.Tensor
    n: torch.Tensor  # [S] points
    bbox: tuple  # (x min, x max, y min, y max), each [S, 1]
    tile: tuple  # (tile_h, tile_w)


def level_points(points: list[np.ndarray], level: int):
    """Per-subset level-`level` points: those whose rounded coordinates
    are multiples of 2^level, scaled by 2^-level."""
    mag = 1 << level
    out = []
    for p in points:
        p = np.asarray(p, np.float64).reshape(-1, 2)
        r = np.floor(p + 0.5).astype(np.int64)
        keep = (r[:, 0] % mag == 0) & (r[:, 1] % mag == 0)
        out.append(p[keep] / mag)
    return out


def make_level(und_img: torch.Tensor, points: list[np.ndarray],
               centers0: np.ndarray, level: int, margin: int,
               dtype) -> Level:
    """The level-`level` arrays of the subsets over the undeformed level
    image und_img [H_l, W_l, C]."""
    dev = und_img.device
    pts = level_points(points, level)
    s, p_max = len(pts), max(1, max(len(p) for p in pts))
    xy = np.zeros((s, p_max, 2))
    mask = np.zeros((s, p_max), bool)
    for i, p in enumerate(pts):
        xy[i, :len(p)] = p
        mask[i, :len(p)] = True
    ext = [0, 0]  # the largest extent (x, y) of any subset, rounded up
    for p in pts:
        if len(p):
            span = p.max(axis=0) - p.min(axis=0)
            ext = [max(ext[0], int(np.ceil(span[0]))),
                   max(ext[1], int(np.ceil(span[1])))]
    h, w = und_img.shape[0], und_img.shape[1]
    tile = tuple(min(-(-(e + 4 + margin) // 8) * 8, -(-d // 8) * 8)
                 for e, d in ((ext[1], h), (ext[0], w)))
    t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=dev)  # noqa
    x, y, m = t(xy[..., 0]), t(xy[..., 1]), t(mask, torch.bool)
    ix = torch.clamp(torch.floor(x + 0.5), 0, w - 1).long()
    iy = torch.clamp(torch.floor(y + 0.5), 0, h - 1).long()
    und = und_img[iy, ix].to(dtype) * m[..., None]
    big = 1e9
    bbox = (torch.where(m, x, big).amin(1, keepdim=True),
            torch.where(m, x, -big).amax(1, keepdim=True),
            torch.where(m, y, big).amin(1, keepdim=True),
            torch.where(m, y, -big).amax(1, keepdim=True))
    c = t(np.asarray(centers0, np.float64) / (1 << level))
    return Level(x, y, m, und, c[:, 0:1], c[:, 1:2],
                 m.sum(1).to(dtype), bbox, tile)


def _corners(p, lv: Level, rows):
    x0, x1, y0, y1 = (b[rows] for b in lv.bbox)
    xs = torch.cat([x0, x0, x1, x1], 1)
    ys = torch.cat([y0, y1, y0, y1], 1)
    return warp(p, xs, ys, lv.cx[rows], lv.cy[rows])


def assemble(st: Settings, lv: Level, img: torch.Tensor, p: torch.Tensor,
             rows: torch.Tensor, pixel_dtype=None):
    """Gauss-Newton sums of the subsets `rows` at parameters p [n, NP]
    over the deformed level image img [H_l, W_l, C]: (A [n, NP, NP],
    b [n, NP], chi sum [n], points not counted [n])."""
    pdt = pixel_dtype or p.dtype
    h, w, chans = img.shape
    x, y, m = lv.x[rows], lv.y[rows], lv.mask[rows]
    cx, cy = lv.cx[rows], lv.cy[rows]
    xd, yd = warp(p, x, y, cx, cy)
    taps, halo = 4, 1
    valid = (xd > 1) & (yd > 1) & (xd < w - 2) & (yd < h - 2)
    fx, fy = torch.floor(xd), torch.floor(yd)
    # The subset's tile, from its warped bounding box.
    th, tw = lv.tile
    hp, wp = max(h, th), max(w, tw)
    cxs, cys = _corners(p, lv, rows)
    finite = (torch.isfinite(cxs) & torch.isfinite(cys)).all(1, keepdim=True)
    ox = torch.where(finite, torch.floor(cxs.amin(1, keepdim=True)) - halo - 1,
                     0.0).clamp(0, max(wp - tw, 0))
    oy = torch.where(finite, torch.floor(cys.amin(1, keepdim=True)) - halo - 1,
                     0.0).clamp(0, max(hp - th, 0))
    rx, ry = fx - halo - ox, fy - halo - oy
    in_tile = (rx >= 0) & (rx <= tw - taps) & (ry >= 0) & (ry <= th - taps)
    live = m & valid & in_tile
    bad = (m & ~live).sum(1)
    # Interpolation at the counted pixels (others read a clamped pixel and
    # are zeroed).
    kx, dkx = _taps((xd - fx).to(pdt))
    ky, dky = _taps((yd - fy).to(pdt))
    bx = torch.where(live, fx - halo, 0).long()
    by = torch.where(live, fy - halo, 0).long()
    img_p = img.to(pdt)
    livef = live.to(pdt)
    dx, dy = (x - cx).to(pdt), (y - cy).to(pdt)
    a_sum = b_sum = chi = None
    for c in range(chans):
        val = gx = gy = 0
        for j in range(taps):
            row = drow = 0
            for k in range(taps):
                pix = img_p[(by + j).clamp(0, h - 1), (bx + k).clamp(0, w - 1),
                            c]
                row = row + kx[k] * pix
                drow = drow + dkx[k] * pix
            val = val + ky[j] * row
            gx = gx + ky[j] * drow
            gy = gy + dky[j] * row
        v = (lv.und[rows][..., c].to(pdt) - val) * livef
        gx, gy = gx * livef, gy * livef
        hrows = torch.stack([gx, gy, gx * dx, gx * dy, gy * dx, gy * dy],
                            -1)  # [n, P, 6], the steepest-descent rows
        a_c = torch.einsum("spi,spj->sij", hrows, hrows)
        b_c = torch.einsum("spi,sp->si", hrows, v)
        chi_c = (v * v).sum(1)
        a_sum = a_c if a_sum is None else a_sum + a_c
        b_sum = b_c if b_sum is None else b_sum + b_c
        chi = chi_c if chi is None else chi + chi_c
    dt = p.dtype
    return a_sum.to(dt), b_sum.to(dt), chi.to(dt), bad.to(dt)


def damped_step(a, b, lam, scale):
    """Solve (scale A, diagonal times 1 + lam) dp = scale b by Cholesky;
    rows whose system is not positive definite come out NaN."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=a.device)
    sys_ = a * scale[:, None, None]
    sys_ = torch.where(eye, sys_ * (1 + lam)[:, None, None], sys_)
    chol, info = torch.linalg.cholesky_ex(sys_)
    ok = (info == 0) & torch.isfinite(sys_).flatten(1).all(1)
    chol = torch.where(ok[:, None, None], chol,
                       torch.eye(n, dtype=a.dtype, device=a.device))
    dp = torch.cholesky_solve((b * scale[:, None])[..., None], chol)[..., 0]
    return torch.where(ok[:, None], dp, float("nan"))


def _oob(p, lv, rows, h, w):
    xs, ys = _corners(p, lv, rows)
    out = (~torch.isfinite(xs) | ~torch.isfinite(ys) | (xs < 0) | (ys < 0)
           | (xs > w - 1) | (ys > h - 1)).any(1)
    return torch.where(out, MODEL_OUT, INTERP_OUT)


def solve_level(st: Settings, lv: Level, img: torch.Tensor, p0: torch.Tensor,
                skip: torch.Tensor, pixel_dtype=None) -> dict:
    """The LM loop of one level over every subset not skipped: the
    parameters after the last step, the last good chi, completed
    iterations, error codes and whether the first assembly failed."""
    s, dev, dt = p0.shape[0], p0.device, p0.dtype
    h, w = img.shape[0], img.shape[1]
    scale = torch.where(lv.n > 0, 1.0 / lv.n.clamp(min=1), 0.0)
    p_cur, p_lg = p0.clone(), p0.clone()
    lam = torch.full((s,), st.lambda_init, dtype=dt, device=dev)
    chi_lg = torch.zeros(s, dtype=dt, device=dev)
    it = torch.ones(s, dtype=torch.int64, device=dev)
    reached = torch.zeros(s, dtype=torch.int64, device=dev)
    error = torch.zeros(s, dtype=torch.int64, device=dev)
    init_fail = torch.zeros(s, dtype=torch.bool, device=dev)
    active = torch.zeros(s, dtype=torch.bool, device=dev)
    a_lg = torch.zeros((s, st.num_params, st.num_params), dtype=dt, device=dev)
    b_lg = torch.zeros((s, st.num_params), dtype=dt, device=dev)

    rows = torch.nonzero(~skip).flatten()
    if rows.numel():
        q, sc = p_cur[rows], scale[rows]
        a, b, chi_raw, bad = assemble(st, lv, img, q, rows, pixel_dtype)
        dp = damped_step(a, b, lam[rows], sc)
        ierr, nok = bad > 0, lv.n[rows] > 0
        solver0 = ~ierr & nok & ~torch.isfinite(dp).all(1)
        fail = ierr | ~nok | solver0
        error[rows] = torch.where(
            ierr, _oob(q, lv, rows, h, w),
            torch.where(~nok, BAD_DOMAIN, torch.where(solver0, SOLVER, NONE)))
        p_cur[rows] = torch.where(fail[:, None], q, q + dp)
        chi_lg[rows] = torch.where(fail, FLT_MAX, chi_raw * sc)
        active[rows], init_fail[rows] = ~fail, fail
        a_lg[rows], b_lg[rows] = a, b

    for _ in range(st.max_iterations + 2):
        rows = torch.nonzero(active).flatten()
        if rows.numel() == 0:
            break
        q, plg, sc = p_cur[rows], p_lg[rows], scale[rows]
        lgc, lam_c, it_c = chi_lg[rows], lam[rows], it[rows]
        a, b, chi_raw, bad = assemble(st, lv, img, q, rows, pixel_dtype)
        chi = chi_raw * sc
        ierr = bad > 0
        dchi = torch.abs((lgc - chi) / (torch.maximum(lgc, chi)
                                        + st.precision))
        conv = chi <= lgc
        lam_n = torch.where(conv, (lam_c * st.lambda_down).clamp(
            min=st.lambda_min), (lam_c * st.lambda_up).clamp(
            max=st.lambda_max))
        a_sel = torch.where(conv[:, None, None], a, a_lg[rows])
        b_sel = torch.where(conv[:, None], b, b_lg[rows])
        dp = damped_step(a_sel, b_sel, lam_n, sc)
        p_new = torch.where(conv[:, None], q, plg) + dp
        solver_now = ~ierr & ~torch.isfinite(dp).all(1)
        step = ~(ierr | solver_now)
        done = dchi < st.precision
        exhausted = (it_c + 1 > st.max_iterations) | (lam_n >= st.lambda_max)
        accept = step & conv
        p_cur[rows] = torch.where(step[:, None], p_new, q)
        p_lg[rows] = torch.where(accept[:, None], q, plg)
        a_lg[rows] = torch.where(accept[:, None, None], a, a_lg[rows])
        b_lg[rows] = torch.where(accept[:, None], b, b_lg[rows])
        chi_lg[rows] = torch.where(accept, chi, lgc)
        lam[rows] = torch.where(step, lam_n, lam_c)
        it[rows] = torch.where(step, it_c + 1, it_c)
        reached[rows] = torch.where(step, it_c, reached[rows])
        active[rows] = step & ~(done | exhausted)
        error[rows] = torch.where(
            ierr, _oob(q, lv, rows, h, w),
            torch.where(solver_now, SOLVER,
                        torch.where(step & exhausted & ~done, MAX_ITERS,
                                    error[rows])))
    return dict(params=p_cur, chi=chi_lg, reached=reached, error=error,
                init_fail=init_fail)


def _rescale(p: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """u and v from level `src` to level `dst` (2^(src - dst))."""
    if src == dst:
        return p
    p = p.clone()
    p[:, :2] *= 2.0 ** (src - dst)
    return p


class PairSolver:
    """Solves frame pairs of one sequence: the undeformed frame's levels
    are built once a frame, the deformed one's a pair."""

    def __init__(self, st: Settings, points, centers0, device,
                 dtype=torch.float64, pixel_dtype=None):
        self.st, self.points, self.dev = st, points, device
        self.dtype, self.pixel_dtype = dtype, pixel_dtype
        if centers0 is None:
            centers0 = np.array([np.asarray(p, np.float64).mean(0)
                                 for p in points])
        self.centers0 = np.asarray(centers0, np.float64)
        self._und = (None, None)

    def levels_of(self, frame):
        return pyramid(torch.as_tensor(frame, device=self.dev),
                       max(self.st.levels))

    def solve(self, und_key, und_frame, def_frame, guess):
        """Coarse to fine over one pair: (params [S, NP] at level 0, chi,
        iterations, error), every one a tensor."""
        st = self.st
        if self._und[0] != und_key:
            pyr = self.levels_of(und_frame)
            lvls = {lvl: make_level(pyr[lvl], self.points, self.centers0,
                                    lvl, st.tile_margin, self.dtype)
                    for lvl in st.levels}
            self._und = (und_key, lvls)
        lvls = self._und[1]
        dpyr = self.levels_of(def_frame)
        s = len(self.points)
        dev, dt = self.dev, self.dtype
        p = torch.as_tensor(guess, dtype=dt, device=dev).clone()
        frozen = torch.zeros(s, dtype=torch.bool, device=dev)
        fin_p = torch.zeros_like(p)
        fin_chi = torch.zeros(s, dtype=dt, device=dev)
        fin_err = torch.zeros(s, dtype=torch.int64, device=dev)
        chi = torch.zeros(s, dtype=dt, device=dev)
        reached = torch.zeros(s, dtype=torch.int64, device=dev)
        error = torch.zeros(s, dtype=torch.int64, device=dev)
        prev = 0
        for lvl in st.coarse_to_fine:
            p = _rescale(p, prev, lvl)
            res = solve_level(st, lvls[lvl], dpyr[lvl].to(dt), p, frozen,
                              self.pixel_dtype)
            newly = res["init_fail"] & ~frozen
            fin_p = torch.where(newly[:, None], _rescale(p, lvl, 0), fin_p)
            fin_chi = torch.where(newly, res["chi"], fin_chi)
            fin_err = torch.where(newly, res["error"], fin_err)
            frozen = frozen | newly
            live = ~frozen
            p = torch.where(live[:, None], res["params"], p)
            chi = torch.where(live, res["chi"], chi)
            reached = torch.where(live, res["reached"], reached)
            error = torch.where(live, res["error"], error)
            prev = lvl
        return (torch.where(frozen[:, None], fin_p, _rescale(p, prev, 0)),
                torch.where(frozen, fin_chi, chi), reached,
                torch.where(frozen, fin_err, error))
