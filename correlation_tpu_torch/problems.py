"""The dense-grid problem that bench.py measures, rebuilt with NumPy, and
a drifting sequence of the same texture.

A 1024x1024 uint8-valued speckle (blurred uniform noise from seed 0), the
deformed frame the same texture shifted by one row (true warp u = 0,
v = +1), and a dense grid of 21x21-pixel subsets, solved AFFINE/BICUBIC
over pyramid levels 2-1-0 at the reference's stopping rule (max 50
iterations, precision 1e-3).  Arrays equal bench.build_problem's
(tests/test_torch_domains.py).  sequence_problem moves the texture down
one row a frame over a sequence of frame pairs; annular_problem and
blob_problem track an annulus of sectors and one freehand blob on the
same frames.
"""

from __future__ import annotations

import numpy as np

from correlation_tpu_torch.config import (
    FittingModel,
    Interpolation,
    PyramidConfig,
    SolverConfig,
)
from correlation_tpu_torch.domains import (
    AnnularDomain,
    BlobDomain,
    SubsetBatch,
    annular_batch,
    blob_batch,
    make_batch,
)


def _noise_base(h: int, w: int, seed: int, extra_top: int) -> np.ndarray:
    """Uniform noise from `seed`, box-blurred 5 wide along both axes: the
    (h + 8) x (w + 8) block drawn first, then `extra_top` rows drawn after
    it and stacked above it, nearest row first."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h + 8, w + 8))
    if extra_top:
        above = rng.uniform(0, 255, (extra_top, w + 8))
        base = np.concatenate([above[::-1], base])
    k = np.ones(5) / 5.0
    base = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 0, base)
    return np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, base)


def speckle_frames(
    h: int, w: int, seed: int, row_shifts, max_shift: int = 4
) -> np.ndarray:
    """[len(row_shifts), h, w] float32 uint8-valued speckle: uniform noise
    from `seed`, box-blurred 5 wide along both axes, scaled by 2 modulo
    255, floored.  Frame i is the texture moved down by row_shifts[i] rows
    (0 <= shift <= max_shift).  Frames made with one max_shift share one
    texture; up to max_shift = 4 it is bench.build_problem's."""
    for t in row_shifts:
        if not 0 <= t <= max_shift:
            raise ValueError(f"row_shift {t} outside [0, {max_shift}]")
    extra = max(max_shift - 4, 0)
    base = _noise_base(h, w, seed, extra)
    return np.stack([
        np.floor(base[y0 : y0 + h, 4 : w + 4] * 2.0 % 255.0)
        for y0 in (extra + 4 - t for t in row_shifts)
    ]).astype(np.float32)


def speckle(
    h: int, w: int, seed: int, row_shift: int = 0, max_shift: int = 4
) -> np.ndarray:
    """[h, w] float32: the one frame of speckle_frames moved down by
    row_shift rows."""
    return speckle_frames(h, w, seed, [row_shift], max_shift)[0]


def drifting_sequence(num_pairs: int, img_hw: int = 1024,
                      seed: int = 0) -> np.ndarray:
    """[num_pairs + 1, H, W, 1] uint8 frames: frame t is the speckle moved
    down by t rows, so the true motion is (u, v) = (0, t) against frame 0
    and (0, 1) between neighbouring frames."""
    return speckle_frames(img_hw, img_hw, seed, range(num_pairs + 1),
                          max_shift=num_pairs)[..., None].astype(np.uint8)


def _grid(num_subsets: int, img_hw: int, half: int, room: int = 0):
    """Square subsets of side 2 half + 1 on a dense grid, 4 half from the
    image edges and `room` rows more from the bottom edge: (point lists,
    centers [S, 2])."""
    side = int(np.ceil(np.sqrt(num_subsets)))
    margin = 4 * half
    xs = np.linspace(margin, img_hw - margin, side)
    ys = np.linspace(margin, img_hw - margin - room, side)
    centers = [(int(cx), int(cy)) for cy in ys for cx in xs][:num_subsets]
    pts = []
    for cx, cy in centers:
        gx, gy = np.meshgrid(
            np.arange(cx - half, cx + half + 1),
            np.arange(cy - half, cy + half + 1),
            indexing="ij",
        )
        pts.append(np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32))
    return pts, np.array(centers, np.float32)


def _solver(stop: int) -> SolverConfig:
    return SolverConfig(
        model=FittingModel.AFFINE,
        interpolation=Interpolation.BICUBIC,
        pyramid=PyramidConfig(0, 1, stop),
        max_iterations=50,
        precision=1e-3,
    )


def dense_grid_problem(
    num_subsets: int = 4096, img_hw: int = 1024, half: int = 10,
    stop: int = 2,
) -> tuple[SolverConfig, np.ndarray, np.ndarray, SubsetBatch, np.ndarray]:
    """Returns (cfg, und [H, W] float32, dfm [H, W] float32, batch,
    params0 [S, 6] zeros)."""
    und = speckle(img_hw, img_hw, 0)
    dfm = speckle(img_hw, img_hw, 0, row_shift=1)
    cfg = _solver(stop)
    pts, centers = _grid(num_subsets, img_hw, half)
    batch = make_batch(pts, centers, stop)
    params0 = np.zeros((num_subsets, cfg.num_params), np.float32)
    return cfg, und, dfm, batch, params0


def sequence_problem(
    num_subsets: int = 4096, num_pairs: int = 32, img_hw: int = 1024,
    half: int = 10, stop: int = 2,
) -> tuple[SolverConfig, np.ndarray, list[np.ndarray], np.ndarray]:
    """The sequence shape of the JAX package's BENCH_SEQ_r05.json record
    (4096 21x21 subsets, 32 pairs of 1024x1024 frames, AFFINE / BICUBIC,
    levels 2-1-0) on drifting_sequence frames.  The grid leaves num_pairs
    more rows at the bottom than dense_grid_problem, so that the subsets
    stay clear of the bicubic border whether the domain stays (Eulerian:
    it samples the deformed frame up to num_pairs rows lower) or follows
    the material down (Lagrangian).

    Returns (cfg, frames [num_pairs + 1, H, W, 1] uint8, point lists,
    centers [S, 2])."""
    pts, centers = _grid(num_subsets, img_hw, half, room=num_pairs)
    return (_solver(stop), drifting_sequence(num_pairs, img_hw), pts,
            centers)


def _level0_points(batch: SubsetBatch) -> list[np.ndarray]:
    return [xy[m] for xy, m in zip(batch.xy[0], batch.mask[0])]


def annular_problem(
    num_pairs: int = 32, img_hw: int = 1024, center=(512.0, 480.0),
    radii=(120.0, 400.0), subdivisions=(8, 64), stop: int = 2,
) -> tuple[SolverConfig, np.ndarray, list[np.ndarray], AnnularDomain]:
    """An annulus of radial x angular sectors (by default 8 x 64 = 512
    sectors of about 890 px between radii 120 and 400) on
    drifting_sequence frames, AFFINE / BICUBIC at levels 2-1-0.  The
    sectors' points come from annular_batch, as the command line builds
    them; run_sequence centers them on their point means (centers=None).

    Returns (cfg, frames [num_pairs + 1, H, W, 1] uint8, point lists,
    domain)."""
    dom = AnnularDomain(float(center[0]), float(center[1]), float(radii[0]),
                        float(radii[1]), *subdivisions)
    pts = _level0_points(annular_batch(dom, 0))
    return _solver(stop), drifting_sequence(num_pairs, img_hw), pts, dom


def blob_contour(center=(512.0, 480.0), radius: float = 150.0,
                 vertices: int = 64) -> np.ndarray:
    """[vertices, 2] float32 non-convex freehand contour: r(theta) =
    radius (1 + 0.15 cos 5 theta) around `center`."""
    theta = np.arange(vertices) * (2.0 * np.pi / vertices)
    r = radius * (1.0 + 0.15 * np.cos(5.0 * theta))
    return np.stack([center[0] + r * np.cos(theta),
                     center[1] + r * np.sin(theta)], -1).astype(np.float32)


def blob_problem(
    num_pairs: int = 8, img_hw: int = 1024, center=(512.0, 480.0),
    radius: float = 150.0, stop: int = 2,
) -> tuple[SolverConfig, np.ndarray, list[np.ndarray], BlobDomain]:
    """One freehand blob (blob_contour, triangulated: about 7 x 10^4 px by
    default, its level-0 tile over 300 x 300) on drifting_sequence frames,
    AFFINE / BICUBIC at levels 2-1-0.

    Returns (cfg, frames [num_pairs + 1, H, W, 1] uint8, [points], domain)."""
    dom = BlobDomain(blob_contour(center, radius))
    pts = _level0_points(blob_batch(dom, 0))
    return _solver(stop), drifting_sequence(num_pairs, img_hw), pts, dom


def assembly_levels(cfg: SolverConfig, batch: SubsetBatch, pyramid: list,
                    device, seed: int = 1) -> dict:
    """{level: the fused_assemble arguments of one assembly of every
    subset} on the deformed frames of `pyramid` (build_pyramid of the
    [2, H, W, 1] pair), at parameters drawn from `seed` around the
    dense-grid problem's motion (u ~ 0.3 px noise, v = 1 / 2^level, small
    gradients), with subset 7 (where there is one) warped out of the
    image."""
    import torch

    from correlation_tpu_torch.engine import (
        compute_level_statics,
        prepare_levels,
    )

    statics = compute_level_statics(cfg, batch, pyramid)
    gb = batch.to_device(device)
    levels = prepare_levels(cfg, [p[0] for p in pyramid],
                            [p[1] for p in pyramid], gb.xy, gb.mask,
                            gb.center0, statics)
    rng = np.random.default_rng(seed)
    n = gb.center0.shape[0]
    out = {}
    for lvl in cfg.pyramid.levels_coarse_to_fine():
        st, lv = statics[lvl], levels[lvl]
        p = np.zeros((n, 6), np.float32)
        p[:, :2] = rng.normal(0, 0.3, (n, 2))
        p[:, 1] += 1.0 / (1 << lvl)
        p[:, 2:] = rng.normal(0, 0.003, (n, 4))
        if n > 7:
            p[7, 0] = 4000.0
        out[lvl] = (cfg.model, cfg.interpolation, st.tile_h, st.tile_w,
                    st.img_h, st.img_w, lv.def_img, lv.pix, lv.center,
                    torch.as_tensor(p, device=device), lv.bbox)
    return out


# Roles of the rows of lm_step_problem, cycled every 16 rows.
LM_STEP_ROLES = (
    "converging", "diverging", "singular fresh Gram", "singular cached Gram",
    "bad pixels, box inside", "bad pixels, box outside", "at max_iterations",
    "lambda at lambda_min", "lambda at lambda_max", "converged",
    "NaN parameters, bad pixels", "infinite last-good parameters",
    "NaN in the Gram", "parameters out of the image, bad pixels",
    "empty subset", "inactive",
)


def lm_step_problem(model: FittingModel, num_subsets: int = 4096,
                    seed: int = 0, img_hw: tuple[int, int] = (1024, 1024),
                    max_iterations: int = 50, stop: str | None = None):
    """Inputs of ops/solve.lm_step made with NumPy from `seed`: (cfg,
    arrays, out, scaling, n_points, bbox, center, img_hw), where `arrays`
    holds LMState's fields by name and `out` [S, 8, 8] each subset's
    assembly, in subset order.  Row r plays LM_STEP_ROLES[r % 16]: every
    branch of the step and of the initial step (SOLVER from a singular
    Gram, both out-of-image codes, MAX_ITERS_REACHED from max_iterations
    and from lambda_max, both lambda clamps, convergence, BAD_DOMAIN),
    rows of NaN and infinite values, and inactive rows; the other values
    of each row are random (Grams positive definite, 21 x 21 px boxes
    inside the image).  stop="none": every row converging, so no subset
    stops in either mode; stop="all": every row at max_iterations with
    no point (n_points 0, scaling kept), so every subset stops in either
    mode."""
    rng = np.random.default_rng(seed)
    s = num_subsets
    num_p = {FittingModel.U: 1, FittingModel.UV: 2, FittingModel.UVQ: 3,
             FittingModel.AFFINE: 6}[model]
    cfg = SolverConfig(model=model, max_iterations=max_iterations)
    role = np.arange(s) % len(LM_STEP_ROLES)
    if stop == "none":
        role[:] = 0
    img_h, img_w = img_hw
    center = np.stack([rng.uniform(20, img_w - 21, s),
                       rng.uniform(20, img_h - 21, s)], -1).astype(np.float32)
    corners = np.array([[-10, -10], [-10, 10], [10, -10], [10, 10]],
                       np.float32)
    bbox = (center[:, None, :] + corners).astype(np.float32)
    n_points = rng.integers(100, 442, s).astype(np.float32)
    n_points[role == 14] = 0.0
    scaling = np.where(n_points > 0, np.float32(1.0)
                       / np.maximum(n_points, np.float32(1.0)),
                       np.float32(0.0)).astype(np.float32)

    def grams(chi_raw):
        g = rng.normal(size=(s, num_p, 3 * num_p))
        out = np.zeros((s, 8, 8), np.float32)
        out[:, :num_p, :num_p] = np.einsum("sik,sjk->sij", g, g) * 50.0
        b = rng.normal(size=(s, num_p)) * 30.0
        out[:, :num_p, num_p] = b
        out[:, num_p, :num_p] = b
        out[:, num_p, num_p] = chi_raw
        return out

    p_cur = (rng.normal(size=(s, num_p)) * 0.05).astype(np.float32)
    p_lg = (p_cur + rng.normal(size=(s, num_p)) * 0.01).astype(np.float32)
    lam = (10.0 ** rng.uniform(-6, 2, s)).astype(np.float32)
    chi_lg = rng.uniform(50, 200, s).astype(np.float32)
    chi_new = chi_lg * rng.uniform(0.5, 0.9, s).astype(np.float32)
    chi_new[np.isin(role, (1, 3, 8))] *= 3.0
    chi_new[role == 9] = chi_lg[role == 9] * np.float32(1 - 2e-4)
    n_raw = np.maximum(n_points, 1.0)
    ab = grams(chi_lg * n_raw)
    out = grams(chi_new * n_raw)
    out[role == 2, :num_p, :] = 0.0
    out[role == 2, :, :num_p] = 0.0
    ab[role == 3, :num_p, :] = 0.0
    ab[role == 3, :, :num_p] = 0.0
    out[role == 4, num_p + 1, num_p + 1] = 3.0
    out[role == 5, num_p + 1, num_p + 1] = 1.0
    p_cur[role == 5, 0] = img_w + 50.0
    iteration = rng.integers(1, max_iterations - 1, s).astype(np.int32)
    iteration[role == 6] = max_iterations
    lam[role == 7] = 2e-9
    lam[role == 8] = 3e8
    p_cur[role == 10] = np.nan
    p_lg[role == 11] = np.inf
    out[role == 12, 0, 0] = np.nan
    p_cur[role == 13, num_p - 1] = -40.0
    out[np.isin(role, (10, 13)), num_p + 1, num_p + 1] = 2.0
    active = role != 15
    if stop == "all":
        n_points[:] = 0.0
        iteration[:] = max_iterations
    arrays = dict(
        p_cur=p_cur, p_lg=p_lg, ab=ab, lam=lam, chi_lg=chi_lg,
        iteration=iteration,
        reached=np.maximum(iteration - 1, 0).astype(np.int32),
        error=np.where(role == 15, 5, 0).astype(np.int32),
        active=active, init_fail=np.zeros(s, bool),
    )
    return cfg, arrays, out, scaling, n_points, bbox, center, img_hw


# The lists of lm_step_list.
LM_STEP_LISTS = ("whole", "gaps", "sparse", "last")


def lm_step_list(num_subsets: int, kind: str, seed: int = 0):
    """A device-style list of `num_subsets` subsets made with NumPy from
    `seed`: (idx int32 [num_subsets], count), the listed subsets
    idx[:count] in ascending order, every entry past count out of range
    (S + 7: read by nothing).  kind: "whole" lists every subset; "gaps"
    about 60% of them, "sparse" about 3% (most blocks of the kernel's
    grid empty), "last" only the last one.  A state whose active flags
    are exactly the listed subsets makes the step's output list equal
    engine.active_list of its flags after the step."""
    rng = np.random.default_rng(seed)
    s = num_subsets
    keep = {"whole": np.ones(s, bool),
            "gaps": rng.random(s) < 0.6,
            "sparse": rng.random(s) < 0.03,
            "last": np.arange(s) == s - 1}[kind]
    listed = np.flatnonzero(keep).astype(np.int32)
    idx = np.full(s, s + 7, np.int32)
    idx[:listed.size] = listed
    return idx, int(listed.size)
