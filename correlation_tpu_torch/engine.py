"""Batched coarse-to-fine Levenberg-Marquardt Gauss-Newton solver (PyTorch).

Port of correlation_tpu/engine.py: the tiled fused assembly, one frame
pair (correlate), several domains over one pair (correlate_many) and
chained frame pairs in every sequence mode (correlate_frames).  The
semantics are the JAX engine's:
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

Three assemblies (resolve_assembly).  The tiled one (backends "cuda" and
"torch") is the fused kernel of ops/assemble_v2.py, which reads a
per-subset tile of the deformed image and takes at most 3 channels; the
separable-tile one (backend "sep", JAX's "xla_sep"; ops/assemble.py)
reads the same taps from tiles placed by JAX's rule, in plain torch and
for any number of channels; the coefficient-field one (backend "field",
JAX's "xla"; ops/assemble.py) samples each level's coefficient field, so
warps of any size and any number of channels solve.  "auto" takes the
tiled assembly for up to 3 channels and the separable one above, as JAX's
"auto" leaves its fused kernel for xla_sep.  All return the same
[n, 8, 8] Gram, so the LM loop is one.

The LM loop stays on the device.  JAX runs the LM iterations in a
lax.while_loop, whose stop test never leaves the device, and shrinks the
batch with a compaction cascade.  Here the list of the still-active
subsets stays on the device: a level's first list is a stable sort of
its flags and their sum (active_list, no host read), the fused assembly
kernel reads its subsets through the list and its length from the
device, and the LM-step kernel (ops/solve.lm_step) updates exactly the
listed rows and writes the next list, the listed subsets still active,
in the same launch; the positions past the list's length exit at once,
which does the cascade's job.  So on the card a level enqueues its
initial step and the JAX loop's step bound of max_iterations + 2
iterations without one host sync, all issued by one call into the
kernel library (ops/solve.lm_level), and a chained chunk of frame pairs
(correlate_frames) enqueues whole, from the staged stack to the packed
result.  A subset's trajectory depends on its own state alone, so this
is the same arithmetic as the JAX loop (whose compaction is tested
bit-identical to the monolithic loop).
The separable and field assemblies, plain torch over the list, cannot
exit early: they take a host list (torch.nonzero, one sync an iteration)
and stop at the first empty one, through the same LM step.

Subset sharding (mesh=, parallel/mesh.py).  correlate and
correlate_frames take a mesh of processes, one a card: every rank gets
the caller's whole batch, computes the level statics from it, pads it to
the mesh and solves its contiguous slice through the same path, and the
outputs all-gather in rank order and lose the padding, so every rank
returns the caller's S subsets.  A slice keeps the whole batch's padded
point counts, extents and tiles, so it sums in the same order, and the
sharded solve equals the unsharded one bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from correlation_tpu_torch.config import ErrorCode, SolverConfig
from correlation_tpu_torch.models.warp import translate_params
from correlation_tpu_torch.ops import assemble_v2 as v2
from correlation_tpu_torch.ops.assemble import field_assemble, sep_assemble
from correlation_tpu_torch.ops.interp import (
    InterpField,
    precompute_field,
    sample_integer,
)
from correlation_tpu_torch.ops.pyramid import build_pyramid
from correlation_tpu_torch.ops.solve import LMState, lm_level, lm_step
from correlation_tpu_torch.parallel.mesh import (
    Mesh,
    gather_rows,
    shard_inputs,
    shard_rows,
)
from correlation_tpu_torch.utils import profiling

class LevelArrays(NamedTuple):
    """Per-pyramid-level solver inputs for a subset batch."""

    center: torch.Tensor  # [S, 2] subset centers at this level
    n_points: torch.Tensor  # [S] float32
    pix: torch.Tensor  # [S, 5 + max(C, 3), P] pixel rows (v2.pack_pixels)
    bbox: torch.Tensor  # [S, 4, 2] undeformed bounding-box corners
    def_img: torch.Tensor | None  # tiled / sep: [Hp, Wp, C] padded image
    img_hw: tuple[int, int]  # true deformed-image dims
    def_field: InterpField | None = None  # field: the deformed image's


class LevelStatic(NamedTuple):
    """Per-level tile and image dims, and which tiled assembly reads them:
    the fused kernel, or with `sep` the separable one."""

    tile_h: int
    tile_w: int
    img_h: int
    img_w: int
    sep: bool = False


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


def _make_assemble(cfg: SolverConfig, level: LevelArrays,
                   static: LevelStatic | None):
    """(assemble, device_list): assemble(params [S, NP], idx int32 [n],
    count) -> [n, 8, 8], the field assembly where the level carries a
    field, the separable one where the statics say `sep`, else the fused
    one; device_list is whether the assembly reads the list's length from
    the device (`count`), which only the fused kernel does."""
    if level.def_field is not None:
        def assemble(params, idx, count):
            return field_assemble(cfg.model, cfg.interpolation,
                                  level.def_field, level.pix, level.center,
                                  params, idx)

        return assemble, False
    if static.sep:
        def assemble(params, idx, count):
            return sep_assemble(cfg.model, cfg.interpolation, static.tile_h,
                                static.tile_w, static.img_h, static.img_w,
                                level.def_img, level.pix, level.center,
                                params, idx)

        return assemble, False
    # resolve_device has checked this for every entry point; solve_level
    # and correlate_prepared are public and can be called without it.
    _check_backend_device(cfg, level.def_img.device)

    def assemble(params, idx, count):
        return v2.fused_assemble(
            cfg.model, cfg.interpolation, static.tile_h, static.tile_w,
            static.img_h, static.img_w, level.def_img, level.pix,
            level.center, params, level.bbox, idx, count,
        )

    return assemble, True


def active_list(mask: torch.Tensor, on_device: bool):
    """The subsets where `mask` holds, as (idx int32, count).

    on_device: idx has room for every subset, the listed ones first in
    index order (a stable sort of the mask), and count is their number as
    an int32 [1] tensor on mask's device: no operation reads it on the
    host, so nothing waits for the device.  Else idx lists exactly those
    subsets (torch.nonzero, which waits for the device) and count is None.
    solve_level builds a device list once a level, for the initial step;
    the LM step writes every later one.  The host lists of the separable
    and field assemblies are built every iteration.
    """
    if on_device:
        idx = torch.argsort(mask.view(torch.uint8), descending=True,
                            stable=True).to(torch.int32)
        return idx, mask.sum(dtype=torch.int32).reshape(1)
    return torch.nonzero(mask).flatten().to(torch.int32), None


def _empty_list(idx: torch.Tensor, count: torch.Tensor | None) -> bool:
    """Whether a list is known to be empty without waiting for the card:
    a host list's length, a device list's on the CPU.  A device list on
    the card never is: its iteration runs, and its launches exit."""
    if count is None:
        return idx.numel() == 0
    return count.device.type == "cpu" and int(count) == 0


@profiling.traced(profiling.ENGINE_SOLVE_LEVEL)
def solve_level(
    cfg: SolverConfig,
    level: LevelArrays,
    params0: torch.Tensor,
    skip: torch.Tensor,
    static: LevelStatic | None = None,
) -> LevelResult:
    """The LM loop of one pyramid level over all subsets.

    params0: [S, NP] guesses at this level's scale; skip: [S] bool, subsets
    frozen by earlier failures, left untouched (their rows of the result
    are not meaningful and are not read by correlate_prepared); static:
    the level's tile dims (the tiled and separable assemblies only).

    Each LM iteration is: the list of the still-active subsets, their
    assembly, and ops/solve.lm_step on them, as the initial step is on the
    subsets not skipped.  On the fused assembly the list stays on the
    device: active_list builds the initial step's list once, and step k
    writes the next list into the other of two buffers that alternate and
    its length into row k of a counts buffer, so the host always knows
    which is current without a read, and the level's lengths stay on the
    device.  On the card the level's initial step and max_iterations + 2
    iterations (the JAX loop's step bound) enqueue without one host read,
    an iteration past the last active subset costing two launches that
    exit at once, and since their launches are then fixed before the first
    is issued, one call into the kernel library (ops/solve.lm_level)
    issues them all; on the CPU the loop stops at the first empty list.  The
    separable and field assemblies, plain torch over the list, take a
    host list instead (active_list every iteration, one sync each) and
    stop at the first empty one.  The results are the same.  While a
    utils.profiling recording is open, the list length of every step
    issued is handed to it (a device count by reference, read when the
    recording closes), and the level is counted (utils.profiling
    Recording.add_level), with whether its fused assembly takes K1's
    split path.
    """
    assemble, device_list = _make_assemble(cfg, level, static)
    n_points = level.n_points.contiguous()
    n_ok = n_points > 0
    scaling = torch.where(n_ok, 1.0 / n_points.clamp(min=1.0), 0.0)
    state = LMState.start(cfg, params0)
    bbox, center = level.bbox.contiguous(), level.center.contiguous()
    rec = profiling.current_recording()
    lengths = None if rec is None else []  # each issued step's list length

    def step(idx, count, init, nxt=(None, None)):
        if _empty_list(idx, count):
            return False
        if lengths is not None and count is None:
            lengths.append(idx.shape[0])
        out = assemble(state.p_cur, idx, count)
        lm_step(cfg, state, out, idx, count, scaling, n_points, bbox, center,
                level.img_hw, init, *nxt)
        return True

    steps = cfg.max_iterations + 3  # the initial step and JAX's step bound
    # A device list on the card: the level's launches are fixed before the
    # first is issued, and one call into the kernel library issues them.
    native = device_list and params0.device.type == "cuda"
    if device_list:
        # Entries past a list's count stay valid subset indices (zero, or
        # an older list's), which the CPU assembly checks.
        lists = torch.zeros((2, params0.shape[0]), dtype=torch.int32,
                            device=params0.device)
        counts = torch.empty((steps, 1), dtype=torch.int32,
                             device=params0.device)
        cur = active_list(~skip, True)
        first, issued = cur[1], steps
        if native:
            lm_level(cfg, state, (static.tile_h, static.tile_w, static.img_h,
                                  static.img_w, level.def_img, level.pix),
                     scaling, n_points, bbox, center, level.img_hw, *cur,
                     lists, counts)
        else:
            for k in range(steps):
                nxt = (lists[k % 2], counts[k])
                if not step(*cur, k == 0, nxt):
                    issued = k
                    break
                cur = nxt
        if lengths is not None and issued:
            # Step k's list length, on the device: the first list's count
            # for k = 0, counts[k - 1] after.
            lengths += [first, counts[:issued - 1]]
    else:
        step(*active_list(~skip, False), True)
        for _ in range(steps - 1):
            if not step(*active_list(state.active, False), False):
                break
    if rec is not None:
        rec.add_lengths(lengths)
        rec.add_level(native, device_list
                      and v2.subset_chunks(level.pix.shape[-1]) > 1)
    return LevelResult(state.p_cur, state.chi_lg, state.reached,
                       state.error, state.init_fail)


def compute_level_statics(
    cfg: SolverConfig, subsets, def_pyramid, sep: bool = False
) -> dict[int, LevelStatic]:
    """Tile dims per level: the subset extent + halo + tile_margin, in
    multiples of 8, capped at the image dims rounded up to 8; the same for
    both tiled assemblies (`sep`: the separable one), as in JAX."""
    out = {}
    for lvl in cfg.pyramid.levels_coarse_to_fine():
        ext_y, ext_x = subsets.extents[lvl]
        h, w = int(def_pyramid[lvl].shape[-3]), int(def_pyramid[lvl].shape[-2])
        hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
        th, tw = v2.choose_tile(ext_y, ext_x, hp, wp, cfg.tile_margin)
        out[lvl] = LevelStatic(th, tw, h, w, sep)
    return out


def prepare_levels(
    cfg: SolverConfig,
    und_pyramid: list,
    def_pyramid: list,
    xy_levels: list,
    mask_levels: list,
    center0: torch.Tensor,
    statics: dict[int, LevelStatic] | None,
    skip_def: bool = False,
) -> dict[int, LevelArrays]:
    """LevelArrays for every level in the schedule: undeformed intensities
    sampled once per level, pixel rows packed, and (unless skip_def) the
    deformed image: zero-padded only up to the tile dims of `statics` for
    the tiled and separable assemblies (as JAX pads for xla_sep), or, with
    statics None, its coefficient field for the field assembly."""
    out = {}
    for lvl in cfg.pyramid.levels_coarse_to_fine():
        xy, mask = xy_levels[lvl], mask_levels[lvl]
        center = center0 / float(1 << lvl)
        und_w = sample_integer(und_pyramid[lvl], xy) * mask[..., None]
        dfm = def_pyramid[lvl]
        def_img = def_field = None
        if statics is None:
            img_hw = (int(dfm.shape[-3]), int(dfm.shape[-2]))
            if not skip_def:
                def_field = precompute_field(dfm, cfg.interpolation)
        else:
            st = statics[lvl]
            img_hw = (st.img_h, st.img_w)
            if not skip_def:
                def_img = v2.prepare_image(dfm, st.tile_h, st.tile_w)
        out[lvl] = LevelArrays(
            center=center,
            n_points=mask.sum(dim=-1).to(torch.float32),
            pix=v2.pack_pixels(xy, mask, und_w, center),
            bbox=v2.subset_bbox(xy, mask),
            def_img=def_img,
            img_hw=img_hw,
            def_field=def_field,
        )
    return out


def correlate_prepared(
    cfg: SolverConfig,
    levels: dict[int, LevelArrays],
    params0: torch.Tensor,
    center0: torch.Tensor,
    n_points0: torch.Tensor,
    statics: dict[int, LevelStatic] | None,
) -> CorrelationResult:
    """Coarse-to-fine solve given prepared per-level arrays.

    params0: [S, NP] guesses at level-0 scale; statics: the tile dims per
    level, None for the field assembly.
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
        res = solve_level(cfg, levels[lvl], p, frozen,
                          None if statics is None else statics[lvl])
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


def resolve_device(cfg: SolverConfig, device=None, like=None,
                   mesh: Mesh | None = None) -> torch.device:
    """Where a solve runs: the mesh's device when there is a mesh (a
    `device` that names another raises ValueError), else `device` when
    the caller names one, else the device of `like` when it is a tensor,
    else the card for backends "cuda", "auto", "sep" and "field" (raising
    RuntimeError when there is none) and the CPU for backend "torch".
    Backend "cuda" on a device that is not CUDA, and "torch" on one that
    is not the CPU, raise ValueError (_check_backend_device): every entry
    point calls this before it touches an image."""
    if mesh is not None:
        if device is not None and not _same_device(device, mesh.device):
            raise ValueError(
                f"device {device} is not the mesh's device {mesh.device}; "
                "a rank solves on its mesh's device")
        where = mesh.device
    elif device is not None:
        where = torch.device(device)
    elif torch.is_tensor(like):
        where = like.device
    elif cfg.backend == "torch":
        where = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise RuntimeError(
            f"backend {cfg.backend!r} solves on a CUDA device and none is "
            "available; pass device='cpu' or use backend 'torch' to solve "
            "on the CPU"
        )
    else:
        where = torch.device("cuda")
    _check_backend_device(cfg, where)
    return where


def _check_backend_device(cfg: SolverConfig, device: torch.device) -> None:
    """ValueError unless `device` is one that cfg.backend solves on:
    backend "cuda" runs the CUDA kernel and "torch" its plain version on
    the CPU; the others run on either."""
    need = {"cuda": "cuda", "torch": "cpu"}.get(cfg.backend)
    if need is not None and device.type != need:
        raise ValueError(
            f"backend {cfg.backend!r} solves on a {need} device, not on "
            f"{device}; backends 'auto', 'sep' and 'field' solve on either"
        )


def _same_device(device, mesh_device: torch.device) -> bool:
    """Whether `device` names the mesh's device (one without an index
    names its type)."""
    want = torch.device(device)
    return (want.type == mesh_device.type
            and want.index in (None, mesh_device.index))


MAX_CHANNELS = 3  # the tiled assembly's (the fused kernel's) limit


def resolve_assembly(cfg: SolverConfig, channels: int) -> str:
    """The assembly images of `channels` channels take: "field" (backend
    "field"), "sep" (backend "sep", and "auto" above MAX_CHANNELS, as the
    JAX package's "auto" leaves its fused kernel for xla_sep there) or
    "tiled" (the fused kernel or its plain version)."""
    if cfg.backend in ("field", "sep"):
        return cfg.backend
    if cfg.backend == "auto" and channels > MAX_CHANNELS:
        return "sep"
    return "tiled"


def check_channels(cfg: SolverConfig, shape, what: str) -> None:
    """Raise ValueError, before any work on the device, when images of
    `shape` (channels last) carry more channels than the chosen assembly
    takes: the tiled one (backends "cuda" and "torch") takes at most
    MAX_CHANNELS; "auto", "sep" and "field" solve any number."""
    channels = shape[-1]
    if channels > MAX_CHANNELS and resolve_assembly(cfg, channels) == "tiled":
        raise ValueError(
            f"{what} have {channels} channels; backend {cfg.backend!r} "
            f"takes at most {MAX_CHANNELS} (the fused assembly's limit); "
            "backends 'auto' and 'sep' solve them on the separable-tile "
            "assembly, 'field' on the coefficient-field one")


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
    mesh: Mesh | None = None,
) -> CorrelationResult:
    """Batched correlation of one frame pair.

    und_pyramid / def_pyramid: lists of [H_l, W_l, C] images (numpy or
    tensors; see ops.pyramid.build_pyramid).  subsets: a
    domains.SubsetBatch.  params0: [S, NP] guesses at level-0 scale.
    device: where to solve (default: resolve_device, the device of
    und_pyramid[0] when it is a tensor).  mesh: optional
    parallel.mesh.Mesh; the subset axis shards over its ranks, which all
    pass the same arguments, solve on the mesh's device and return the
    caller's S subsets (the mesh padding is added and stripped here).
    """
    if mesh is None:
        return correlate_many(cfg, und_pyramid, def_pyramid, [subsets],
                              [params0], device)[0]
    # The shard keeps the whole batch's extents, so the level statics
    # correlate_many computes from it are the whole batch's.  Every check
    # that can raise runs before the one collective, alike on every rank,
    # and the images' before the device's, as in correlate_many.
    check_channels(cfg, np.shape(und_pyramid[0]), "the undeformed images")
    check_channels(cfg, np.shape(def_pyramid[0]), "the deformed images")
    device = resolve_device(cfg, device, mesh=mesh)
    shard, guess = shard_inputs(mesh, subsets, params0)
    res = correlate_many(cfg, und_pyramid, def_pyramid, [shard], [guess],
                         device)[0]
    return CorrelationResult(
        *(gather_rows(mesh, t, subsets.num_subsets) for t in res))


def correlate_many(
    cfg: SolverConfig,
    und_pyramid,
    def_pyramid,
    batches,
    params0_list,
    device=None,
) -> list[CorrelationResult]:
    """Solve several independent domains over one frame pair.

    The pyramids are cast to `device` once.  On the tiled and separable
    assemblies each domain keeps its own tile dims per level
    (compute_level_statics), so a big blob beside small sectors does not
    widen their tiles, as combine_batches would; on the field assembly the
    fields are built once for all domains.  The domains solve one after
    another.  Each result equals the domain's own correlate call bit for
    bit.

    batches: domains.SubsetBatch list; params0_list: per-domain [S_i, NP]
    guesses at level-0 scale; device: as correlate.
    Returns one CorrelationResult per domain.
    """
    if len(batches) != len(params0_list):
        raise ValueError(
            f"{len(batches)} batches but {len(params0_list)} guesses"
        )
    check_channels(cfg, np.shape(und_pyramid[0]), "the undeformed images")
    check_channels(cfg, np.shape(def_pyramid[0]), "the deformed images")
    device = resolve_device(cfg, device, und_pyramid[0])
    und = [_as_f32(a, device) for a in und_pyramid]
    dfm = [_as_f32(a, device) for a in def_pyramid]
    fields = None
    assembly = resolve_assembly(cfg, dfm[0].shape[-1])
    if assembly == "field":
        fields = {lvl: precompute_field(dfm[lvl], cfg.interpolation)
                  for lvl in cfg.pyramid.levels_coarse_to_fine()}
    out = []
    for subsets, params0 in zip(batches, params0_list):
        batch = subsets.to_device(device)
        if fields is None:
            statics = compute_level_statics(cfg, subsets, dfm,
                                            sep=assembly == "sep")
            levels = prepare_levels(
                cfg, und, dfm, batch.xy, batch.mask, batch.center0, statics
            )
        else:
            statics = None
            levels = prepare_levels(cfg, und, dfm, batch.xy, batch.mask,
                                    batch.center0, None, skip_def=True)
            levels = {lvl: a._replace(def_field=fields[lvl])
                      for lvl, a in levels.items()}
        out.append(correlate_prepared(
            cfg, levels, _as_f32(params0, device), batch.center0,
            batch.mask[0].sum(dim=-1), statics,
        ))
    return out


def _uv_of(p: torch.Tensor) -> torch.Tensor:
    """[S, 2] (u, v) columns of the parameters (v = 0 for model U)."""
    uv = p[:, :2]
    if uv.shape[1] < 2:
        uv = torch.nn.functional.pad(uv, (0, 2 - uv.shape[1]))
    return uv


def correlate_frames(
    cfg: SolverConfig,
    frames_stack,
    subsets,
    guess0,
    *,
    reference_first: bool = True,
    stop_frame: bool = False,
    lagrangian: bool = False,
    float_centers: bool = True,
    first_chunk: bool = True,
    p_seed=None,
    prev_seed=None,
    chi_seed=None,
    it_seed=None,
    off_seed=None,
    ucen_seed=None,
    statics=None,
    device=None,
    mesh: Mesh | None = None,
) -> dict:
    """Chained solve of K frame pairs (correlation_tpu.engine.correlate_frames).

    frames_stack: [K+1, H, W, C] uint8 or float32 frames; element 0 is the
    chunk's undeformed base (sequence frame 0 for reference-First, the
    preceding frame otherwise), 1..K the deformed frames.  The stack is
    cast to float32 on `device` (default: resolve_device, its own device
    when it is a tensor).  subsets: a domains.SubsetBatch, the sequence-start
    geometry for `lagrangian`.

    Chaining, as the JAX scan:
      * reference_first (Eulerian, reference First): und = stack[0] and the
        guess is the constant-velocity extrapolation p + (p - prev);
        otherwise und = stack[i] and the guess is the previous result;
      * lagrangian: the domain follows the material.  The carry gains the
        cumulative whole-pixel offset `off` and the float centers `ucen`,
        advanced by the previous result's (u, v) before every pair but the
        sequence's first; level l translates the frame-0 level-l point set
        by floor(off / 2^l + 0.5), and the centers are `ucen` with
        float_centers, else center0 + off.  The guess is the previous
        result;
      * stop_frame: a subset with an error keeps its chained params, chi
        and iterations (zero params on the sequence's first pair);
      * first_chunk: the first pair starts from guess0.
    p_seed / prev_seed / chi_seed / it_seed / off_seed / ucen_seed: the
    state entering the chunk (defaults: guess0, guess0, zeros, zeros, zeros,
    subsets.center0); interop converts a JAX carry.  statics: per-level
    LevelStatic of the tiled or separable assembly (default: from the
    stack's shape and resolve_assembly).
    On the field assembly (resolve_assembly) each pair's deformed levels get
    their coefficient fields in the frame loop, never the whole stack's
    at once (one bicubic field of a 1024 x 1024 frame is 67 MB).

    mesh: optional parallel.mesh.Mesh; the subset axis (of the batch,
    guess0 and the seeds) shards over its ranks, which all pass the same
    arguments and solve on the mesh's device; the statics come from the
    whole batch, and every output is gathered whole on every rank.

    Returns the stacked per-frame params, guess, chi, iterations, error
    ([K, S, ...]), the packed [K, S, NP + 3] output (params, chi,
    iterations, error), and the carry (p, prev, chi, iterations, plus off
    and ucen for lagrangian) for the next chunk.
    """
    check_channels(cfg, np.shape(frames_stack), "the frames")
    device = resolve_device(cfg, device, frames_stack, mesh)
    with profiling.trace_region(profiling.ENGINE_PREPARE):
        frames = _as_f32(frames_stack, device)
        k = frames.shape[0] - 1
        pyr = build_pyramid(frames, cfg.pyramid.stop)
        assembly = resolve_assembly(cfg, frames.shape[-1])
        field = assembly == "field"
        if field:
            statics = None
        elif statics is None:
            statics = compute_level_statics(cfg, subsets, pyr,
                                            sep=assembly == "sep")
        num_subsets = subsets.num_subsets
        if mesh is not None:
            subsets, guess0 = shard_inputs(mesh, subsets, guess0)
            p_seed, prev_seed, chi_seed, it_seed, off_seed, ucen_seed = (
                shard_rows(mesh, a) for a in (p_seed, prev_seed, chi_seed,
                                              it_seed, off_seed, ucen_seed))
        batch = subsets.to_device(device)
        s = batch.num_subsets
        schedule = cfg.pyramid.levels_coarse_to_fine()

        # Frame-invariant work leaves the frame loop: the padded deformed
        # levels of the whole stack (tiled and separable) and, for the
        # Eulerian reference-First chain, the reference frame's level arrays.
        prepped = None if field else {
            lvl: v2.prepare_image(pyr[lvl], statics[lvl].tile_h,
                                  statics[lvl].tile_w)
            for lvl in schedule
        }
        und0 = [level[0] for level in pyr]
        base = None
        if reference_first and not lagrangian:
            base = prepare_levels(
                cfg, und0, und0, batch.xy, batch.mask, batch.center0, statics,
                skip_def=True,
            )
        n_points0 = batch.mask[0].sum(dim=-1)

    def f32(a):
        return _as_f32(a, device)

    guess0 = f32(guess0)
    if first_chunk:
        p = guess0 if p_seed is None else f32(p_seed)
        prev = guess0 if prev_seed is None else f32(prev_seed)
        override = 0
    else:
        p = f32(p_seed)
        prev = f32(prev_seed)
        override = -1
    chi_c = (torch.zeros(s, dtype=torch.float32, device=device)
             if chi_seed is None else f32(chi_seed))
    it_c = (torch.zeros(s, dtype=torch.int32, device=device)
            if it_seed is None
            else torch.as_tensor(it_seed, device=device).to(torch.int32))
    if lagrangian:
        off = (torch.zeros((s, 2), dtype=torch.float32, device=device)
               if off_seed is None else f32(off_seed))
        ucen = batch.center0 if ucen_seed is None else f32(ucen_seed)

    ys = {"params": [], "guess": [], "chi": [], "iterations": [], "error": []}
    for i in profiling.trace_each(profiling.ENGINE_PAIR, range(k)):
        first = i == override
        if lagrangian:
            if not first:
                # advance_domain between frames: points translate by the
                # rounded (u, v), centers by the float (u, v).
                uvp = _uv_of(p)
                off = off + torch.floor(uvp + 0.5)
                ucen = ucen + uvp
            guess = p
            center_i = ucen if float_centers else batch.center0 + off
            xy_i = [xy_l + torch.floor(off / float(1 << lvl) + 0.5)[:, None, :]
                    for lvl, xy_l in enumerate(batch.xy)]
        else:
            guess = p + (p - prev) if reference_first else p
            center_i, xy_i = batch.center0, batch.xy
        if first:
            guess = guess0
        if base is not None:
            levels = base
        else:
            und = und0 if reference_first else [level[i] for level in pyr]
            levels = prepare_levels(cfg, und, und, xy_i, batch.mask,
                                    center_i, statics, skip_def=True)
        if field:
            levels = {lvl: levels[lvl]._replace(def_field=precompute_field(
                pyr[lvl][i + 1], cfg.interpolation)) for lvl in schedule}
        else:
            levels = {lvl: levels[lvl]._replace(def_img=prepped[lvl][i + 1])
                      for lvl in schedule}
        res = correlate_prepared(cfg, levels, guess, center_i, n_points0,
                                 statics)
        p_new, chi_new, it_new = res.params, res.chi, res.iterations
        if stop_frame:
            bad = res.error != int(ErrorCode.NONE)
            fallback = torch.zeros_like(p) if first else p
            p_new = torch.where(bad[:, None], fallback, p_new)
            chi_new = torch.where(bad, chi_c, chi_new)
            it_new = torch.where(bad, it_c, it_new)
        prev, p, chi_c, it_c = p, p_new, chi_new, it_new
        for key, val in (("params", p_new), ("guess", guess),
                         ("chi", chi_new), ("iterations", it_new),
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
    out["carry"] = (p, prev, chi_c, it_c) + ((off, ucen) if lagrangian else ())
    out["center0"] = batch.center0
    out["n_points0"] = n_points0.to(torch.int32)
    if mesh is not None:
        for key in (*ys, "packed"):  # [K, S, ...]
            out[key] = gather_rows(mesh, out[key], num_subsets, dim=1)
        out["carry"] = tuple(gather_rows(mesh, t, num_subsets)
                             for t in out["carry"])
        for key in ("center0", "n_points0"):
            out[key] = gather_rows(mesh, out[key], num_subsets)
    return out
