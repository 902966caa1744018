"""Multi-frame correlation (port of correlation_tpu/sequence.py).

Every frame pair is one batched solve over all sectors, as in the JAX
run_sequence, with the same record semantics:
  * reference-image modes First / Previous;
  * deformation descriptions Eulerian / Lagrangian / strict-Lagrangian
    (domain updates between frames, advance_domain);
  * the constant-velocity initial-guess extrapolation for Eulerian +
    reference First, and the frame-0 per-sector guess customization;
  * per-sector FrameRecords with the point-weighted global averages;
  * the error modes stop-all / stop-frame / continue, cooperative cancel
    (should_stop) and checkpoint / resume in the JAX package's file format.

Eulerian and Lagrangian sequences with frame_chunk > 1 solve frame_chunk
pairs per engine.correlate_frames call; strict-Lagrangian sequences and
frame_chunk = 1 solve pair by pair through engine.correlate.  The host
state is NumPy, as in the JAX package.

The chunked path is the JAX package's pipelined loop: chunk i + 1 is
dispatched, seeded from chunk i's carry on the device, before chunk i's
results are fetched, and the next stack is staged meanwhile; on the card
the fixed-budget LM loop (engine.solve_level) enqueues a whole chunk
without one host read, so the host's staging and record keeping overlap
the card's solve.  should_stop is polled where the JAX loop polls it: once
for chunk i + 1, before chunk i's records are emitted (a stop there still
emits chunk i, then ends the run, and chunk i + 1 is never dispatched),
and before each of a chunk's records after its first (a stop there, or a
STOP_ALL error, drops the chunk in flight).  The same should_stop so
leaves the same records and checkpoint in both packages.

What the JAX chunked path does for the TPU and this port does not:
  * it pads the tail chunk to the compiled chunk shape; PyTorch runs
    eagerly, so the tail chunk is simply shorter;
  * it demotes the kernel's bf16 image path when a frame is not
    uint8-valued (guard_p1); the CUDA kernel reads float32 images.
As the JAX chunked path does, a sequence's first chunk is seeded from the
host state (p = params = 0, prev = the frame-0 guess), so the solver's
guess for the second pair is 2 p1, while the records report the
per-frame path's p1 + (p1 - guess); the two differ when the global guess
is not zero (ROADMAP, findings against the JAX package).

With a mesh (parallel.mesh, one process a card) every pair's solve shards
its subsets over the ranks and gathers the results whole on every rank,
so every rank runs the same host loop on the same numbers: the records,
the domain advance and the error-mode decisions agree.  should_stop is
polled on rank 0 and its answer broadcast, so every rank leaves the loop
at the same pair; rank 0 alone writes the checkpoint, and the ranks wait
for it before going on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from correlation_tpu_torch.config import (
    DeformationDescription,
    ErrorCode,
    ErrorMode,
    FittingModel,
    ReferenceImage,
    SolverConfig,
)
from correlation_tpu_torch.domains import make_batch
from correlation_tpu_torch.engine import (
    check_channels,
    correlate,
    correlate_frames,
    resolve_device,
)
from correlation_tpu_torch.models.warp import warp_points
from correlation_tpu_torch.ops.pyramid import build_pyramid
from correlation_tpu_torch.parallel.mesh import Mesh, barrier, broadcast_flag
from correlation_tpu_torch.utils.profiling import (
    SEQ_ADVANCE,
    SEQ_DISPATCH,
    SEQ_EMIT,
    SEQ_FETCH,
    SEQ_MAKE_BATCH,
    SEQ_PAIR,
    SEQ_RUN,
    SEQ_STAGE,
    trace_region,
    traced,
)


@dataclasses.dataclass(frozen=True)
class SequenceConfig:
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    deformation: DeformationDescription = DeformationDescription.EULERIAN
    reference: ReferenceImage = ReferenceImage.FIRST
    error_mode: ErrorMode = ErrorMode.CONTINUE
    # Eulerian / Lagrangian sequences solve this many frame pairs per
    # engine.correlate_frames call; 1 = pair by pair.
    frame_chunk: int = 64
    # Snapshot each frame's per-sector undeformed point lists into its
    # FrameRecord (und_points); the Lagrangian descriptions move them.
    record_points: bool = False


@dataclasses.dataclass
class FrameRecord:
    """Per-frame, per-sector results."""

    frame: int
    params: np.ndarray  # [S, NP]
    initial_guess: np.ndarray  # [S, NP]
    chi: np.ndarray  # [S]
    iterations: np.ndarray  # [S]
    error: np.ndarray  # [S]
    n_points: np.ndarray  # [S]
    und_center: np.ndarray  # [S, 2]
    def_center: np.ndarray  # [S, 2]
    und_angle: np.ndarray  # [S]
    def_angle: np.ndarray  # [S]
    und_global_center: np.ndarray  # [2]
    def_global_center: np.ndarray  # [2]
    und_global_angle: float
    def_global_angle: float
    und_contours: list | None = None  # per-sector [Nc, 2]
    def_contours: list | None = None  # per-sector [Nc, 2]
    # The reference's per-sector strain state: update_results zeroes def_e
    # for every model and the Lagrangian updates copy def -> und.
    und_e: np.ndarray | None = None  # [S]
    def_e: np.ndarray | None = None  # [S]
    und_global_e: float = 0.0
    def_global_e: float = 0.0
    # Per-sector undeformed points of this frame's solve (record_points).
    und_points: list | None = None


@dataclasses.dataclass
class _TrackState:
    """Chained per-sector state across frames."""

    und_points: list[np.ndarray]  # level-0 float positions per sector
    und_center: np.ndarray  # [S, 2]
    past_und_center: np.ndarray  # [S, 2]
    und_angle: np.ndarray  # [S]
    und_global_center: np.ndarray  # [2]
    und_global_angle: float
    params: np.ndarray  # [S, NP] resulting parameters
    prev_params: np.ndarray  # [S, NP]
    guess: np.ndarray  # [S, NP]
    def_center: np.ndarray  # [S, 2]
    def_angle: np.ndarray  # [S]
    def_global_center: np.ndarray  # [2]
    def_global_angle: float
    explicit_centers: bool  # rectangular domains pass centers explicitly
    und_contours: list | None = None  # per-sector [Nc, 2] float
    def_contours: list | None = None
    pad_to: list | None = None  # per-level padded point counts
    # Last emitted chi / iterations: STOP_FRAME frozen sectors re-emit them.
    chi: np.ndarray | None = None  # [S]
    iterations: np.ndarray | None = None  # [S]
    und_e: np.ndarray | None = None  # [S]
    def_e: np.ndarray | None = None  # [S]
    und_global_e: float = 0.0
    def_global_e: float = 0.0


def initial_track_state(
    point_lists: list[np.ndarray],
    centers: np.ndarray | None,
    global_center: np.ndarray,
    global_guess: np.ndarray,
    model: FittingModel,
    contours: list | None = None,
    per_sector_uv: np.ndarray | None = None,
) -> _TrackState:
    """Frame-0 state: per-sector guesses from the global guess (the
    rigid-rotation translation for UVQ, the strain offset for AFFINE, about
    the global center), optionally seeded per sector with (u, v)."""
    s = len(point_lists)
    num_params = len(global_guess)
    explicit = centers is not None
    if centers is None:
        centers = np.array(
            [p.mean(axis=0, dtype=np.float64) for p in point_lists],
            np.float32,
        )
    guess = np.tile(np.asarray(global_guess, np.float32), (s, 1))
    if per_sector_uv is not None:
        uv = np.asarray(per_sector_uv, np.float32).reshape(s, 2)
        guess[:, 0] = uv[:, 0]
        if num_params > 1:
            guess[:, 1] = uv[:, 1]
    d = centers - np.asarray(global_center, np.float32)
    if model == FittingModel.UVQ:
        vx = global_guess[2]
        guess[:, 0] += -d[:, 1] * vx
        guess[:, 1] += d[:, 0] * vx
    elif model == FittingModel.AFFINE:
        ux, uy, vx, vy = global_guess[2:6]
        guess[:, 0] += d[:, 0] * ux + d[:, 1] * uy
        guess[:, 1] += d[:, 0] * vx + d[:, 1] * vy
    return _TrackState(
        und_points=[np.asarray(p, np.float32) for p in point_lists],
        und_center=centers.astype(np.float32),
        past_und_center=centers.astype(np.float32).copy(),
        und_angle=np.zeros(s, np.float32),
        und_global_center=np.asarray(global_center, np.float32),
        und_global_angle=0.0,
        params=np.zeros((s, num_params), np.float32),
        prev_params=guess.copy(),
        guess=guess,
        def_center=centers.astype(np.float32).copy(),
        def_angle=np.zeros(s, np.float32),
        def_global_center=np.asarray(global_center, np.float32),
        def_global_angle=0.0,
        explicit_centers=explicit,
        und_contours=(
            [np.asarray(c, np.float32) for c in contours]
            if contours is not None
            else None
        ),
        chi=np.zeros(s, np.float32),
        iterations=np.zeros(s, np.int32),
        und_e=np.zeros(s, np.float32),
        def_e=np.zeros(s, np.float32),
    )


def _round_points(pts: np.ndarray) -> np.ndarray:
    """The reference's add_pair rounding: (int)(x + 0.5)."""
    return np.floor(pts + 0.5).astype(np.float32)


def _warp_ragged(
    model: FittingModel,
    params: np.ndarray,
    point_lists: list[np.ndarray],
    centers: np.ndarray,
) -> list[np.ndarray]:
    """Warp S ragged per-sector point lists in one batched call: pad to
    [S, P_max, 2], warp_points on CPU tensors, split back."""
    s = len(point_lists)
    lens = [len(p) for p in point_lists]
    xy = np.zeros((s, max(max(lens), 1), 2), np.float32)
    for i, p in enumerate(point_lists):
        xy[i, : lens[i]] = p
    out = warp_points(
        model,
        torch.from_numpy(np.asarray(params, np.float32)),
        torch.from_numpy(xy),
        torch.from_numpy(np.asarray(centers, np.float32)),
    ).numpy()
    return [out[i, : lens[i]].copy() for i in range(s)]


def warped_inside_points(
    model: FittingModel,
    params: np.ndarray,
    point_lists: list[np.ndarray],
    centers: np.ndarray,
) -> list[np.ndarray]:
    """Per-sector warped (deformed) point sets, for plotting: each sector's
    current warp applied to its undeformed points about its center."""
    return _warp_ragged(model, params, point_lists, centers)


def advance_domain(
    state: _TrackState,
    cfg: SequenceConfig,
    model: FittingModel,
) -> None:
    """Move the undeformed domain as the deformation description says."""
    deform = cfg.deformation
    if deform == DeformationDescription.EULERIAN:
        return
    # Lagrangian family: the domain follows the material.
    with trace_region(SEQ_ADVANCE):
        state.und_global_center = state.def_global_center.copy()
        state.und_global_angle = state.def_global_angle
        state.und_e = state.def_e.copy()
        state.und_global_e = state.def_global_e
        state.past_und_center = state.und_center.copy()
        new_center = state.def_center.copy()
        if deform == DeformationDescription.LAGRANGIAN:
            # Whole-pixel translate by the rounded center offset.
            offset = new_center - state.past_und_center
            state.und_points = [
                _round_points(p + offset[i])
                for i, p in enumerate(state.und_points)
            ]
            if state.und_contours is not None:
                state.und_contours = [
                    _round_points(c + offset[i])
                    for i, c in enumerate(state.und_contours)
                ]
        else:  # strict Lagrangian: every point warped individually
            state.und_points = _warp_ragged(
                model, state.params, state.und_points, state.und_center
            )
            if state.def_contours is not None:
                state.und_contours = [c.copy() for c in state.def_contours]
        state.und_center = new_center
        state.und_angle = state.def_angle.copy()


def advance_guess(state: _TrackState, cfg: SequenceConfig) -> None:
    """Constant-velocity extrapolation of the initial guess for Eulerian +
    reference First; the previous result otherwise."""
    if (
        cfg.deformation == DeformationDescription.EULERIAN
        and cfg.reference == ReferenceImage.FIRST
    ):
        state.guess = state.params + (state.params - state.prev_params)
    else:
        state.guess = state.params.copy()
    state.prev_params = state.params.copy()


def update_results(
    state: _TrackState,
    model: FittingModel,
    params: np.ndarray,
    und_center: np.ndarray,
    n_points: np.ndarray,
) -> None:
    """Post-solve per-sector and point-weighted global updates."""
    state.params = params
    state.und_center = und_center
    # The warp of the sector center about itself is its (u, v) translate.
    state.def_center = und_center + _uv(params)
    state.def_angle = _rotation_angle_np(model, params) + state.und_angle
    if state.und_contours is not None:
        # Contours warp about the undeformed global center.
        gc = np.tile(
            np.asarray(state.und_global_center, np.float32),
            (params.shape[0], 1),
        )
        state.def_contours = _warp_ragged(
            model, params, state.und_contours, gc
        )
    state.def_e = np.zeros(params.shape[0], np.float32)
    n = n_points.astype(np.float64)
    total = max(n.sum(), 1.0)
    state.def_global_angle = float((state.def_angle * n).sum() / total)
    state.def_global_e = float((state.def_e * n).sum() / total)
    state.def_global_center = (
        (state.def_center * n[:, None]).sum(axis=0) / total
    ).astype(np.float32)


def _rotation_angle_np(model: FittingModel, params: np.ndarray) -> np.ndarray:
    """Rotation angle of each sector's warp (the reference's formula)."""
    if model == FittingModel.UVQ:
        return params[:, 2].astype(np.float32)
    if model == FittingModel.AFFINE:
        return np.arctan2(
            params[:, 4] - params[:, 3], params[:, 2] + params[:, 5] + 2.0
        ).astype(np.float32)
    return np.zeros(params.shape[0], np.float32)


def _uv(params: np.ndarray) -> np.ndarray:
    uv = np.zeros((params.shape[0], 2), np.float32)
    uv[:, 0] = params[:, 0]
    if params.shape[1] >= 2:
        uv[:, 1] = params[:, 1]
    return uv


@traced(SEQ_RUN)
def run_sequence(
    frames,
    point_lists: list[np.ndarray],
    cfg: SequenceConfig,
    global_guess: np.ndarray | None = None,
    centers: np.ndarray | None = None,
    global_center: np.ndarray | None = None,
    contours: list | None = None,
    per_sector_guess: np.ndarray | None = None,
    should_stop=None,
    meter=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    on_frame=None,
    device=None,
    mesh: Mesh | None = None,
) -> list[FrameRecord]:
    """Correlate a frame sequence.

    Args:
      frames: a sequence of [H, W, C] images with uint8 values (numpy
        arrays, float32 or uint8), length >= 2: a list, or any object with
        __len__ and __getitem__.  If it has `uint8_source = True`, chunks
        are staged to the device as uint8.
      point_lists: per-sector level-0 undeformed points (frame 0).
      cfg: sequence configuration.
      global_guess: [NP] global initial guess (default zeros).
      centers: [S, 2] explicit sector centers (rectangular domains), or None
        for the per-sector point means.
      global_center: [2] domain global center (default: mean of centers).
      contours: optional per-sector contour polylines to track.
      per_sector_guess: optional [S, 2] per-sector frame-0 (u, v) seeds.
      should_stop: optional () -> bool cooperative-cancel poll.
      meter: optional utils.profiling.SolveMeter.
      checkpoint_path: optional .npz path; if it exists the run resumes from
        it, and the state is saved every `checkpoint_every` completed frame
        pairs and at a stop or cancel.
      checkpoint_every: checkpoint period in frame pairs.
      on_frame: optional callback(record) after each frame pair.
      device: where to solve (default: engine.resolve_device, the card
        unless the backend is "torch"; raises without one).
      mesh: optional parallel.mesh.Mesh; every rank passes the same
        arguments, the subsets shard over the ranks (engine.correlate) and
        every rank returns the whole records.  should_stop is called on
        rank 0 only; the checkpoint is written by rank 0 only.

    Returns:
      One FrameRecord per frame pair solved.
    """
    n_frames = len(frames)
    check_channels(cfg.solver, np.shape(frames[0]), "the frames")
    solver = cfg.solver
    model = solver.model
    num_params = solver.num_params
    device = resolve_device(solver, device, mesh=mesh)
    should_stop = broadcast_flag(mesh, should_stop)
    if global_guess is None:
        global_guess = np.zeros(num_params, np.float32)
    if global_center is None:
        cs = (
            np.asarray(centers)
            if centers is not None
            else np.array([p.mean(axis=0, dtype=np.float64)
                           for p in point_lists])
        )
        global_center = cs.mean(axis=0)

    start_frame = 0
    records: list[FrameRecord] = []
    state = None
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        from correlation_tpu_torch.utils.checkpoint import load_checkpoint

        start_frame, state, records = load_checkpoint(checkpoint_path)
    if state is None:
        state = initial_track_state(
            point_lists, centers, global_center, global_guess, model,
            contours=contours, per_sector_uv=per_sector_guess,
        )

    stop = solver.pyramid.stop
    total_pairs = n_frames - 1
    batch = None

    def save_ckpt(next_frame: int) -> None:
        if checkpoint_path is not None:
            from correlation_tpu_torch.utils.checkpoint import save_checkpoint

            if mesh is None or mesh.rank == 0:
                save_checkpoint(checkpoint_path, next_frame, state, records)
            barrier(mesh)

    def batch_for(points_moved: bool):
        # Padded shapes grow once and then hold across frames.
        nonlocal batch
        if batch is None or points_moved:
            with trace_region(SEQ_MAKE_BATCH):
                batch = make_batch(
                    state.und_points,
                    state.und_center if state.explicit_centers else None,
                    stop,
                    pad_to=state.pad_to,
                ).to_device(device)
            state.pad_to = [a.shape[1] for a in batch.xy]
        return batch

    def emit(frame, params, guess, chi, iterations, errors,
             und_center, n_points):
        update_results(state, model, params, und_center, n_points)
        state.chi = chi.copy()
        state.iterations = iterations.copy()
        records.append(
            FrameRecord(
                frame=frame,
                params=params,
                initial_guess=guess.copy(),
                chi=chi,
                iterations=iterations,
                error=errors,
                n_points=n_points,
                und_center=und_center,
                def_center=state.def_center.copy(),
                und_angle=state.und_angle.copy(),
                def_angle=state.def_angle.copy(),
                und_global_center=state.und_global_center.copy(),
                def_global_center=state.def_global_center.copy(),
                und_global_angle=state.und_global_angle,
                def_global_angle=state.def_global_angle,
                und_contours=(
                    [c.copy() for c in state.und_contours]
                    if state.und_contours is not None
                    else None
                ),
                def_contours=(
                    [c.copy() for c in state.def_contours]
                    if state.def_contours is not None
                    else None
                ),
                und_e=state.und_e.copy(),
                def_e=state.def_e.copy(),
                und_global_e=state.und_global_e,
                def_global_e=state.def_global_e,
                und_points=(
                    [p.copy() for p in state.und_points]
                    if cfg.record_points
                    else None
                ),
            )
        )
        if on_frame is not None:
            on_frame(records[-1])

    def measured(num_subsets: int):
        return (meter.measure(num_subsets) if meter is not None
                else contextlib.nullcontext())

    chunked = (
        cfg.deformation
        in (DeformationDescription.EULERIAN, DeformationDescription.LAGRANGIAN)
        and cfg.frame_chunk > 1
        and total_pairs - start_frame > 1
    )
    if chunked:
        _run_chunked(frames, cfg, state, batch_for(False), start_frame,
                     device, mesh, emit, save_ckpt, measured, should_stop,
                     checkpoint_path is not None, checkpoint_every)
        return records

    pyramids: dict[int, list] = {}

    def pyramid_of(idx: int):
        if idx not in pyramids:
            img = torch.from_numpy(np.asarray(frames[idx], np.float32))
            pyramids[idx] = build_pyramid(img.to(device), stop)
            # At most three pyramids (und / def / next) stay resident.
            live = {idx, idx - 1,
                    0 if cfg.reference == ReferenceImage.FIRST else -1}
            for k in [k for k in pyramids if k not in live]:
                if len(pyramids) > 3:
                    pyramids.pop(k)
        return pyramids[idx]

    for frame in range(start_frame, total_pairs):
        if should_stop is not None and should_stop():
            save_ckpt(frame)
            break
        und_idx = 0 if cfg.reference == ReferenceImage.FIRST else frame
        if frame > 0:
            advance_domain(state, cfg, model)
            advance_guess(state, cfg)
        points_moved = (
            frame > start_frame
            and cfg.deformation != DeformationDescription.EULERIAN
        )
        subsets = batch_for(points_moved)
        with measured(subsets.num_subsets), trace_region(SEQ_PAIR):
            result = correlate(solver, pyramid_of(und_idx),
                               pyramid_of(frame + 1), subsets, state.guess,
                               device=device, mesh=mesh)
            params, und_center, n_points, errors, chi, iterations = (
                t.cpu().numpy() for t in (
                    result.params, result.center, result.n_points,
                    result.error, result.chi, result.iterations)
            )
        if cfg.error_mode == ErrorMode.STOP_FRAME:
            # An errored sector's chained state does not advance this frame;
            # its record keeps the previous chi / iterations.
            bad = errors != int(ErrorCode.NONE)
            params = np.where(bad[:, None], state.params, params)
            chi = np.where(bad, state.chi, chi)
            iterations = np.where(bad, state.iterations, iterations)
        with trace_region(SEQ_EMIT):
            emit(frame, params, state.guess, chi, iterations, errors,
                 und_center, n_points)
        stop_now = (cfg.error_mode == ErrorMode.STOP_ALL
                    and bool((errors != int(ErrorCode.NONE)).any()))
        if stop_now or (frame + 1) % max(checkpoint_every, 1) == 0:
            save_ckpt(frame + 1)
        if stop_now:
            break
    return records


def _run_chunked(frames, cfg, state, batch, start_frame, device, mesh,
                 emit, save_ckpt, measured, should_stop, checkpointing,
                 checkpoint_every):
    """run_sequence's chunked path: frame_chunk pairs per
    engine.correlate_frames call.  The domain advance of the Lagrangian
    description runs inside the chunk (the engine carries the offsets) and
    is mirrored here on the host, so that records, checkpoints and resume
    state follow the device exactly.

    The loop is the JAX package's pipelined one (correlation_tpu/
    sequence.py:666-760): chunk i + 1 is dispatched, seeded from chunk i's
    carry on the device, before chunk i's results are fetched, and the
    stack of chunk i + 2 is staged meanwhile.  On the card the stack goes
    up from pinned memory and the packed results come down into pinned
    memory, both without waiting (non_blocking), so the host's staging
    and record keeping overlap the card's solve.  A stop (STOP_ALL, or a
    should_stop while a chunk's records are emitted) drops the chunk in
    flight, as in JAX."""
    total_pairs = len(frames) - 1
    solver = cfg.solver
    model = solver.model
    num_p = solver.num_params
    lagr = cfg.deformation == DeformationDescription.LAGRANGIAN
    ref_first = cfg.reference == ReferenceImage.FIRST
    stop_frame = cfg.error_mode == ErrorMode.STOP_FRAME
    stage_u8 = bool(getattr(frames, "uint8_source", False))
    dtype = np.uint8 if stage_u8 else np.float32
    on_card = torch.device(device).type == "cuda"
    und0 = np.asarray(frames[0], dtype) if ref_first else None
    und_center = np.asarray(state.und_center, np.float32)
    n_points = batch.mask[0].sum(dim=-1).to(torch.int32).cpu().numpy()
    host_off = np.zeros((len(state.und_points), 2), np.float32)
    carry = None

    @traced(SEQ_STAGE)
    def stage(frame):
        """(k, stack) of the chunk starting at `frame`, its copy to the
        device started."""
        k = min(cfg.frame_chunk, total_pairs - frame)
        base = und0 if ref_first else np.asarray(frames[frame], dtype)
        stack = torch.from_numpy(np.stack(
            [base] + [np.asarray(frames[frame + j + 1], dtype)
                      for j in range(k)]
        ))
        if on_card:
            return k, stack.pin_memory().to(device, non_blocking=True)
        return k, stack.to(device)

    def dispatch(frame, staged):
        """Enqueue the chunk starting at `frame` on its staged stack and
        the copy of its packed results to the host: (frame, k, results,
        event), where the event marks the copy's end (None off the
        card)."""
        nonlocal carry
        k, stack = staged
        if carry is None:
            # The host state seeds the chain, fresh or resumed, as in JAX.
            seeds = dict(p_seed=state.params, prev_seed=state.prev_params,
                         chi_seed=state.chi, it_seed=state.iterations)
            if lagr:
                seeds["ucen_seed"] = state.und_center
        else:
            seeds = dict(zip(
                ("p_seed", "prev_seed", "chi_seed", "it_seed", "off_seed",
                 "ucen_seed"), carry))
        with measured(k * batch.num_subsets), trace_region(SEQ_DISPATCH):
            out = correlate_frames(
                solver, stack, batch, guess0=state.guess,
                reference_first=ref_first, stop_frame=stop_frame,
                lagrangian=lagr, float_centers=state.explicit_centers,
                first_chunk=frame == 0, device=device, mesh=mesh, **seeds,
            )
            carry = out["carry"]
            packed, done = out["packed"], None
            if packed.is_cuda:
                host = torch.empty(packed.shape, dtype=packed.dtype,
                                   pin_memory=True)
                packed = host.copy_(packed, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
        return frame, k, packed, done

    @traced(SEQ_FETCH)
    def fetch(packed, done):
        """The packed results as a NumPy array of their own, once their
        copy has landed."""
        with measured(0):  # a wait, counted as solver time
            if done is not None:
                done.synchronize()
            return packed.numpy().copy()

    @traced(SEQ_EMIT)
    def emit_chunk(frame, k, packed, halt):
        """Emit a solved chunk's records and save the checkpoint where
        due; False when a stop (STOP_ALL or should_stop) ends the run."""
        nonlocal host_off
        params_k = packed[..., :num_p]
        chi_k = packed[..., num_p]
        it_k = packed[..., num_p + 1].astype(np.int32)
        err_k = packed[..., num_p + 2].astype(np.int32)
        stop_now = cancelled = False
        emitted = 0
        for j in range(k):
            if j > 0 and should_stop is not None and should_stop():
                cancelled = True
                break
            # The chunk's guess chain and Lagrangian domain advance,
            # recomputed on the host in the device's float32 order.
            if frame + j == 0:
                guess_j = state.guess.copy()
            elif lagr:
                if not state.explicit_centers:
                    host_off = host_off + np.floor(_uv(state.params) + 0.5)
                advance_domain(state, cfg, model)
                if not state.explicit_centers:
                    state.und_center = und_center + host_off
                guess_j = state.params.copy()
            elif ref_first:
                guess_j = state.params + (state.params - state.prev_params)
            else:
                guess_j = state.params.copy()
            if frame + j != 0:
                state.prev_params = state.params.copy()
            emit(frame + j, params_k[j], guess_j, chi_k[j], it_k[j], err_k[j],
                 state.und_center if lagr else und_center, n_points)
            emitted += 1
            if (cfg.error_mode == ErrorMode.STOP_ALL
                    and (err_k[j] != int(ErrorCode.NONE)).any()):
                stop_now = True
                break
        next_frame = frame + emitted
        ends = stop_now or cancelled or halt
        if (
            ends or next_frame >= total_pairs
            or (checkpointing
                and any((frame + j + 1) % max(checkpoint_every, 1) == 0
                        for j in range(emitted)))
        ):
            save_ckpt(next_frame)
        return not (stop_now or cancelled)

    # should_stop is polled for the next chunk before the pending one is
    # fetched and emitted; the next chunk is dispatched in between.
    frame, staged, pending, halt = start_frame, stage(start_frame), None, False
    while pending is not None or (frame < total_pairs and not halt):
        out = None
        if frame < total_pairs and not halt:
            if should_stop is not None and should_stop():
                halt = True
                if pending is None:
                    save_ckpt(frame)
            else:
                out = dispatch(frame, staged)
                if frame + out[1] < total_pairs:
                    staged = stage(frame + out[1])
        if pending is not None:
            pframe, pk, packed, done = pending
            if not emit_chunk(pframe, pk, fetch(packed, done), halt):
                return  # the chunk in flight is dropped
        pending = out
        if out is not None:
            frame += out[1]


def run_sequence_from_files(
    paths: list[str],
    point_lists: list[np.ndarray],
    cfg: SequenceConfig,
    monochrome: bool = True,
    io_stats: dict | None = None,
    **kwargs,
) -> list[FrameRecord]:
    """run_sequence over image files, decoded ahead in the background with
    a bounded cache (io.FramePrefetcher).  Decoded frames are uint8-valued,
    so chunks are staged to the device as uint8.

    io_stats: optional dict; receives {"max_cached": N}, the high-water
    mark of decoded frames held at once."""
    from correlation_tpu_torch.io import FramePrefetcher

    # Before any decoding: raises where the default device is missing.
    kwargs["device"] = resolve_device(cfg.solver, kwargs.get("device"),
                                      mesh=kwargs.get("mesh"))
    # The chunked path stages frame_chunk frames at a time.
    ahead = max(
        2,
        cfg.frame_chunk + 1
        if cfg.deformation != DeformationDescription.STRICT_LAGRANGIAN
        else 2,
    )
    prefetcher = FramePrefetcher(paths, monochrome=monochrome, ahead=ahead)

    class _LazyFrames:
        uint8_source = True

        def __len__(self):
            return len(paths)

        def __getitem__(self, idx):
            return prefetcher.get(idx)

    try:
        return run_sequence(_LazyFrames(), point_lists, cfg, **kwargs)
    finally:
        if io_stats is not None:
            io_stats["max_cached"] = prefetcher.max_cached
        prefetcher.close()
