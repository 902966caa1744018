"""Per-phase wall-time split of the dense-grid solve on the card.

Port of experiments/profile_bench.py.  At the bench's shapes
(problems.dense_grid_problem(4096): a 1024x1024 speckle pair shifted one
row, 4096 21x21 subsets, AFFINE / BICUBIC, pyramid levels 2-1-0) it times
  - correlate on one pair (mean of 5 after a warm call),
  - prepare_levels (the per-pair, iteration-invariant work),
  - solve_level per pyramid level, with the mean iterations reached: its
    wall (host issue and the card's work, to the last kernel's end) and
    the host's issue alone (the call returns before the card is done,
    since the LM loop reads nothing back; one call into the kernel
    library issues the level's steps), each also per LM iteration (the
    initial step and max_iterations + 2 iterations a level),
  - the fused assembly (K1) per level, 20 launches chained through their
    parameters (each adds 1e-9 b to them), replayed from a CUDA graph,
  - ops/solve.lm_delta alone, 50 calls chained the same way (from a CUDA
    graph, and issued eagerly),
  - ops/solve.lm_step, the LM-step kernel, on 4096 AFFINE subsets of
    problems.lm_step_problem, the whole list with its length on the
    device and the next list written, as the LM loop launches it (from a
    CUDA graph of 50, and issued eagerly), beside lm_delta,
  - an LM iteration whose list is empty, as the per-step wrappers issue
    it: K1 and the LM step over an empty device list at level 0, every
    launch exiting at once (the step writing a zero count): device time from a
    CUDA graph of 20, and the host's issue a call; beside it the device
    time of the form before the step wrote the next list, active_list +
    K1 + the step, from a graph,
  - the device's busy share of an 8-pair chunk (correlate_frames):
    torch.profiler's device time of every kernel and copy over the
    chunk's wall.
Eager calls are timed between two CUDA events after a warm call
(utils/profiling.cuda_time_ms): the host's issue and its waits
included, as a caller sees them.

Run on a machine with an NVIDIA GPU:

  python -m correlation_tpu_torch.experiments.profile_bench

The first line gives the card's name and power limit (nvidia-smi).  There
is no CPU fallback: without a CUDA device it raises.
"""

from __future__ import annotations

import time

import numpy as np
import torch

NUM_SUBSETS = 4096


def main() -> dict[str, float]:
    """Print one line a phase and return the times, {phase: ms}."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_bench runs on a CUDA device; none is "
                           "available")
    from correlation_tpu_torch.engine import (
        active_list,
        compute_level_statics,
        correlate,
        correlate_frames,
        prepare_levels,
        solve_level,
    )
    from correlation_tpu_torch.models.warp import translate_params
    from correlation_tpu_torch.ops import assemble_v2 as v2
    from correlation_tpu_torch.ops.pyramid import build_pyramid
    from correlation_tpu_torch.ops import solve as lm
    from correlation_tpu_torch.ops.solve import lm_delta
    from correlation_tpu_torch.problems import (
        dense_grid_problem,
        lm_step_problem,
    )
    from correlation_tpu_torch.utils.profiling import (
        card_name_and_power,
        cuda_time_ms,
        graph_ms,
    )

    dev = torch.device("cuda")
    cfg, und, dfm, batch, params0 = dense_grid_problem(NUM_SUBSETS)
    print(f"profile_bench ({card_name_and_power()}): {NUM_SUBSETS} subsets, "
          f"{cfg.model.name} / {cfg.interpolation.name}, levels "
          f"{cfg.pyramid.levels_coarse_to_fine()}")
    pair = torch.as_tensor(np.stack([und, dfm])[..., None], device=dev)
    pyr = build_pyramid(pair, cfg.pyramid.stop)
    und_pyr = [level[0] for level in pyr]
    def_pyr = [level[1] for level in pyr]
    statics = compute_level_statics(cfg, batch, def_pyr)
    print("statics:", statics)
    gb = batch.to_device(dev)
    p0 = torch.as_tensor(params0, device=dev)
    times = {}

    times["correlate"] = cuda_time_ms(
        lambda: correlate(cfg, und_pyr, def_pyr, batch, p0, device=dev), 5)
    print(f"total correlate:        {times['correlate']:9.3f} ms")

    def prep():
        return prepare_levels(cfg, und_pyr, def_pyr, gb.xy, gb.mask,
                              gb.center0, statics)

    times["prepare_levels"] = cuda_time_ms(prep, 10)
    print(f"prepare_levels:         {times['prepare_levels']:9.3f} ms")

    levels = prep()
    schedule = cfg.pyramid.levels_coarse_to_fine()
    skip = torch.zeros(NUM_SUBSETS, dtype=torch.bool, device=dev)
    p, prev = p0, 0
    for lvl in schedule:
        p_l = translate_params(p, prev, lvl)

        def solve(lvl=lvl, p_l=p_l):
            return solve_level(cfg, levels[lvl], p_l, skip, statics[lvl])

        wall = times[f"solve_level_L{lvl}"] = cuda_time_ms(solve, 5)
        torch.cuda.synchronize()
        lm.resolve_launches()
        launches = lm.LAUNCHES
        t0 = time.perf_counter()
        res = solve()
        issue = times[f"issue_L{lvl}"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        lm.resolve_launches()
        loops = lm.LAUNCHES - launches  # the initial step and the loop's
        print(f"solve_level L{lvl}:       {wall:9.3f} ms wall, {issue:.3f} ms "
              f"host issue  (iters reached: {res.reached.float().mean():.2f}; "
              f"{loops} LM steps, {wall / loops:.4f} ms wall and "
              f"{issue / loops:.4f} ms issue each)")
        p = torch.where(~res.init_fail[:, None], res.params, p_l)
        prev = lvl

    # The fused assembly per level, chained through its parameters.
    num_p = cfg.num_params
    for lvl in schedule:
        la, st = levels[lvl], statics[lvl]
        pp = translate_params(p0, 0, lvl).clone()

        def step(la=la, st=st, pp=pp):
            out = v2.fused_assemble(
                cfg.model, cfg.interpolation, st.tile_h, st.tile_w, st.img_h,
                st.img_w, la.def_img, la.pix, la.center, pp, la.bbox)
            pp.add_(1e-9 * out[:, :num_p, num_p])

        times[f"assembly_L{lvl}"] = graph_ms(step, 20)
        print(f"assembly L{lvl} (chained): {times[f'assembly_L{lvl}']:9.3f} "
              "ms/assembly (CUDA graph of 20)")

    # lm_delta alone, chained.
    a = torch.eye(num_p, device=dev).repeat(NUM_SUBSETS, 1, 1) * 50.0
    bb = torch.ones((NUM_SUBSETS, num_p), device=dev)
    lam = torch.full((NUM_SUBSETS,), 1e-4, device=dev)
    scal = torch.full((NUM_SUBSETS,), 1.0 / 441, device=dev)

    def lm_step():
        bb.add_(1e-9 * lm_delta(a, bb, lam, scal))

    times["lm_delta"] = graph_ms(lm_step, 50)
    times["lm_delta_eager"] = cuda_time_ms(lm_step, 50)
    print(f"lm_delta (chained):     {times['lm_delta']:9.3f} ms/call (CUDA "
          f"graph of 50), {times['lm_delta_eager']:.3f} ms/call eager")

    # The LM-step kernel on a whole list of 4096 subsets, state in place.
    step_cfg, arrays, out, *rest, img_hw = lm_step_problem(
        cfg.model, NUM_SUBSETS)
    state = lm.LMState(**{k: torch.as_tensor(v, device=dev)
                          for k, v in arrays.items()})
    out, scaling, n_pts, bbox, center = (torch.as_tensor(a, device=dev)
                                         for a in (out, *rest))
    every = torch.arange(NUM_SUBSETS, dtype=torch.int32, device=dev)
    whole = torch.tensor([NUM_SUBSETS], dtype=torch.int32, device=dev)
    nxt = torch.empty(NUM_SUBSETS, dtype=torch.int32, device=dev)
    nxt_count = torch.empty(1, dtype=torch.int32, device=dev)

    def kernel_step():
        lm.lm_step(step_cfg, state, out, every, whole, scaling, n_pts, bbox,
                   center, img_hw, False, nxt, nxt_count)

    times["lm_step"] = graph_ms(kernel_step, 50)
    times["lm_step_eager"] = cuda_time_ms(kernel_step, 50)
    print(f"lm_step kernel:         {times['lm_step']:9.4f} ms/call (CUDA "
          f"graph of 50), {times['lm_step_eager']:.4f} ms/call eager; "
          f"lm_delta alone from a graph is "
          f"{times['lm_delta'] / times['lm_step']:.1f}x it")

    # An LM iteration whose list is empty, at level 0: as the loop issues
    # it (K1 and the step over the previous step's empty list), and the
    # form before the step wrote the next list (active_list first).
    la, st0 = levels[0], statics[0]
    none = torch.zeros(NUM_SUBSETS, dtype=torch.bool, device=dev)
    l0_state = lm.LMState.start(cfg, p0)
    l0_scaling = 1.0 / la.n_points.clamp(min=1.0)
    lists = torch.zeros((2, NUM_SUBSETS), dtype=torch.int32, device=dev)
    counts = torch.zeros((2, 1), dtype=torch.int32, device=dev)

    def iteration(idx, count, nxt=(None, None)):
        asm = v2.fused_assemble(
            cfg.model, cfg.interpolation, st0.tile_h, st0.tile_w, st0.img_h,
            st0.img_w, la.def_img, la.pix, la.center, l0_state.p_cur,
            la.bbox, idx, count)
        lm.lm_step(cfg, l0_state, asm, idx, count, l0_scaling, la.n_points,
                   la.bbox, la.center, la.img_hw, False, *nxt)

    def empty_iteration():
        iteration(lists[0], counts[0], (lists[1], counts[1]))

    times["empty_iteration"] = graph_ms(empty_iteration, 20)
    times["empty_iteration_sorted"] = graph_ms(
        lambda: iteration(*active_list(none)), 20)
    empty_iteration()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        empty_iteration()
    times["empty_iteration_issue"] = (time.perf_counter() - t0) * 1e3 / 50
    torch.cuda.synchronize()
    print(f"empty LM iteration L0:  {times['empty_iteration']:9.4f} ms device "
          f"(K1 + the step, CUDA graph of 20), "
          f"{times['empty_iteration_issue']:.4f} ms host issue; with "
          f"active_list first (the form before the step wrote the list): "
          f"{times['empty_iteration_sorted']:.4f} ms device")

    busy = chunk_busy_share(cfg, und, dfm, batch, params0, dev,
                            correlate_frames)
    if busy is not None:
        times.update(busy)
    return times


def chunk_busy_share(cfg, und, dfm, batch, params0, dev, correlate_frames,
                     pairs: int = 8):
    """{"chunk_wall_ms", "chunk_device_ms", "chunk_busy_share"} of one
    chained solve of `pairs` pairs under torch.profiler (after a warm
    run), or None when the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    stack = torch.as_tensor(np.stack([und] + [dfm] * pairs)[..., None]
                            .astype(np.uint8), device=dev)
    gb = batch.to_device(dev)
    p0 = torch.as_tensor(params0, device=dev)
    correlate_frames(cfg, stack, gb, p0, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        correlate_frames(cfg, stack, gb, p0, device=dev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device_us = sum(getattr(e, "self_device_time_total", 0.0)
                    for e in prof.key_averages())
    if not device_us:
        print(f"chunk busy share: not measured (the profiler reports no "
              f"device time; chunk wall {wall:.3f} ms)")
        return None
    share = device_us / 1e3 / wall
    print(f"chunk busy share ({pairs} pairs): device {device_us / 1e3:.3f} "
          f"ms of {wall:.3f} ms wall = {share:.1%} busy (torch.profiler)")
    return {"chunk_wall_ms": wall, "chunk_device_ms": device_us / 1e3,
            "chunk_busy_share": share}


if __name__ == "__main__":
    main()
