#!/usr/bin/env python3
"""Smoke run of correlation_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one informational line each:
  1. device: the card's name and `nvidia-smi` name / power limit;
  2. build: compile csrc/*.cu (fused_assemble.cu, lm_step.cu and the
     experiment kernels; one nvcc a source, in parallel) into one library
     in build/ and turn TF32 off for float32 matmuls and cuDNN;
  3. kernel vs plain: the CUDA fused assembly against its plain PyTorch
     version on the card, bit for bit, over the model x interpolation x
     channel grid and at the dense-grid problem's level 0/1/2 shapes
     (4096 subsets; the block path at level 0, the warp path at 1-2),
     with one subset warped out of the image, at 248x248 and 320x320
     tiles that shared memory cannot hold (the global-tile path, both
     paths, C = 1 and 3), and with 49x49 subsets (the split path: 5 spans,
     the last ragged; C = 1 and 3); then the LM-step kernel
     (csrc/lm_step.cu) against its plain version, bit for bit (a NaN as a
     NaN), on 4096 subsets of every branch (problems.lm_step_problem:
     NaN and out-of-image rows among them), four models x both modes,
     through a shuffled list whose last quarter lies past its device
     length and must stay untouched, the next list it writes equal to the
     plain version's; its next lists over problems.lm_step_list's lists
     (whole, with gaps, sparse across the grid's blocks, the last subset
     alone) at 1, 37, 4099 and 16384 subsets, with every row's role,
     every subset stopping and none stopping, equal to the plain
     version's and to engine.active_list of the flags the step leaves;
     and K1 with the list's length on the device at the dense grid's
     three levels against its plain version on idx[:count], counts 0, 1,
     30% and all;
  4. pyramid: the pyramid built on the card equals the CPU pyramid;
  5. slice: correlate_frames on the dense-grid problem (4096 21x21
     subsets, AFFINE/BICUBIC, levels 2-1-0, 64 chained frame pairs) on
     the card, checked for finite parameters, the hard-error fraction, the
     recovered shift (u, v) = (0, 1) and kernel launches at every level
     (launches and the list's capacity a launch per level: K1's grid
     covers the list's room, not its length), with the stack, the subsets
     and the guesses staged on the card first and the chunk enqueued
     under CUDA's sync debug mode "error" (any host sync raises), the
     LM-step kernel launched for the initial step and max_iterations + 2
     iterations at every level of every pair, active_list called once a
     level of every pair (the step writes the later lists), and no
     kernel launcher calling a synchronising CUDA function (read from
     the sources); then
     the first 256 subsets for 2 frames through the plain version on the
     CPU;
  6. time: the 64-frame chunk after a warm-up, and one assembly per level
     by the kernel (replayed from a CUDA graph, and called eagerly through
     its wrapper) and by the plain version; the LM-step kernel on 4096
     and 16384 AFFINE subsets from a CUDA graph, from HBM, as the loop
     launches it (device length, next list) and on a host list, its
     plain version, and lm_delta alone from a graph (its yardstick);
  7. experiment kernels: the entry points of experiments.exp_gather and
     experiments.exp_matmul_overhead at the JAX scripts' sizes, then each
     kernel against its plain version (the gather bit for bit, the stages
     within 1e-5 of the sum of |terms| of each output, gram_loop against
     gram_big, loop against batched bit for bit), with device times
     replayed from a CUDA graph, as K1's, and eager times through the
     wrapper; inputs that fit in the 50 MB L2 (the Grams', the gather's)
     are timed from HBM by rotating copies, beside their L2-resident time;
     beside each kernel, the one PyTorch call that computes its function,
     where there is one (torch.bmm with out_dtype, einsum, take_along_dim);
     beside the gather, a kernel that does nothing (the launch floor),
     timed the same way;
  8. sequence: run_sequence on 32 pairs of drifting 1024x1024 uint8 frames
     (4096 21x21 subsets, AFFINE/BICUBIC, levels 2-1-0) from an in-memory
     uint8 source, Eulerian-First and Lagrangian-Previous chunked 32 pairs
     a call, and strict-Lagrangian pair by pair over 4 pairs; each checked
     for finite parameters, the hard-error fraction, the known motion and
     kernel launches, and its first 256 subsets x 2 pairs against the
     plain version on the CPU;
  9. domains, on the same drifting frames, AFFINE/BICUBIC, levels 2-1-0:
     an annulus of 8 x 64 = 512 sectors (annular_problem) over 32 pairs,
     Eulerian-First and Lagrangian-Previous, and a freehand blob of about
     7 x 10^4 px (blob_problem), split over several blocks at every
     level (at level 0 its tile exceeds shared memory), over 8 pairs,
     each checked as in phase 8 (the CPU on the outermost ring's 64
     sectors, or the blob); the blob's assembly at each level timed as in
     phase 6, and again in one block a subset (chunk = p_len, through
     experiments.design_sweep.k1_design), both bit for bit with the
     plain version of their order; then, on pair (0, 1),
     a 16 x 16 grid of 21x21 rectangles, the annulus and the blob:
     correlate_many against three correlate calls (bit for bit) and the
     CPU, and combine_batches + split_result against the separate solves
     (error codes identical, params over 5e-5 named, and each domain
     padded to the combined lengths equal to its share bit for bit), with
     one assembly of the combined batch at each level timed both ways.
 10. field: the coefficient-field assembly (backend "field", no hand
     kernel: PyTorch elementwise operations in a fixed order): the fields of
     the dense-grid pair's deformed levels (1024^2 / 512^2 / 256^2) for the
     three interpolations and one field assembly of the 4096 subsets per
     level, card against CPU bit for bit; the 64-frame chunk of phase 5 on
     the field path with phase 5's checks, no K1 launch, and card vs CPU
     on 256 subsets x 2 frames; its solves/s and per-level assembly and
     field times beside phase 6's tiled readings; a 4-channel version of
     the drifting frames (256 subsets x 4 pairs) on the field path, card
     against CPU bit for bit; and a second reading of K1 at each level;
 11. surface: `python -m correlation_tpu_torch.cli` as a subprocess on the
     card: 8 drifting 1024x1024 PNG frames (written under build/), a
     16 x 16 rectangle grid with --report, --plot-dir --plot-points and
     --profile, checked against the known motion, the overlay files and the
     trace file; then --auto-guess on a pair shifted by 40 px, beyond the
     3-level pyramid's capture range, which must recover the shift within
     0.02 px; and the first run again with --shard under torchrun (NCCL, a
     world of one), whose report must equal the unsharded one; the first
     run again under a JAX command line, --backend pallas --compact-stages
     0 ("pallas" takes "auto", the fused kernel), whose report must equal
     the first byte for byte; and --cpu --backend cuda on the same frames,
     which must exit 2 with resolve_device's message and no traceback;
     with each wall time;
 12. mesh: the subset-sharded solves and the pixel-sharded assembly over
     torch.distributed (correlation_tpu_torch.parallel), each rank a
     subprocess of this script (--mesh-worker) under a timeout: (a) NCCL,
     a world of one on cuda:0, and (b) gloo, two ranks sharing cuda:0
     (NCCL refuses two ranks on one card), each solving phase 5's chunk
     with mesh= (K1 launched at every level on every rank, the result on
     the card and equal bit for bit to phase 5's, passed through a file
     under build/), first checked, then timed (the world of one four
     times in turns with the unsharded chunk in its own process); with
     gloo also phase 8's three sequence modes with mesh=, equal bit for
     bit to phase 8's records, the Lagrangian one again cancelled by a
     should_stop polled on rank 0 alone (its one record equal to phase
     8's first), and assemble_pixel_sharded on the blob's level-0
     pixels, within JAX's test tolerances of the unsharded field
     assembly on the card and identical on a second call; each wall and
     the chunk's solves/s beside phase 6's;
 13. sep: the separable-tile assembly (backend "sep", JAX's "xla_sep"; no
     hand kernel: PyTorch elementwise operations and gathers in a fixed
     order): one assembly of the 4096 subsets per level at phase 6's
     parameters, card against CPU bit for bit, timed from a CUDA graph
     beside K1's (phase 6) and the field's (phase 10); the 64-frame chunk
     of phase 5 on the sep path with phase 5's checks, no K1 launch, card
     == CPU bit for bit on 256 subsets x 2 frames, its solves/s beside
     phase 6's, and whether it equals phase 5's K1 chunk (the dense grid's
     rectangles give both rules the same tiles); the 4-channel frames of
     phase 10 under "auto", which takes the sep path, card == CPU bit for
     bit;
 14. profile: experiments.profile_bench at full size (correlate,
     prepare_levels, solve_level per level with its host issue, K1
     chained per level, lm_delta, the LM-step kernel, an iteration whose
     list is empty as the loop issues it and with active_list before it,
     the busy share of an 8-pair chunk under torch.profiler), every time
     finite and positive.
Then a JSON line with the kernel records (K1 at each level of the dense
grid and of the blob, the LM step, K2, the five stages): launches on the
main path (K1: its level's, with the list's capacity a launch and the
threads a subset),
agreement with the plain version, the kernel's, the plain version's and
the library call's times, and the kernel's bound, the least time the card
could take for the same work (bound()); and, last, the JSON line
{"ok": true, "device": {...}}.  Any failed phase raises and the script
exits non-zero without those lines; so does a machine without a CUDA
device, or a directory without the package.
"""

import dataclasses
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
FRAMES = 64
NUM_SUBSETS = 4096
DENSE_SUBSETS = 16384  # bench.py --dense
CPU_SUBSETS = 256
SEQ_PAIRS = 32
STRICT_PAIRS = 4
BLOB_PAIRS = 8
ANNULUS_CPU_SECTORS = 64


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates):
# HBM bytes a second, dense operations a second by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}
# K1's operations per pixel for AFFINE / BICUBIC / one channel, each add
# and multiply of csrc/fused_assemble.cu's body one (it builds with
# -fmad=false): warp 10, tap fractions 2, two sets of Catmull-Rom taps 66,
# tile offsets 4, live / bad 3, the 4 x 4 tap sums 56 + 21, gradients and
# residual 4, the Jacobian's products 4, the 36 Gram products 72 (their
# adds included, so the sums across threads are counted whatever the
# design's reduction).
K1_OPS_PER_PIXEL = 242


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def resolve_launches():
    """Add the steps that the LM loop's graphs ran to the launch counters
    (ops/solve.resolve_launches: one sync where a graph ran)."""
    from correlation_tpu_torch.ops import solve

    solve.resolve_launches()


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved, ops=0.0, kind="fp32"):
    """The least time (ms) one H100 could take for a function that moves
    `moved` bytes (each input read once, each output written once) and does
    `ops` operations of type `kind`: the larger of the two times at the
    published peaks, and which one it is ("bytes" or "operations")."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gram_check(got, ref, num_p, what):
    """Kernel vs plain: A within rtol 2e-4, atol max|A| 5e-6; b within rtol
    2e-4, atol max|b| 2e-5; chi within rtol 2e-5 (float32 summation-order
    noise); bad-pixel counts identical.  Returns (max |got - ref|, whether
    the two are bit-identical)."""
    import numpy as np

    def close(a, b, rtol, atol, name):
        bad = np.abs(a - b) > atol + rtol * np.abs(b)
        check(not bad.any(), f"{what}: {name} differs at {int(bad.sum())} "
              f"entries, max |diff| {np.abs(a - b).max():.3e}")

    a, a0 = got[:, :num_p, :num_p], ref[:, :num_p, :num_p]
    b, b0 = got[:, :num_p, num_p], ref[:, :num_p, num_p]
    close(a, a0, 2e-4, np.abs(a0).max() * 5e-6, "A")
    close(b, b0, 2e-4, np.abs(b0).max() * 2e-5, "b")
    close(got[:, num_p, num_p], ref[:, num_p, num_p], 2e-5, 0.0, "chi")
    e, e0 = got[:, num_p + 1, num_p + 1], ref[:, num_p + 1, num_p + 1]
    check(np.array_equal(e, e0), f"{what}: bad-pixel counts differ")
    finite = np.isfinite(ref)
    return (float(np.abs(got - ref)[finite].max()),
            bool(np.array_equal(got, ref, equal_nan=True)))


def same_bits(torch, a, b):
    """Equal bit for bit, any NaN equal to any NaN."""
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a.view(torch.int32)[~nan],
                                b.view(torch.int32)[~nan]))


def lm_step_cases(torch, dev, v2, level_args):
    """Phase 3's LM-step checks.  The kernel against its plain version on
    problems.lm_step_problem's NUM_SUBSETS subsets (every branch, NaN and
    out-of-image rows), four models x both modes, through a shuffled list
    of every subset whose last quarter lies past the device length, which
    must stay untouched, the next list (in the shuffled order) equal to
    the plain version's; then, AFFINE in both modes and the four models
    in step mode, problems.lm_step_list's lists (every subset, 60% with
    gaps, 3%, the last alone) at 1, 37, 4099 and 16384 subsets, with
    every row's role, every subset stopping and none stopping: state,
    next list and count equal to the plain version's and the list equal
    to engine.active_list of the flags the step leaves; then K1 with the
    list's length on the device (active_list of a random 30% mask) at
    each dense-grid level against its plain version on idx[:count],
    counts 0, 1, the mask's and all.  Returns (case names, max |kernel -
    plain| over finite entries)."""
    import numpy as np

    from correlation_tpu_torch.config import FittingModel
    from correlation_tpu_torch.engine import active_list
    from correlation_tpu_torch.ops import solve
    from correlation_tpu_torch.problems import (
        LM_STEP_LISTS,
        lm_step_list,
        lm_step_problem,
    )

    def t(a):
        return torch.as_tensor(a, device=dev)

    names, worst = [], 0.0

    def compare(what, state, got, ref, untouched=None):
        nonlocal worst
        for name, a in got._asdict().items():
            b = ref._asdict()[name]
            check(same_bits(torch, a, b),
                  f"{what}: {name} differs from the plain version")
            if untouched is not None:
                check(same_bits(torch, a[untouched],
                                state._asdict()[name][untouched]),
                      f"{what}: {name} changed past the list's length")
            if a.dtype == torch.float32:
                fin = torch.isfinite(a) & torch.isfinite(b)
                if fin.any():
                    worst = max(worst, float((a - b)[fin].abs().max()))

    def outputs(s):
        return ([torch.full((s,), -9, dtype=torch.int32, device=dev)
                 for _ in range(2)],
                [torch.full((1,), -9, dtype=torch.int32, device=dev)
                 for _ in range(2)])

    listed = 3 * NUM_SUBSETS // 4
    for model in FittingModel:
        for init in (False, True):
            cfg, arrays, out, *rest, img_hw = lm_step_problem(
                model, NUM_SUBSETS, seed=int(model))
            state = solve.LMState(**{k: t(v) for k, v in arrays.items()})
            perm = torch.randperm(
                NUM_SUBSETS,
                generator=torch.Generator().manual_seed(int(model))).to(dev)
            count = torch.tensor([listed], dtype=torch.int32, device=dev)
            args = (t(out)[perm], perm.to(torch.int32), count,
                    *(t(a) for a in rest), img_hw, init)
            got = solve.LMState(*(a.clone() for a in state))
            ref = solve.LMState(*(a.clone() for a in state))
            nxt, cnt = outputs(NUM_SUBSETS)
            solve.lm_step(cfg, got, *args, nxt[0], cnt[0])
            solve.lm_step_reference(cfg, ref, *args, nxt[1], cnt[1])
            torch.cuda.synchronize()
            what = f"lm_step {model.name} {'init' if init else 'step'}"
            compare(what, state, got, ref, perm[listed:])
            check(torch.equal(cnt[0], cnt[1]) and torch.equal(nxt[0], nxt[1]),
                  f"{what}: the next list differs from the plain version's")
            names.append(f"{what} ({NUM_SUBSETS} subsets, {listed} listed, "
                         f"{int(cnt[0])} kept)")
    lists = 0
    for model in FittingModel:
        for init in ((False, True) if model == FittingModel.AFFINE
                     else (False,)):
            for s in (1, 37, 4099, 16384):
                for stop in (None, "none", "all"):
                    cfg, arrays, out, *rest, img_hw = lm_step_problem(
                        model, s, seed=s, stop=stop)
                    for kind in LM_STEP_LISTS:
                        idx, n = lm_step_list(s, kind, seed=s + int(model))
                        arrays["active"] = (np.isin(np.arange(s), idx[:n])
                                            & (not init))
                        state = solve.LMState(**{k: t(v) for k, v
                                                 in arrays.items()})
                        args = (t(out[np.minimum(idx, s - 1)]), t(idx),
                                t(np.int32([n])), *(t(a) for a in rest),
                                img_hw, init)
                        got = solve.LMState(*(a.clone() for a in state))
                        ref = solve.LMState(*(a.clone() for a in state))
                        nxt, cnt = outputs(s)
                        solve.lm_step(cfg, got, *args, nxt[0], cnt[0])
                        solve.lm_step_reference(cfg, ref, *args, nxt[1],
                                                cnt[1])
                        torch.cuda.synchronize()
                        what = (f"lm_step {model.name} "
                                f"{'init' if init else 'step'} {s} subsets, "
                                f"list {kind}, stop {stop}")
                        compare(what, state, got, ref)
                        want, want_n = active_list(got.active)
                        k = int(cnt[0])
                        check(torch.equal(cnt[0], cnt[1])
                              and torch.equal(nxt[0], nxt[1]),
                              f"{what}: the next list differs from the "
                              "plain version's")
                        check(k == int(want_n)
                              and torch.equal(nxt[0][:k], want[:k]),
                              f"{what}: the next list is not active_list's")
                        check(stop != "all" or k == 0,
                              f"{what}: {k} kept where all stop")
                        check(stop != "none" or k == n,
                              f"{what}: {n - k} stopped where none does")
                        lists += 1
    names.append(f"lm_step next lists: {lists} cases (U/UV/UVQ step, AFFINE "
                 "step and init; 1, 37, 4099, 16384 subsets; lists "
                 f"{'/'.join(LM_STEP_LISTS)}; roles, none stop, all stop)")
    gen = torch.Generator().manual_seed(5)
    for lvl, args in sorted(level_args.items()):
        mask = (torch.rand(NUM_SUBSETS, generator=gen) < 0.3).to(dev)
        idx, count = active_list(mask)
        for n in (0, 1, int(count), NUM_SUBSETS):
            c = torch.tensor([n], dtype=torch.int32, device=dev)
            got = v2.fused_assemble(*args, idx, c)
            ref = v2.fused_assemble_reference(*args, idx[:n])
            torch.cuda.synchronize()
            check(torch.equal(got[:n], ref),
                  f"L{lvl}: K1 with a device length of {n} differs from its "
                  "plain version on idx[:count]")
        names.append(f"K1 L{lvl} with a device length 0, 1, {int(count)}, "
                     f"{NUM_SUBSETS}")
    return names, worst


def lm_step_record(torch, dev, launches, max_err):
    """The LM-step kernel's JSON record: on problems.lm_step_problem's
    NUM_SUBSETS AFFINE subsets, the whole list with its length on the
    device and the next list written, as the LM loop launches it, the
    kernel replayed from a CUDA graph over copies of its inputs and state
    that the L2 cannot hold together (graph_ms_cold: each step reads them
    from HBM), its plain version eager, and as the nearest yardstick
    ops/solve.lm_delta from a CUDA graph (no single PyTorch call computes
    the step).  Beside them, the same from HBM at 16384 subsets (bench.py's
    dense shape) and, at both sizes, the kernel on a host list without an
    output list (the separable and field paths' form), which leaves out
    the scan across blocks.

    The bound counts the bytes a step of this data moves, each once:
    for every listed subset its list entry, its 64-float assembly,
    scaling, and p_cur, p_lg, lambda, chi_lg, iteration and the error code
    read and written, and the active flag written; the bounding box and
    center only where the assembly reports an interpolation error (the
    out-of-image test); the completed-iterations count only where the
    subset steps; the cached Gram once where it is read (a diverging
    step) or written (an accepted one), which are never both; the list's
    length read, and the next list's kept entries and its length
    written.  n_points and init_fail are not touched outside the initial
    step.  A subset that does not step keeps its state, and one that
    steps stays on the same side (an accepted step makes the next
    converge on the same assembly), so every replay moves what the first
    does."""
    from correlation_tpu_torch.config import FittingModel
    from correlation_tpu_torch.ops import solve
    from correlation_tpu_torch.problems import lm_step_problem
    from correlation_tpu_torch.utils.profiling import (
        cuda_time_ms,
        graph_ms,
        graph_ms_cold,
    )

    def measure(n):
        cfg, arrays, out, *rest, img_hw = lm_step_problem(
            FittingModel.AFFINE, n)
        state = solve.LMState(**{k: torch.as_tensor(v, device=dev)
                                 for k, v in arrays.items()})
        out, scaling, n_points, bbox, center = (
            torch.as_tensor(a, device=dev) for a in (out, *rest))
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        count = torch.tensor([n], dtype=torch.int32, device=dev)
        nxt = torch.empty(n, dtype=torch.int32, device=dev)
        nxt_count = torch.empty(1, dtype=torch.int32, device=dev)
        args = (out, idx, count, scaling, n_points, bbox, center, img_hw,
                False)
        num_p = cfg.num_params

        after = solve.LMState(*(x.clone() for x in state))
        solve.lm_step_reference(cfg, after, *args)
        err_now = out[:, num_p + 1, num_p + 1] > 0
        diverging = ~(out[:, num_p, num_p] * scaling <= state.chi_lg)
        stepped = after.iteration != state.iteration
        kept = int(after.active.sum())
        every = (idx.element_size() + 64 * out.element_size()
                 + scaling.element_size()
                 + 2 * sum(x[0].numel() * x.element_size()
                           for x in (state.p_cur, state.p_lg, state.lam,
                                     state.chi_lg, state.iteration,
                                     state.error))
                 + state.active.element_size())
        moved = (n * every
                 + int(err_now.sum()) * (bbox[0].numel() * bbox.element_size()
                                         + center[0].numel()
                                         * center.element_size())
                 + int(stepped.sum()) * state.reached.element_size()
                 + int((diverging | stepped).sum())
                 * state.ab[0].numel() * state.ab.element_size())
        listed = (moved + count.element_size() + kept * nxt.element_size()
                  + nxt_count.element_size())

        def step(*c):
            solve.lm_step(cfg, solve.LMState(*c[:10]), *c[10:13], *c[13:17],
                          img_hw, False, *c[17:])

        def host_step(*c):
            solve.lm_step(cfg, solve.LMState(*c[:10]), c[10], c[11], None,
                          *c[12:16], img_hw)

        inputs = (*state, out, idx, count, scaling, n_points, bbox, center)
        ms = graph_ms_cold(step, (*inputs, nxt, nxt_count))
        host_ms = graph_ms_cold(host_step, inputs[:12] + inputs[13:])
        return dict(cfg=cfg, state=state, out=out, args=args, ms=ms,
                    host_ms=host_ms, moved=listed, host_moved=moved,
                    kept=kept, stepped=int(stepped.sum()),
                    diverging=int(diverging.sum()),
                    err_now=int(err_now.sum()))

    m = measure(NUM_SUBSETS)
    big = measure(DENSE_SUBSETS)
    cfg, state, out, args = m["cfg"], m["state"], m["out"], m["args"]
    num_p = cfg.num_params
    bound_ms, bound_by = bound(m["moved"])
    big_bound, _ = bound(big["moved"])
    plain_ms = cuda_time_ms(lambda: solve.lm_step_reference(cfg, state, *args),
                            5)
    a = out[:, :num_p, :num_p]
    b = out[:, :num_p, num_p].contiguous()
    scaling = args[3]
    yard_ms = graph_ms(lambda: solve.lm_delta(a, b, state.lam, scaling), 20)
    for n, r, bnd in ((NUM_SUBSETS, m, bound_ms), (DENSE_SUBSETS, big,
                                                    big_bound)):
        print(f"lm_step: {n} AFFINE subsets ({r['stepped']} step, "
              f"{r['diverging']} diverge, {r['err_now']} with an "
              f"interpolation error, {r['kept']} kept in the next list), "
              f"kernel {r['ms']:.4f} ms (graph, from HBM; on a host list, "
              f"without the next list: {r['host_ms']:.4f} ms); bound "
              f"{r['moved'] / 1e6:.3f} MB -> {bnd:.5f} ms (bytes), kernel "
              f"at {bnd / r['ms']:.1%} of it")
    print(f"lm_step: plain {plain_ms:.4f} ms (eager), lm_delta "
          f"{yard_ms:.4f} ms (graph), at {NUM_SUBSETS} subsets")
    return {
        "name": "lm_step",
        "route": "cuda",
        "source": "correlation_tpu_torch/csrc/lm_step.cu",
        "replaces": "correlation_tpu/engine.py:343 (_make_body: XLA in JAX, "
                    "not a Pallas kernel)",
        "launches": launches,  # phase 5's
        "max_abs_err": max_err,
        "ms": m["ms"],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_call": None,
        "library_ms": None,
        "yardstick": "ops/solve.lm_delta alone, from a CUDA graph",
        "yardstick_ms": yard_ms,
        "ms_host_list": m["host_ms"],
        f"ms_{DENSE_SUBSETS}": big["ms"],
        f"bound_ms_{DENSE_SUBSETS}": big_bound,
        f"ms_host_list_{DENSE_SUBSETS}": big["host_ms"],
    }


def tile_memory(v2, p_len, tile_h, tile_w, channels):
    """"shared" or "global": where K1 holds a subset's tile at this shape
    (assemble_v2.tile_in_shared on the path of subset_threads(p_len) and
    subset_chunks(p_len))."""
    return ("shared" if v2.tile_in_shared(tile_h, tile_w, channels,
                                          v2.subset_threads(p_len),
                                          v2.subset_chunks(p_len))
            else "global")


def k1_path(v2, p_len):
    """K1's path for p_len padded pixels, in words."""
    spans = v2.subset_chunks(p_len)
    return (f"{v2.subset_threads(p_len)} threads"
            + (f", {spans} spans of {v2.CHUNK_PIXELS}" if spans > 1 else ""))


def square_cases(torch, v2, cfgmod, speckle, dev, h, w, side, tile,
                 channels, grid, rng):
    """Five side x side subsets on an h x w texture with `channels`
    channels, assembled in a tile x tile tile (by default from the
    extent): (name, NP, fused_assemble arguments) for each model /
    interpolation pair of `grid`, at parameters near (0.7, -0.4)."""
    import numpy as np

    img1 = speckle(h, w, 9)
    s, half = 5, side // 2
    xy = np.zeros((s, side * side, 2), np.float32)
    for i in range(s):
        cx, cy = 20 + 13 * i, 25 + 9 * i
        gx, gy = np.meshgrid(np.arange(cx - half, cx + half + 1),
                             np.arange(cy - half, cy + half + 1),
                             indexing="ij")
        xy[i] = np.stack([gx.ravel(), gy.ravel()], -1)
    mask = np.ones((s, side * side), bool)
    center = xy.mean(axis=1).astype(np.float32)
    img = np.stack([img1 * f for f in (1.0, 0.8, 0.6)[:channels]], -1)
    und_w = img[xy[..., 1].astype(int), xy[..., 0].astype(int)]
    th, tw = tile or v2.choose_tile(side - 1, side - 1, h, -(-w // 8) * 8)
    path = (f"{side}x{side}, {k1_path(v2, side * side)}, tile "
            f"{th}x{tw} in {tile_memory(v2, side * side, th, tw, channels)} "
            f"memory")

    def t(a):
        return torch.as_tensor(a, device=dev)

    xy_t, mask_t, center_t = t(xy), t(mask), t(center)
    pix = v2.pack_pixels(xy_t, mask_t, t(und_w), center_t)
    bbox = v2.subset_bbox(xy_t, mask_t)
    dimg = v2.prepare_image(t(img), th, tw)
    for model, interp in grid:
        num_p = cfgmod.NUM_PARAMS[model]
        params = rng.normal(0, 0.01, (s, num_p)).astype(np.float32)
        params[:, 0] += 0.7
        if num_p > 1:
            params[:, 1] -= 0.4
        yield (f"{model.name}/{interp.name}/C{channels} ({path})", num_p,
               (model, interp, th, tw, h, w, dimg, pix, center_t,
                t(params), bbox))


def grid_cases(torch, v2, cfgmod, speckle, dev):
    """tests/test_assemble_v2.py's grid: four model/interpolation pairs x
    C in {1, 3}, five 11x11 subsets on a 96x130 texture (the warp path),
    and again with 23x23 subsets (the block path); then the global-tile
    path, AFFINE / BICUBIC: the block path at 248x248 and 320x320 tiles,
    C = 1 and 3, and the warp path at a 320x320 tile; then the split
    path: five 49x49 subsets (2401 padded pixels, 5 spans, the last
    ragged) on a 160x200 texture, the four pairs at C = 1 and AFFINE /
    BICUBIC at C = 3."""
    import numpy as np

    rng = np.random.default_rng(9)
    fm, fi = cfgmod.FittingModel, cfgmod.Interpolation
    grid = [(fm.AFFINE, fi.BICUBIC), (fm.UV, fi.BILINEAR),
            (fm.UVQ, fi.BICUBIC), (fm.U, fi.NEAREST)]
    for side in (11, 23):
        for channels in (1, 3):
            yield from square_cases(torch, v2, cfgmod, speckle, dev, 96, 130,
                                    side, None, channels, grid, rng)
    for side, tile, channels in ((23, 248, 1), (23, 248, 3), (23, 320, 1),
                                 (23, 320, 3), (11, 320, 1)):
        check(tile_memory(v2, side * side, tile, tile, channels) == "global",
              f"a {tile}x{tile} tile at C = {channels} fits in shared memory")
        yield from square_cases(torch, v2, cfgmod, speckle, dev, tile + 8,
                                tile + 8, side, (tile, tile), channels,
                                grid[:1], rng)
    check(v2.subset_chunks(49 * 49) == 5, "49x49 subsets are not split")
    for channels, pairs in ((1, grid), (3, grid[:1])):
        yield from square_cases(torch, v2, cfgmod, speckle, dev, 160, 200,
                                49, None, channels, pairs, rng)


def experiments_phase(torch, dev, smi):
    """Drive the two experiment entry points, then hold each kernel against
    its plain version.  Returns the kernels' JSON records, with device
    times from CUDA graphs as K1's."""
    from correlation_tpu_torch.experiments import exp_gather as eg
    from correlation_tpu_torch.experiments import exp_matmul_overhead as em
    from correlation_tpu_torch.utils.profiling import (
        L2_BYTES,
        cuda_time_ms,
        graph_ms,
        graph_ms_cold,
    )

    eg.LAUNCHES = 0
    em.LAUNCHES.update(dict.fromkeys(em.NAMES, 0))
    check(eg.main() == 0, "exp_gather entry point failed")
    check(em.main(["loop", "batched", "gram", "vpu"]) == 0,
          "exp_matmul_overhead entry point failed")
    launches = {"gather_rows": eg.LAUNCHES}
    launches.update({f"stage_{n}": em.LAUNCHES[n] for n in em.NAMES})
    check(all(v > 0 for v in launches.values()),
          f"an experiment kernel was never launched: {launches}")

    def record(name, src, line, err, inputs, out, fn, plain, library,
               ops=0.0, kind="fp32", library_inputs=None):
        """The kernel's record: fn and plain take `inputs`, library (None,
        or (call, function)) takes `library_inputs`, by default `inputs`.
        Inputs that fit in the L2 are timed from HBM (graph_ms_cold), with
        the L2-resident time beside."""
        cold = nbytes(*inputs) < L2_BYTES

        def dev_ms(f, ins=inputs):
            return graph_ms_cold(f, ins) if cold else graph_ms(
                lambda: f(*ins))

        bound_ms, bound_by = bound(nbytes(*inputs, out), ops, kind)
        rec = {
            "name": name, "route": "cuda",
            "source": f"correlation_tpu_torch/csrc/{src}",
            "replaces": f"experiments/{line}", "launches": launches[name],
            "max_abs_err": err, "ms": dev_ms(fn), "plain_ms": dev_ms(plain),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_call": library and library[0],
            "library_ms": library and dev_ms(library[1],
                                             library_inputs or inputs),
        }
        warm = ""
        if cold:
            rec["ms_l2_resident"] = graph_ms(lambda: fn(*inputs))
            warm = f", {rec['ms_l2_resident']:.4f} ms L2-resident"
        lib = (f"; {library[0]} {rec['library_ms']:.4f} ms" if library
               else "")
        print(f"experiments: {name} max |kernel - plain| {err:.3e}; kernel "
              f"{rec['ms']:.4f} ms (graph{', from HBM' if cold else ''}"
              f"{warm}), {cuda_time_ms(lambda: fn(*inputs)):.4f} ms (eager "
              f"wrapper); plain {rec['plain_ms']:.4f} ms (graph){lib}; bound "
              f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / rec['ms']:.1%} "
              f"of it ({smi})")
        return rec

    src, idx = eg.make_inputs(dev)
    got, ref = eg.gather_rows(src, idx), eg.gather_rows_reference(src, idx)
    check(torch.equal(got, ref), "gather_rows differs from its plain version")
    out = [record("gather_rows", "exp_gather.cu", "exp_gather.py:14", 0.0,
                  [src, idx], got, eg.gather_rows, eg.gather_rows_reference,
                  ("torch.take_along_dim",
                   lambda s, i: torch.take_along_dim(s, i, dim=0)),
                  library_inputs=[src, idx.long()])]
    # Timed as gather_rows is: a kernel that does nothing, the launch floor
    # under the bytes bound.
    out[0]["launch_floor_ms"] = graph_ms_cold(
        lambda s, i: eg.empty_launch(s.device), [src, idx])
    print(f"experiments: empty kernel (launch floor) "
          f"{out[0]['launch_floor_ms']:.4f} ms (graph, from HBM, as "
          f"gather_rows; {smi})")
    lines = {"loop": 71, "batched": 83, "gram_loop": 94, "gram_big": 104,
             "vpu": 120}
    kept = {}
    for name in em.NAMES:
        inputs = em.make_inputs(name, dev)
        kernel, plain = em.KERNELS[name], em.REFERENCES[name]
        got = kernel(*inputs)
        scale = em.terms_scale(name, inputs)
        ok, err = em.agreement(got, plain(*inputs), scale)
        check(ok, f"stage_{name} differs from its plain version by {err}")
        # The two products share one routine and agree bit for bit; the
        # two Grams sum in different orders.
        if name in ("loop", "gram_loop"):
            kept[name] = got
        elif name == "batched":
            check(torch.equal(kept.pop("loop"), got), "loop and batched differ")
        elif name == "gram_big":
            check(em.agreement(kept.pop("gram_loop"), got, scale)[0],
                  "gram_loop and gram_big differ")
        g, b, k, m = inputs[0].shape
        p = inputs[-1].shape[-1]
        ops, kind = {
            "loop": (2 * g * b * m * p * k, "bf16"),
            "batched": (2 * g * b * m * p * k, "bf16"),
            "gram_loop": (2 * g * b * 36 * p, "fp32"),
            "gram_big": (2 * g * b * 36 * p, "fp32"),
            # Per output column: 32 columns of 16 mask, 12 tap and 6 sum ops.
            "vpu": (g * b * p * em.TW * 34, "fp32"),
        }[name]
        out.append(record(f"stage_{name}", "exp_stages.cu",
                          f"exp_matmul_overhead.py:{lines[name]}", err,
                          inputs, got, kernel, plain, em.LIBRARY[name],
                          ops, kind))
        del inputs, got, scale
        torch.cuda.empty_cache()
    return out


class InMemoryFrames:
    """An in-memory uint8 frame source, staged to the card as uint8."""

    uint8_source = True

    def __init__(self, stack):
        self.stack = stack

    def __len__(self):
        return len(self.stack)

    def __getitem__(self, idx):
        return self.stack[idx]


def sequence_phase(torch, dev, smi, v2):
    """run_sequence in three modes on the drifting sequence."""
    import numpy as np

    from correlation_tpu_torch.problems import sequence_problem
    from correlation_tpu_torch.sequence import run_sequence
    from correlation_tpu_torch.utils.profiling import SolveMeter

    cfg, frames, pts, centers = sequence_problem(NUM_SUBSETS, SEQ_PAIRS)
    records = {}
    for name, scfg, pairs, accumulates in sequence_modes(cfg):
        meter = SolveMeter()
        torch.cuda.synchronize()
        v2.reset_launches()
        t0 = time.perf_counter()
        recs = run_sequence(InMemoryFrames(frames[: pairs + 1]), pts, scfg,
                            centers=centers, meter=meter, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = v2.LAUNCHES
        check(len(recs) == pairs, f"{name}: {len(recs)} records of {pairs}")
        records.update({f"{name}/{k}": v
                        for k, v in record_arrays(recs).items()})
        params = np.stack([r.params for r in recs])
        errors = np.stack([r.error for r in recs])
        check(launches > 0, f"{name}: the sequence launched no kernel")
        check(np.isfinite(params).all(), f"{name}: non-finite parameters")
        hard = float(np.mean((errors != 0) & (errors != 3)))
        check(hard < 0.005, f"{name}: hard-error fraction {hard}")
        worst = 0.0
        for t in range(pairs):
            v = t + 1.0 if accumulates else 1.0
            med = np.median(params[t][:, :2], axis=0)
            worst = max(worst, abs(med[0]), abs(med[1] - v))
        check(worst <= 0.02, f"{name}: median (u, v) off by {worst}")
        cpu = run_sequence(InMemoryFrames(frames[:3]), pts[:CPU_SUBSETS],
                           scfg, centers=centers[:CPU_SUBSETS], device="cpu")
        g = {k: np.stack([getattr(r, k)[:CPU_SUBSETS] for r in recs[:2]])
             for k in ("params", "iterations", "error")}
        c = {k: np.stack([getattr(r, k) for r in cpu])
             for k in ("params", "iterations", "error")}
        p_diff = float(np.abs(g["params"] - c["params"]).max())
        mismatch = int(((g["iterations"] != c["iterations"])
                        | (g["error"] != c["error"])).sum())
        check(p_diff <= 1e-3, f"{name}: card vs CPU params differ by {p_diff}")
        check(mismatch <= 0.01 * g["error"].size,
              f"{name}: {mismatch} iteration/error mismatches card vs CPU")
        print(f"sequence {name} ({smi}): {NUM_SUBSETS} subsets x {pairs} "
              f"pairs in {wall:.3f} s = {NUM_SUBSETS * pairs / wall:.1f} "
              f"solves/s over the whole run, {meter.solves_per_s:.1f} in the "
              f"solver calls; {launches} kernel launches, "
              f"mean iterations {np.stack([r.iterations for r in recs]).mean():.3f}; "
              f"hard-error fraction {hard}; median (u, v) within {worst:.5f} "
              f"of the motion; card vs CPU plain ({CPU_SUBSETS} subsets x 2 "
              f"pairs): max |dp| {p_diff:.3e}, {mismatch} iteration/error "
              f"mismatches of {g['error'].size}")
    return records


def level_shapes(cfg, pts, frames, dev):
    """{level: (p_len, tile_h, tile_w)}: the fused_assemble shapes a
    sequence over `pts` on `frames` launches (LAUNCHES_BY_SHAPE's keys)."""
    import torch

    from correlation_tpu_torch.domains import make_batch
    from correlation_tpu_torch.engine import compute_level_statics
    from correlation_tpu_torch.ops.pyramid import build_pyramid

    batch = make_batch(pts, None, cfg.pyramid.stop)
    pyr = build_pyramid(torch.as_tensor(frames[:1], device=dev).float(),
                        cfg.pyramid.stop)
    statics = compute_level_statics(cfg, batch, pyr)
    return {lvl: (batch.xy[lvl].shape[1], st.tile_h, st.tile_w)
            for lvl, st in statics.items()}


def domain_run(torch, dev, smi, v2, name, cfg, scfg, frames, pts, expect,
               cpu_subsets):
    """One run_sequence over a domain's sectors (centers = their point
    means) on the card: checked for finite parameters, the hard-error
    fraction, the known motion (expect(t): the (u, v) of pair t) and
    launches at every level's shape, and its last cpu_subsets sectors x 2
    pairs against the plain version on the CPU.  Those must give the
    whole set's padded lengths and tiles (for the annulus: the outermost
    ring, its largest sectors), else the kernel's path and sum order
    would differ between the two runs.  Returns the launches by shape."""
    import numpy as np

    from correlation_tpu_torch.sequence import run_sequence
    from correlation_tpu_torch.utils.profiling import SolveMeter

    pairs = len(frames) - 1
    shapes = level_shapes(cfg, pts, frames, dev)
    meter = SolveMeter()
    torch.cuda.synchronize()
    v2.reset_launches()
    t0 = time.perf_counter()
    recs = run_sequence(InMemoryFrames(frames), pts, scfg, centers=None,
                        meter=meter, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_shape = {k: list(v) for k, v in v2.LAUNCHES_BY_SHAPE.items()}
    check(len(recs) == pairs, f"{name}: {len(recs)} records of {pairs}")
    missing = {lvl: k for lvl, k in shapes.items() if k not in by_shape}
    check(not missing, f"{name}: no kernel launch at {missing}")
    params = np.stack([r.params for r in recs])
    errors = np.stack([r.error for r in recs])
    check(np.isfinite(params).all(), f"{name}: non-finite parameters")
    hard = float(np.mean((errors != 0) & (errors != 3)))
    check(hard < 0.005, f"{name}: hard-error fraction {hard}")
    worst = max(float(np.abs(np.median(params[t][:, :2], axis=0)
                             - expect(t)).max()) for t in range(pairs))
    check(worst <= 0.02, f"{name}: median (u, v) off by {worst}")
    n = len(pts)
    part = pts[n - cpu_subsets:]
    check(level_shapes(cfg, part, frames, "cpu") == shapes,
          f"{name}: the CPU's sectors are not padded and tiled as the card's")
    cpu = run_sequence(InMemoryFrames(frames[:3]), part, scfg,
                       centers=None, device="cpu")
    g = {k: np.stack([getattr(r, k)[n - cpu_subsets:] for r in recs[:2]])
         for k in ("params", "iterations", "error")}
    c = {k: np.stack([getattr(r, k) for r in cpu])
         for k in ("params", "iterations", "error")}
    p_diff = float(np.abs(g["params"] - c["params"]).max())
    mismatch = int(((g["iterations"] != c["iterations"])
                    | (g["error"] != c["error"])).sum())
    check(p_diff <= 1e-3, f"{name}: card vs CPU params differ by {p_diff}")
    check(mismatch <= 0.01 * g["error"].size,
          f"{name}: {mismatch} iteration/error mismatches card vs CPU")
    levels = ", ".join(
        f"L{lvl} {k[0]} px tile {k[1]}x{k[2]} ({tile_memory(v2, *k, 1)}, "
        f"{k1_path(v2, k[0])}): {by_shape[k][0]} launches"
        for lvl, k in sorted(shapes.items()))
    print(f"domains {name} ({smi}): {n} sectors x {pairs} pairs in "
          f"{wall:.3f} s = {n * pairs / wall:.1f} solves/s over the whole "
          f"run, {meter.solves_per_s:.1f} in the solver calls; {levels}; "
          f"mean iterations "
          f"{np.stack([r.iterations for r in recs]).mean():.3f}; hard-error "
          f"fraction {hard}; median (u, v) within {worst:.5f} of the motion;"
          f" card vs CPU plain (the last {len(part)} sectors x 2 pairs): "
          f"max |dp| {p_diff:.3e}, {mismatch} iteration/error mismatches of "
          f"{g['error'].size}")
    return by_shape, shapes


def multi_roi(torch, dev, smi, v2, cfg, frames, ann_dom, blob_dom, grid=16):
    """Pair (0, 1) of the drifting frames over three domains: a grid x grid
    block of 21 x 21 rectangles around the annulus's center, the annulus
    and the blob.  correlate_many
    must equal three correlate calls bit for bit, and the card the CPU (on
    the first 64 rectangles and sectors, at the full batches' extents);
    one combined batch (combine_batches, every subset at the blob's tile
    and padded length) split back (split_result) is held to the separate
    solves: identical error codes, and every subset whose params differ
    by more than 5e-5 is named.  The cause of such a difference is
    checked: each domain solved alone at the combined batch's padded
    lengths must equal its share of the combined solve bit for bit."""
    import numpy as np

    from correlation_tpu_torch import (
        SubsetBatch,
        combine_batches,
        correlate,
        correlate_many,
        split_result,
    )
    from correlation_tpu_torch.domains import (
        RectangularDomain,
        annular_batch,
        blob_batch,
        rectangular_batch,
    )
    from correlation_tpu_torch.experiments.design_sweep import k1_design
    from correlation_tpu_torch.ops import _build
    from correlation_tpu_torch.ops.pyramid import build_pyramid
    from correlation_tpu_torch.problems import assembly_levels
    from correlation_tpu_torch.utils.profiling import graph_ms

    stop = cfg.pyramid.stop
    names = ["rectangles", "annulus", "blob"]
    half = 21 * grid // 2
    cx, cy = int(ann_dom.x_center), int(ann_dom.y_center)
    rect = RectangularDomain(cx - half, cy - half, cx + half, cy + half, grid,
                             grid)
    batches = [rectangular_batch(rect, stop), annular_batch(ann_dom, stop),
               blob_batch(blob_dom, stop)]
    check(batches[0].xy[0].shape[1] == 448, "rectangles are not 21x21")
    pair = torch.as_tensor(frames[:2], device=dev).float()
    pyr = build_pyramid(pair, stop)
    und, dfm = [p[0] for p in pyr], [p[1] for p in pyr]
    p0s = [np.zeros((b.num_subsets, cfg.num_params), np.float32)
           for b in batches]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    many = correlate_many(cfg, und, dfm, batches, p0s, device=dev)
    torch.cuda.synchronize()
    many_s = time.perf_counter() - t0
    for name, b, p0, got in zip(names, batches, p0s, many):
        sep = correlate(cfg, und, dfm, b, p0, device=dev)
        for f in got._fields:
            check(torch.equal(getattr(got, f), getattr(sep, f)),
                  f"multi-ROI: correlate_many's {name} {f} differs from its "
                  f"correlate call")
        err = got.error.cpu().numpy()
        check(float(np.mean((err != 0) & (err != 3))) < 0.005,
              f"multi-ROI {name}: hard errors")
        med = np.median(got.params[:, :2].cpu().numpy(), axis=0)
        check(np.abs(med - [0.0, 1.0]).max() <= 0.02,
              f"multi-ROI {name}: median (u, v) = {med}")

    cut = 64
    subs = [SubsetBatch([a[:cut] for a in b.xy], [m[:cut] for m in b.mask],
                        b.center0[:cut], b.extents) for b in batches]
    cpu = correlate_many(cfg, [a.cpu() for a in und], [a.cpu() for a in dfm],
                         subs, [p[:cut] for p in p0s], device="cpu")
    p_diff, mismatch, total = 0.0, 0, 0
    for got, ref in zip(many, cpu):
        k = ref.params.shape[0]
        p_diff = max(p_diff, float((got.params[:k].cpu()
                                    - ref.params).abs().max()))
        mismatch += int(((got.iterations[:k].cpu() != ref.iterations)
                         | (got.error[:k].cpu() != ref.error)).sum())
        total += k
    check(p_diff <= 1e-3, f"multi-ROI: card vs CPU params differ by {p_diff}")
    check(mismatch <= 0.01 * total,
          f"multi-ROI: {mismatch} iteration/error mismatches card vs CPU")

    combined, counts = combine_batches(batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = correlate(cfg, und, dfm, combined,
                    np.zeros((combined.num_subsets, cfg.num_params),
                             np.float32), device=dev)
    torch.cuda.synchronize()
    combined_s = time.perf_counter() - t0
    # One assembly of the combined batch at each level, on the split path
    # (every subset padded to the blob's length) and in one block a subset.
    one_block = k1_design(_build.load_library(), "K1 one block",
                          v2.BLOCK_THREADS)
    asm = []
    for lvl, args in sorted(assembly_levels(cfg, combined, pyr, dev).items()):
        p_len = args[7].shape[2]
        split_ms = graph_ms(lambda: v2.fused_assemble(*args), 5)
        one_ms = graph_ms(lambda: one_block(*args), 5)
        asm.append(f"L{lvl} {p_len} px ({k1_path(v2, p_len)}) "
                   f"{split_ms:.4f} ms, one block a subset {one_ms:.4f} ms")
        del args
    torch.cuda.empty_cache()
    over = []
    worst = 0.0
    lengths = [a.shape[1] for a in combined.xy]
    for name, b, part, sep in zip(names, batches, split_result(res, counts),
                                  many):
        check(torch.equal(part.error, sep.error),
              f"multi-ROI: combined {name} error codes differ")
        dp = (part.params - sep.params).abs().amax(dim=1).cpu().numpy()
        worst = max(worst, float(dp.max()))
        its = (part.iterations.cpu().numpy(), sep.iterations.cpu().numpy())
        over += [f"{name}[{i}] |dp| {dp[i]:.2e}, iterations {its[0][i]} "
                 f"combined vs {its[1][i]} separate"
                 for i in np.flatnonzero(dp > 5e-5)]
        # The padded length sets the kernel's path and so the order of the
        # Gram sums: padded to the combined lengths (its own tiles kept),
        # the domain's own solve must equal its share of the combined one.
        padded = correlate(cfg, und, dfm, padded_to(b, lengths),
                           np.zeros((b.num_subsets, cfg.num_params),
                                    np.float32), device=dev)
        for f in ("params", "chi", "iterations", "error"):
            check(torch.equal(getattr(padded, f), getattr(part, f)),
                  f"multi-ROI: {name} padded to the combined lengths gives "
                  f"another {f} than the combined solve")
    print(f"multi-ROI ({smi}): {sum(counts)} subsets ({counts}); "
          f"correlate_many {many_s:.3f} s, equal to separate correlate "
          f"calls bit for bit; card vs CPU plain ({total} subsets): max "
          f"|dp| {p_diff:.3e}, {mismatch} iteration/error mismatches; "
          f"combined batch (L0 {combined.xy[0].shape[1]} px a subset) "
          f"{combined_s:.3f} s (one assembly of it: {'; '.join(asm)}; "
          f"graph), max |dp| against the separate solves "
          f"{worst:.3e}, error codes identical; over 5e-5: "
          f"{'; '.join(over) or 'none'}; why: each domain solved alone but "
          f"padded to the combined lengths {lengths} (so on the combined "
          f"batch's kernel paths and sum orders) equals its share of the "
          f"combined solve bit for bit, so every difference is the order of "
          f"the Gram sums, which the delta-chi stop at precision "
          f"{cfg.precision:g} carries into the last step")


def padded_to(batch, lengths):
    """`batch` with each level's point arrays zero-padded (mask False) to
    `lengths`, its extents, and so its tiles, kept."""
    import numpy as np

    from correlation_tpu_torch import SubsetBatch

    xy = [np.pad(a, ((0, 0), (0, n - a.shape[1]), (0, 0)))
          for a, n in zip(batch.xy, lengths)]
    mask = [np.pad(m, ((0, 0), (0, n - m.shape[1])))
            for m, n in zip(batch.mask, lengths)]
    return SubsetBatch(xy, mask, batch.center0, batch.extents)


def domains_phase(torch, dev, smi, v2):
    """Phase 9: the annulus in two sequence modes, the blob (its level-0
    tile on the global-tile path) and the multi-ROI checks.  Returns the
    kernel record of the global-tile assembly."""
    import numpy as np

    from correlation_tpu_torch.config import (
        DeformationDescription,
        ReferenceImage,
    )
    from correlation_tpu_torch.domains import make_batch
    from correlation_tpu_torch.experiments.design_sweep import k1_design
    from correlation_tpu_torch.ops import _build
    from correlation_tpu_torch.ops.pyramid import build_pyramid
    from correlation_tpu_torch.problems import (
        annular_problem,
        assembly_levels,
        blob_problem,
    )
    from correlation_tpu_torch.sequence import SequenceConfig
    from correlation_tpu_torch.utils.profiling import cuda_time_ms, graph_ms

    cfg, frames, pts, ann_dom = annular_problem(SEQ_PAIRS)
    for name, scfg, per_pair in (
        ("annulus eulerian-first",
         SequenceConfig(solver=cfg, frame_chunk=SEQ_PAIRS), False),
        ("annulus lagrangian-previous",
         SequenceConfig(solver=cfg, frame_chunk=SEQ_PAIRS,
                        deformation=DeformationDescription.LAGRANGIAN,
                        reference=ReferenceImage.PREVIOUS), True),
    ):
        domain_run(torch, dev, smi, v2, name, cfg, scfg, frames, pts,
                   lambda t, p=per_pair: np.array([0.0,
                                                   1.0 if p else t + 1.0]),
                   ANNULUS_CPU_SECTORS)

    bcfg, bframes, bpts, blob_dom = blob_problem(BLOB_PAIRS)
    by_shape, shapes = domain_run(
        torch, dev, smi, v2, "blob eulerian-first", bcfg,
        SequenceConfig(solver=bcfg, frame_chunk=BLOB_PAIRS), bframes, bpts,
        lambda t: np.array([0.0, t + 1.0]), 1)
    check(tile_memory(v2, *shapes[0], 1) == "global",
          f"the blob's level-0 tile {shapes[0][1:]} fits in shared memory")

    # The blob's assemblies on their own, every level on the split path:
    # timed as the kernel runs them and with one block a subset (chunk =
    # p_len, the design before the split path), each bit for bit with the
    # plain version of its order.
    one_block = k1_design(_build.load_library(), "K1 one block",
                          v2.BLOCK_THREADS)
    batch = make_batch(bpts, None, bcfg.pyramid.stop)
    pyr = build_pyramid(torch.as_tensor(bframes[:2], device=dev).float(),
                        bcfg.pyramid.stop)
    records = []
    for lvl, args in sorted(assembly_levels(bcfg, batch, pyr, dev).items()):
        key = shapes[lvl]
        check(tuple([args[7].shape[2], *args[2:4]]) == key,
              f"the timed shape is not the run's level-{lvl} shape")
        check(by_shape[key][0] > 0, f"the blob's L{lvl} kernel never ran")
        img, pix, center, params, bbox = args[6:]
        n, p_len = pix.shape[0], pix.shape[2]
        check(v2.subset_chunks(p_len) > 1, f"the blob's L{lvl} is not split")
        got = v2.fused_assemble(*args)
        ref = v2.fused_assemble_reference(*args)
        one = one_block(*args)
        one_ref = v2.fused_assemble_reference(*args, chunk=p_len)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"the blob's L{lvl} assembly differs "
              f"from its plain version")
        check(torch.equal(one, one_ref), f"the blob's L{lvl} assembly in one "
              f"block differs from the plain version of its order")
        kernel_ms = graph_ms(lambda: v2.fused_assemble(*args), 20)
        one_ms = graph_ms(lambda: one_block(*args), 20)
        plain_ms = cuda_time_ms(lambda: v2.fused_assemble_reference(*args),
                                5)
        # Each subset reads its own tile once (from L2), not the whole
        # image; the partial sums are the design's own traffic.
        tile_bytes = min(n * key[1] * key[2] * img.shape[2] * 4, nbytes(img))
        moved = (tile_bytes + nbytes(center, params, bbox)
                 + n * (5 + img.shape[2]) * p_len * 4 + n * 64 * 4)
        ops = n * p_len * K1_OPS_PER_PIXEL
        bound_ms, bound_by = bound(moved, ops, "fp32")
        print(f"time ({smi}): the blob's L{lvl} assembly ({n} subset of "
              f"{p_len} px, tile {key[1]}x{key[2]}, {k1_path(v2, p_len)}) "
              f"kernel {kernel_ms:.4f} ms (graph), one block a subset "
              f"{one_ms:.4f} ms ({one_ms / kernel_ms:.1f}x), plain "
              f"{plain_ms:.4f} ms; bound {moved / 1e6:.3f} MB (tiles "
              f"{tile_bytes / 1e6:.3f} MB), {ops / 1e9:.4f} GFLOP -> "
              f"{bound_ms:.5f} ms ({bound_by}), kernel at "
              f"{bound_ms / kernel_ms:.2%} of it; both bit-identical to the "
              f"plain version of their order")
        launches, subsets = by_shape[key]
        records.append({
            "name": ("fused_assemble_L0_global_tile" if lvl == 0
                     else f"fused_assemble_blob_L{lvl}"),
            "route": "cuda",
            "source": "correlation_tpu_torch/csrc/fused_assemble.cu",
            "replaces": "correlation_tpu/ops/assemble_v2.py:964",
            "launches": launches,  # the blob sequence's, at this shape
            "capacity_per_launch": subsets / launches,
            "threads_per_subset": v2.subset_threads(p_len),
            "spans": v2.subset_chunks(p_len),
            "max_abs_err": float((got - ref).abs().max()),
            "ms": kernel_ms,
            "one_block_ms": one_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_call": None,
            "library_ms": None,
        })
        del got, ref, one, one_ref, args
    del pyr
    torch.cuda.empty_cache()

    multi_roi(torch, dev, smi, v2, cfg, frames, ann_dom, blob_dom)
    return records


def field_phase(torch, dev, smi, v2, cfg, pyr, cpu_pyr, level_args, batch,
                params0, stack_dev, tiled):
    """Phase 10: the coefficient-field assembly (backend "field") at full
    width.  `tiled` holds phase 6's readings of the same run: (chunk
    seconds, {level: (kernel graph ms, eager ms, plain ms)})."""
    import numpy as np

    from correlation_tpu_torch.config import Interpolation
    from correlation_tpu_torch.domains import SubsetBatch
    from correlation_tpu_torch.engine import correlate_frames
    from correlation_tpu_torch.ops.assemble import field_assemble
    from correlation_tpu_torch.ops.interp import precompute_field
    from correlation_tpu_torch.utils.profiling import graph_ms

    phase_t0 = time.perf_counter()
    fcfg = dataclasses.replace(cfg, backend="field")
    # The fields of the deformed frame's levels, card against CPU.
    sizes = []
    for interp in Interpolation:
        for lvl in range(len(pyr)):
            got = precompute_field(pyr[lvl][1], interp).field
            ref = precompute_field(cpu_pyr[lvl][1], interp).field
            check(torch.equal(got.cpu(), ref),
                  f"the {interp.name} field of level {lvl} differs card vs "
                  f"CPU")
            sizes.append(f"{interp.name} L{lvl} {tuple(got.shape)}")
            del got, ref
    # One field assembly of every subset per level, card against CPU, at
    # phase 6's parameters (subset 7 out of the image).
    asm = {}
    for lvl, args in sorted(level_args.items()):
        _, _, _, _, _, _, _, pix, center, params, _ = args
        field = precompute_field(pyr[lvl][1], cfg.interpolation)
        got = field_assemble(cfg.model, cfg.interpolation, field, pix, center,
                             params)
        ref = field_assemble(
            cfg.model, cfg.interpolation,
            precompute_field(cpu_pyr[lvl][1], cfg.interpolation), pix.cpu(),
            center.cpu(), params.cpu())
        check(torch.equal(got.cpu(), ref),
              f"the level-{lvl} field assembly differs card vs CPU")
        check(float(ref[7, 7, 7]) > 0, f"L{lvl}: out-of-image subset not "
              "flagged by the field assembly")
        asm[lvl] = (
            graph_ms(lambda: field_assemble(cfg.model, cfg.interpolation,
                                            field, pix, center, params), 5),
            graph_ms(lambda: precompute_field(pyr[lvl][1],
                                              cfg.interpolation), 5),
        )
        del field, got, ref
    torch.cuda.empty_cache()

    # The 64-frame chunk on the field path: phase 5's checks, no K1.  One
    # run, timed as it is (a second run read within 1.3% of the first on
    # the H100: nothing on this path compiles or caches).
    torch.cuda.synchronize()
    v2.reset_launches()
    t0 = time.perf_counter()
    out = correlate_frames(fcfg, stack_dev, batch, params0, device=dev)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    mean_it = float(out["iterations"].float().mean())
    resolve_launches()
    check(v2.LAUNCHES == 0, f"the field path launched K1 {v2.LAUNCHES} times")
    params = out["params"].cpu().numpy()
    errors = out["error"].cpu().numpy()
    check(np.isfinite(params).all(), "field: non-finite parameters")
    hard = float(np.mean((errors != 0) & (errors != 3)))
    check(hard < 0.005, f"field: hard-error fraction {hard}")
    med = np.median(params[-1][:, :2], axis=0)
    check(abs(med[0]) <= 0.02 and abs(med[1] - 1.0) <= 0.02,
          f"field: median (u, v) = {med}, expected (0, 1)")
    sub = SubsetBatch([a[:CPU_SUBSETS] for a in batch.xy],
                      [m[:CPU_SUBSETS] for m in batch.mask],
                      batch.center0[:CPU_SUBSETS], batch.extents)
    cpu = correlate_frames(fcfg, stack_dev[:3].cpu(), sub,
                           params0[:CPU_SUBSETS], device="cpu")
    same = all(torch.equal(out[k][:2, :CPU_SUBSETS].cpu(), cpu[k])
               for k in ("params", "chi", "iterations", "error"))
    p_diff = float((out["params"][:2, :CPU_SUBSETS].cpu()
                    - cpu["params"]).abs().max())
    mismatch = int(((out["iterations"][:2, :CPU_SUBSETS].cpu()
                     != cpu["iterations"])
                    | (out["error"][:2, :CPU_SUBSETS].cpu()
                       != cpu["error"])).sum())
    check(p_diff <= 1e-3, f"field: card vs CPU params differ by {p_diff}")
    check(mismatch <= 0.01 * cpu["error"].numel(),
          f"field: {mismatch} iteration/error mismatches card vs CPU")
    del out
    torch.cuda.empty_cache()
    tiled_s, tiled_levels = tiled
    s = batch.num_subsets
    frames = stack_dev.shape[0] - 1
    levels = "; ".join(
        f"L{lvl} field assembly {a:.4f} ms (graph), field build {f:.4f} ms, "
        f"tiled kernel {tiled_levels[lvl][0]:.4f} ms"
        for lvl, (a, f) in asm.items())
    print(f"field ({smi}): fields card == CPU bit for bit ({', '.join(sizes)});"
          f" one assembly of {s} subsets card == CPU bit for bit at every "
          f"level; {frames}-frame chunk on the field path "
          f"{chunk_s:.4f} s = {s * frames / chunk_s:.1f} "
          f"solves/s (tiled, phase 6: {tiled_s:.4f} s = "
          f"{s * frames / tiled_s:.1f} solves/s), mean iterations "
          f"{mean_it:.3f}, 0 K1 launches; hard-error fraction {hard}; median "
          f"(u, v) = ({med[0]:.5f}, {med[1]:.5f}); card vs CPU "
          f"({CPU_SUBSETS} subsets x 2 frames): max |dp| {p_diff:.3e}, "
          f"{mismatch} iteration/error mismatches, bit for bit: {same}; "
          f"{levels}")

    # Four channels on the field path, card against CPU.
    seq4 = four_channels()
    v2.reset_launches()
    t0 = time.perf_counter()
    card = correlate_frames(fcfg, torch.from_numpy(seq4).to(dev), sub,
                            params0[:CPU_SUBSETS], device=dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    resolve_launches()
    check(v2.LAUNCHES == 0, "four channels on the field path launched K1")
    cpu = correlate_frames(fcfg, seq4, sub, params0[:CPU_SUBSETS],
                           device="cpu")
    for k in ("params", "chi", "iterations", "error"):
        check(torch.equal(card[k].cpu(), cpu[k]),
              f"four channels: card and CPU {k} differ")
    errors = cpu["error"].numpy()
    check(float(np.mean((errors != 0) & (errors != 3))) < 0.005,
          "four channels: hard errors")
    worst = max(float(np.abs(np.median(cpu["params"][t, :, :2].numpy(), axis=0)
                             - [0.0, t + 1.0]).max()) for t in range(4))
    check(worst <= 0.02, f"four channels: median (u, v) off by {worst}")
    # A second reading of K1 at each level (phase 6's inputs).
    again = {lvl: graph_ms(lambda: v2.fused_assemble(*args), 20)
             for lvl, args in sorted(level_args.items())}
    print(f"field ({smi}): four channels, {CPU_SUBSETS} subsets x "
          f"4 pairs: the field path (0 K1 launches), {card_s:.3f} s on the "
          f"card, card == CPU bit for bit, median (u, v) within {worst:.5f} "
          f"of the motion; K1 second reading (graph): "
          + ", ".join(f"L{lvl} {ms:.4f} ms (phase 6: "
                      f"{tiled_levels[lvl][0]:.4f})"
                      for lvl, ms in again.items())
          + f"; phase wall {time.perf_counter() - phase_t0:.1f} s")
    return again, {lvl: a for lvl, (a, _) in asm.items()}


def four_channels():
    """[5, 1024, 1024, 4] uint8: 4 pairs of drifting frames in 4 channels."""
    import numpy as np

    from correlation_tpu_torch.problems import drifting_sequence

    seq = drifting_sequence(4)
    return np.concatenate([seq, 255 - seq, seq // 2, seq // 3 + 64], axis=-1)


def sep_phase(torch, dev, smi, v2, cfg, level_args, batch, params0,
              stack_dev, tiled, field_ms):
    """Phase 13: the separable-tile assembly (backend "sep") at full width.
    `tiled` holds phase 6's readings ((chunk seconds, {level: (kernel
    graph ms, eager ms, plain ms)})), `field_ms` phase 10's field assembly
    ms a level."""
    import numpy as np

    from correlation_tpu_torch.domains import SubsetBatch
    from correlation_tpu_torch.engine import correlate_frames
    from correlation_tpu_torch.ops.assemble import sep_assemble
    from correlation_tpu_torch.utils.profiling import graph_ms

    phase_t0 = time.perf_counter()
    scfg = dataclasses.replace(cfg, backend="sep")
    # One separable assembly of every subset per level, card against CPU,
    # at phase 6's parameters (subset 7 out of the image), on phase 6's
    # images (padded only up to the tile, as the sep path pads them).
    asm = {}
    for lvl, args in sorted(level_args.items()):
        model, interp, th, tw, ih, iw, img, pix, center, params, _ = args
        got = sep_assemble(model, interp, th, tw, ih, iw, img, pix, center,
                           params)
        ref = sep_assemble(model, interp, th, tw, ih, iw, img.cpu(),
                           pix.cpu(), center.cpu(), params.cpu())
        check(torch.equal(got.cpu(), ref),
              f"the level-{lvl} sep assembly differs card vs CPU")
        check(float(ref[7, 7, 7]) > 0, f"L{lvl}: out-of-image subset not "
              "flagged by the sep assembly")
        asm[lvl] = graph_ms(lambda: sep_assemble(model, interp, th, tw, ih,
                                                 iw, img, pix, center,
                                                 params), 5)
        del got, ref
    torch.cuda.empty_cache()

    # Phase 5's 64-frame chunk on the sep path: phase 5's checks, no K1,
    # card == CPU bit for bit on phase 5's subsets.  One run, timed as it is.
    torch.cuda.synchronize()
    v2.reset_launches()
    t0 = time.perf_counter()
    out = correlate_frames(scfg, stack_dev, batch, params0, device=dev)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    mean_it = float(out["iterations"].float().mean())
    resolve_launches()
    check(v2.LAUNCHES == 0, f"the sep path launched K1 {v2.LAUNCHES} times")
    params = out["params"].cpu().numpy()
    errors = out["error"].cpu().numpy()
    check(np.isfinite(params).all(), "sep: non-finite parameters")
    hard = float(np.mean((errors != 0) & (errors != 3)))
    check(hard < 0.005, f"sep: hard-error fraction {hard}")
    med = np.median(params[-1][:, :2], axis=0)
    check(abs(med[0]) <= 0.02 and abs(med[1] - 1.0) <= 0.02,
          f"sep: median (u, v) = {med}, expected (0, 1)")
    sub = SubsetBatch([a[:CPU_SUBSETS] for a in batch.xy],
                      [m[:CPU_SUBSETS] for m in batch.mask],
                      batch.center0[:CPU_SUBSETS], batch.extents)
    cpu = correlate_frames(scfg, stack_dev[:3].cpu(), sub,
                           params0[:CPU_SUBSETS], device="cpu")
    for k in ("params", "chi", "iterations", "error"):
        check(torch.equal(out[k][:2, :CPU_SUBSETS].cpu(), cpu[k]),
              f"sep: card and CPU {k} differ")
    # The dense grid's subsets are rectangles, whose bounding-box corners
    # are pixels, so the kernel places the same tiles (informational).
    phase5 = np.load(MESH_DIR / "phase5.npz")
    same_k1 = all(np.array_equal(out[k].cpu().numpy(), phase5[k])
                  for k in ("params", "chi", "iterations", "error"))
    del out
    torch.cuda.empty_cache()

    # Four channels under "auto": the sep path, card against CPU.
    seq4 = four_channels()
    acfg = dataclasses.replace(cfg, backend="auto")
    v2.reset_launches()
    t0 = time.perf_counter()
    card = correlate_frames(acfg, torch.from_numpy(seq4).to(dev), sub,
                            params0[:CPU_SUBSETS], device=dev)
    torch.cuda.synchronize()
    card4_s = time.perf_counter() - t0
    resolve_launches()
    check(v2.LAUNCHES == 0, "four channels under auto launched K1")
    cpu = correlate_frames(acfg, seq4, sub, params0[:CPU_SUBSETS],
                           device="cpu")
    for k in ("params", "chi", "iterations", "error"):
        check(torch.equal(card[k].cpu(), cpu[k]),
              f"four channels under auto: card and CPU {k} differ")
    errors = cpu["error"].numpy()
    check(float(np.mean((errors != 0) & (errors != 3))) < 0.005,
          "four channels under auto: hard errors")
    worst = max(float(np.abs(np.median(cpu["params"][t, :, :2].numpy(), axis=0)
                             - [0.0, t + 1.0]).max()) for t in range(4))
    check(worst <= 0.02, f"four channels under auto: median (u, v) off by "
          f"{worst}")

    tiled_s, tiled_levels = tiled
    s = batch.num_subsets
    frames = stack_dev.shape[0] - 1
    levels = "; ".join(
        f"L{lvl} sep {a:.4f} ms, field {field_ms[lvl]:.4f} ms, K1 "
        f"{tiled_levels[lvl][0]:.4f} ms" for lvl, a in asm.items())
    print(f"sep ({smi}): one assembly of {s} subsets card == CPU bit for bit "
          f"at every level (graph: {levels}); {frames}-frame chunk on the "
          f"sep path {chunk_s:.4f} s = {s * frames / chunk_s:.1f} solves/s "
          f"(tiled, phase 6: {tiled_s:.4f} s = {s * frames / tiled_s:.1f} "
          f"solves/s), mean iterations {mean_it:.3f}, 0 K1 launches; "
          f"hard-error fraction {hard}; median (u, v) = ({med[0]:.5f}, "
          f"{med[1]:.5f}); card == CPU bit for bit ({CPU_SUBSETS} subsets x "
          f"2 frames); equal to phase 5's K1 chunk: {same_k1}; four channels "
          f"under auto ({CPU_SUBSETS} subsets x 4 pairs): the sep path, "
          f"{card4_s:.3f} s on the card, card == CPU bit for bit, median "
          f"(u, v) within {worst:.5f} of the motion; phase wall "
          f"{time.perf_counter() - phase_t0:.1f} s")


def profile_phase():
    """Phase 14: experiments.profile_bench at full size; every time it
    reads must be finite and positive."""
    import math

    from correlation_tpu_torch.experiments import profile_bench

    phase_t0 = time.perf_counter()
    times = profile_bench.main()
    bad = {k: v for k, v in times.items() if not (math.isfinite(v) and v > 0)}
    check(not bad, f"profile_bench: times not finite and positive: {bad}")
    print(f"profile: {len(times)} readings, all finite and positive; phase "
          f"wall {time.perf_counter() - phase_t0:.1f} s")


def surface_phase(torch, smi):
    """Phase 11: the command line on the card, as a user runs it, from PNG
    frames written under build/."""
    import csv
    import json as json_mod
    import shutil
    import subprocess

    import numpy as np
    from PIL import Image

    from correlation_tpu_torch.problems import drifting_sequence, speckle

    phase_t0 = time.perf_counter()
    work = REPO / "build" / "smoke_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        frames = drifting_sequence(7)
        paths = []
        for t, f in enumerate(frames):
            paths.append(str(work / f"frame_{t}.png"))
            Image.fromarray(f[..., 0]).save(paths[-1])

        def cli(args, what, launcher=(), code=0):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, *launcher, "-m", "correlation_tpu_torch.cli",
                 *args],
                cwd=REPO, capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            check(proc.returncode == code,
                  f"{what}: the CLI exited {proc.returncode}, not {code}: "
                  f"{proc.stderr[-2000:]}")
            return wall, proc.stderr

        report = work / "drift.csv"
        plots, prof = work / "plots", work / "trace"
        grid = ["--rect", "100", "100", "900", "880", "--subdivisions", "16",
                "16"]
        wall, _ = cli(paths + grid + ["--report", str(report), "--plot-dir",
                                      str(plots), "--plot-points",
                                      "--profile", str(prof)], "drift")
        # The same run with --shard under torchrun: NCCL, a world of one
        # (one card), whose report must equal the unsharded run's.
        sharded = work / "drift_shard.csv"
        wall_shard, _ = cli(paths + grid + ["--report", str(sharded),
                                            "--shard"],
                            "drift --shard",
                            ("-m", "torch.distributed.run", "--standalone",
                             "--nproc_per_node=1"))
        check(sharded.read_bytes() == report.read_bytes(),
              "drift --shard: the report differs from the unsharded run's")
        # A JAX command line, unchanged: "pallas" takes "auto" (the fused
        # kernel on the card) and --compact-stages is read by nothing.
        jax_report = work / "drift_pallas.csv"
        wall_jax, _ = cli(paths + grid + ["--report", str(jax_report),
                                          "--backend", "pallas",
                                          "--compact-stages", "0"],
                          "drift --backend pallas")
        check(jax_report.read_bytes() == report.read_bytes(),
              "drift --backend pallas: the report differs from drift.csv")
        # The CUDA kernel's backend on the CPU: an argument error, refused
        # before any frame is decoded.
        wall_bad, err = cli(paths + grid + ["--cpu", "--backend", "cuda"],
                            "--cpu --backend cuda", code=2)
        check("backend 'cuda' solves on a cuda device, not on cpu" in err
              and "Traceback" not in err,
              f"--cpu --backend cuda: stderr {err[-2000:]!r}")
        with open(report) as f:
            rows = list(csv.DictReader(f))
        check(len(rows) == 7 * 256, f"drift: {len(rows)} report rows")
        worst, hard = 0.0, 0
        for t in range(7):
            part = [r for r in rows if r["Frame#"] == str(t)]
            uv = np.array([[float(r["parameter_0"]), float(r["parameter_1"])]
                           for r in part])
            worst = max(worst, float(np.abs(np.median(uv, axis=0)
                                            - [0.0, t + 1.0]).max()))
            hard += sum(r["error_code"] not in ("0", "3") for r in part)
        check(worst <= 0.02, f"drift: median (u, v) off by {worst}")
        check(hard < 0.005 * len(rows), f"drift: {hard} hard errors")
        names = sorted(p.name for p in plots.iterdir())
        check(names == ["overlay_00001.png", "overlay_00002.png",
                        "overlay_00003.png", "overlay_00004.png",
                        "overlay_00005.png", "overlay_00006.png",
                        "overlay_00007.png", "overlay_und.png"],
              f"drift: overlays {names}")
        dots = int((np.asarray(Image.open(plots / "overlay_00007.png"))
                    == [64, 128, 255]).all(axis=-1).sum())
        check(dots > 10000, f"drift: {dots} point pixels on the last overlay")
        traces = list(prof.iterdir())
        check(len(traces) == 1, f"drift: trace files {traces}")
        with open(traces[0]) as f:
            events = json_mod.load(f)["traceEvents"]
        kernels = sum(e.get("cat") == "kernel" for e in events)
        check(len(events) > 0, "drift: an empty trace")

        big = speckle(1024, 1064, 1)
        shifted = [str(work / "shift_0.png"), str(work / "shift_1.png")]
        Image.fromarray(big[:, 40:1064].astype(np.uint8)).save(shifted[0])
        Image.fromarray(big[:, 0:1024].astype(np.uint8)).save(shifted[1])
        seeded = work / "shift.csv"
        wall_seed, _ = cli(shifted + ["--rect", "200", "200", "824", "824",
                                      "--subdivisions", "16", "16",
                                      "--auto-guess", "--auto-guess-win",
                                      "128", "--report", str(seeded)],
                           "auto-guess")
        with open(seeded) as f:
            rows = list(csv.DictReader(f))
        uv = np.array([[float(r["parameter_0"]), float(r["parameter_1"])]
                       for r in rows])
        check(len(rows) == 256, f"auto-guess: {len(rows)} report rows")
        off = float(np.abs(uv - [40.0, 0.0]).max())
        check(off <= 0.02, f"auto-guess: (u, v) off the 40 px shift by {off}")
        check(all(r["error_code"] == "0" for r in rows),
              "auto-guess: error codes")
        print(f"surface ({smi}): python -m correlation_tpu_torch.cli on the "
              f"card: 8 drifting 1024x1024 PNG frames, 16 x 16 sectors, "
              f"report + {len(names)} overlays + trace ({len(events)} events, "
              f"{kernels} device kernels) in {wall:.2f} s wall, median (u, v) "
              f"within {worst:.5f} of the drift; the same under torchrun "
              f"with --shard (NCCL, a world of one, no overlays or trace): "
              f"the same report in {wall_shard:.2f} s wall; the same report "
              f"under --backend pallas --compact-stages 0 in {wall_jax:.2f} s "
              f"wall; --cpu --backend cuda exits 2 with resolve_device's "
              f"message in {wall_bad:.2f} s wall; --auto-guess on a 40 px "
              f"shift: 256 sectors within {off:.5f} px of (40, 0) in "
              f"{wall_seed:.2f} s wall; phase wall "
              f"{time.perf_counter() - phase_t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)


MESH_DIR = REPO / "build" / "smoke_mesh"
MESH_WORKER_TIMEOUT_S = 300
RECORD_FIELDS = ("params", "initial_guess", "chi", "iterations", "error",
                 "n_points", "und_center", "def_center", "und_angle",
                 "def_angle", "und_global_center", "def_global_center",
                 "und_global_angle", "def_global_angle")


def record_arrays(recs):
    """A run's FrameRecords as {field: numpy array stacked over pairs}."""
    import numpy as np

    return {k: np.stack([np.asarray(getattr(r, k)) for r in recs])
            for k in RECORD_FIELDS}


def sequence_modes(cfg):
    """Phase 8's three run_sequence modes: (name, SequenceConfig, pairs,
    whether the motion accumulates)."""
    from correlation_tpu_torch.config import (
        DeformationDescription,
        ReferenceImage,
    )
    from correlation_tpu_torch.sequence import SequenceConfig

    prev = ReferenceImage.PREVIOUS
    return [
        ("eulerian-first", SequenceConfig(solver=cfg, frame_chunk=SEQ_PAIRS),
         SEQ_PAIRS, True),
        ("lagrangian-previous",
         SequenceConfig(solver=cfg,
                        deformation=DeformationDescription.LAGRANGIAN,
                        reference=prev, frame_chunk=SEQ_PAIRS),
         SEQ_PAIRS, False),
        ("strict-lagrangian-per-frame",
         SequenceConfig(solver=cfg,
                        deformation=DeformationDescription.STRICT_LAGRANGIAN,
                        reference=prev),
         STRICT_PAIRS, False),
    ]


def mesh_worker(backend, rank, size, port):
    """One rank of phase 12, started by mesh_phase as `chip_smoke.py
    --mesh-worker BACKEND RANK SIZE PORT`: join the group, solve phase 5's
    chunk over the mesh on cuda:0 (twice: checked, then timed), and with
    gloo phase 8's sequences and the blob's pixel-sharded assembly; each
    result is held bit for bit against the single-process run's, read
    from MESH_DIR.  Prints its readings as a JSON line, last."""
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    from correlation_tpu_torch.config import FittingModel, Interpolation
    from correlation_tpu_torch.domains import make_batch
    from correlation_tpu_torch.engine import (
        compute_level_statics,
        correlate_frames,
    )
    from correlation_tpu_torch.ops import assemble_v2 as v2
    from correlation_tpu_torch.ops.assemble import field_assemble
    from correlation_tpu_torch.ops.interp import (
        precompute_field,
        sample_integer,
    )
    from correlation_tpu_torch.ops.pyramid import build_pyramid
    from correlation_tpu_torch.parallel import (
        assemble_pixel_sharded,
        init_distributed,
        make_mesh,
    )
    from correlation_tpu_torch.parallel.mesh import barrier
    from correlation_tpu_torch.problems import (
        blob_problem,
        dense_grid_problem,
        sequence_problem,
    )
    from correlation_tpu_torch.sequence import run_sequence

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The ranks share the host's cores, as torchrun's one thread a rank.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
    check(init_distributed(f"127.0.0.1:{port}", size, rank, backend=backend),
          "init_distributed did not join a group")
    mesh = make_mesh("cuda:0")
    check((mesh.rank, mesh.size) == (rank, size), f"mesh {mesh}")
    dev = mesh.device
    got = {"rank": rank, "size": size, "backend": backend}

    def timed(fn):
        barrier(mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        barrier(mesh)
        return out, time.perf_counter() - t0

    # Phase 5's chunk over the mesh: every level's kernel on this rank,
    # the result on the card and equal to phase 5's bit for bit.
    cfg, und, dfm, batch, params0 = dense_grid_problem(NUM_SUBSETS)
    stack = np.stack([und] + [dfm] * FRAMES)[..., None].astype(np.uint8)
    stack_dev = torch.from_numpy(stack).to(dev)
    statics = compute_level_statics(
        cfg, batch, build_pyramid(stack_dev[:1].float(), cfg.pyramid.stop))
    shapes = {lvl: (batch.xy[lvl].shape[1], st.tile_h, st.tile_w)
              for lvl, st in statics.items()}
    v2.reset_launches()

    def chunk():
        return correlate_frames(cfg, stack_dev, batch, params0, device=dev,
                                mesh=mesh)

    out, got["chunk_first_s"] = timed(chunk)
    resolve_launches()
    by_level = {lvl: list(v2.LAUNCHES_BY_SHAPE.get(k, [0, 0]))
                for lvl, k in shapes.items()}
    check(all(k > 0 for k, _ in by_level.values()),
          f"rank {rank}: a level's kernel was never launched: {by_level}")
    check(all(m <= NUM_SUBSETS // size * k for k, m in by_level.values()),
          f"rank {rank}: a launch assembled more than its shard: {by_level}")
    got["launches"] = {f"L{lvl}": k for lvl, (k, _) in by_level.items()}
    got["subsets_a_launch"] = {f"L{lvl}": m / k
                               for lvl, (k, m) in by_level.items()}
    ref = np.load(MESH_DIR / "phase5.npz")
    for key in ref.files:
        check(out[key].device == dev, f"{key} left the card")
        check(np.array_equal(out[key].cpu().numpy(), ref[key]),
              f"rank {rank}: the chunk's {key} differs from phase 5's")
    if size == 1:
        # In turns with the unsharded chunk in this same process (plain,
        # mesh, mesh, plain, twice), so that the mesh's own cost shows
        # apart from the process and the machine.
        def plain():
            return correlate_frames(cfg, stack_dev, batch, params0,
                                    device=dev)

        order = (plain, chunk, chunk, plain) * 2
        turns = [timed(fn)[1] for fn in order]
        got["chunk_turns_s"] = {
            "mesh": [t for fn, t in zip(order, turns) if fn is chunk],
            "plain": [t for fn, t in zip(order, turns) if fn is plain]}
        got["chunk_s"] = float(np.median(got["chunk_turns_s"]["mesh"]))
        got["chunk_plain_s"] = float(np.median(got["chunk_turns_s"]["plain"]))
    else:
        _, got["chunk_s"] = timed(chunk)
    del out, stack_dev

    if backend == "gloo":
        # Phase 8's sequences over the mesh, equal to its records.
        scfg, frames, pts, centers = sequence_problem(NUM_SUBSETS, SEQ_PAIRS)
        ref = np.load(MESH_DIR / "phase8.npz")
        got["sequences"] = {}
        for name, seq_cfg, pairs, _ in sequence_modes(scfg):
            v2.reset_launches()
            recs, wall = timed(lambda: run_sequence(
                InMemoryFrames(frames[: pairs + 1]), pts, seq_cfg,
                centers=centers, device=dev, mesh=mesh))
            check(v2.LAUNCHES > 0, f"rank {rank} {name}: no kernel launch")
            rec = record_arrays(recs)
            for key, val in rec.items():
                check(np.array_equal(val, ref[f"{name}/{key}"]),
                      f"rank {rank} {name}: {key} differs from phase 8's")
            got["sequences"][name] = {"wall_s": wall, "pairs": pairs,
                                      "launches": v2.LAUNCHES}

        # Cancelled by should_stop, polled on rank 0 alone (it raises
        # elsewhere) and broadcast as a CUDA tensor: True from its second
        # poll, which comes after the first chunk is solved, so the run
        # emits that chunk's first record and stops; equal to phase 8's.
        polls = []

        def stop():
            check(rank == 0, f"should_stop polled on rank {rank}")
            polls.append(1)
            return len(polls) >= 2

        name, seq_cfg, _, _ = sequence_modes(scfg)[1]
        recs = run_sequence(InMemoryFrames(frames), pts, seq_cfg,
                            centers=centers, device=dev, mesh=mesh,
                            should_stop=stop)
        check(len(recs) == 1, f"stopped run: {len(recs)} records, not 1")
        for key, val in record_arrays(recs).items():
            check(np.array_equal(val, ref[f"{name}/{key}"][:1]),
                  f"rank {rank} stopped run: {key} differs from phase 8's")
        got["stopped_polls"] = len(polls)

        # The blob's level-0 pixels, pixel-sharded, against the unsharded
        # field assembly on the card, off the solution so that b and chi
        # are not zero.
        _, bframes, bpts, _ = blob_problem(1)
        b0 = make_batch(bpts, None, 0)
        xy = torch.from_numpy(b0.xy[0]).to(dev)
        mask = torch.from_numpy(b0.mask[0]).to(dev)
        center = torch.from_numpy(b0.center0).to(dev)
        img = torch.from_numpy(bframes[:2]).to(dev).float()
        field = precompute_field(img[1], Interpolation.BICUBIC)
        und_w = sample_integer(img[0], xy) * mask[..., None]
        params = torch.tensor([[0.3, 0.8, 0.001, 0.0005, -0.0005, -0.001]],
                              device=dev)
        args = (FittingModel.AFFINE, Interpolation.BICUBIC, field, und_w, xy,
                mask, center, params)
        first, got["pixel_first_s"] = timed(
            lambda: assemble_pixel_sharded(mesh, *args))
        second, got["pixel_s"] = timed(
            lambda: assemble_pixel_sharded(mesh, *args))
        whole = field_assemble(FittingModel.AFFINE, Interpolation.BICUBIC,
                               field, v2.pack_pixels(xy, mask, und_w, center),
                               center, params)
        want = (whole[:, :6, :6], whole[:, :6, 6], whole[:, 6, 6],
                whole[:, 7, 7] > 0.0)
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              "the pixel-sharded assembly differs between two calls")
        got["pixel_px"] = int(xy.shape[1])
        got["pixel_rel"] = {}
        for name, a, b, rtol in zip(("A", "b", "chi"), first, want,
                                    PIXEL_RTOL):
            rel = float(((a - b).abs() / b.abs()).max())
            check(rel <= rtol, f"pixel-sharded {name} off by {rel:.3e} "
                  f"relative (tolerance {rtol})")
            got["pixel_rel"][name] = rel
        check(torch.equal(first[3], want[3]), "pixel-sharded err differs")
    torch.distributed.destroy_process_group()
    print(json.dumps(got))


# The pixel-sharded assembly against the unsharded one (A, b, chi): the
# tolerances of JAX's own test (tests/test_parallel.py), relative.
PIXEL_RTOL = (1e-5, 1e-5, 1e-6)


def mesh_phase(torch, smi, chunk_s):
    """Phase 12: the subset-sharded solves and the pixel-sharded assembly
    over torch.distributed, each rank a subprocess of this script under a
    timeout: (a) NCCL, a world of one on cuda:0; (b) gloo, two ranks
    sharing cuda:0.  Returns their readings."""
    import socket
    import subprocess

    def run(backend, size):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--mesh-worker",
             backend, str(rank), str(size), str(port)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for rank in range(size)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=MESH_WORKER_TIMEOUT_S))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall = time.perf_counter() - t0
        for rank, (proc, (out, err)) in enumerate(zip(procs, outs)):
            check(proc.returncode == 0,
                  f"{backend} rank {rank} of {size} exited "
                  f"{proc.returncode}: {err[-3000:]}")
        return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs], wall

    phase_t0 = time.perf_counter()
    torch.cuda.empty_cache()
    one, one_wall = run("nccl", 1)
    two, two_wall = run("gloo", 2)
    solves = NUM_SUBSETS * FRAMES
    r0 = two[0]
    print(f"mesh (a) NCCL, a world of one on cuda:0 ({smi}): the chunk == "
          f"phase 5 bit for bit; K1 launches {one[0]['launches']}; chunk "
          f"{one[0]['chunk_first_s']:.3f} s first, then in turns with the "
          f"unsharded chunk in the same process: {one[0]['chunk_s']:.4f} s = "
          f"{solves / one[0]['chunk_s']:.1f} solves/s with the mesh, "
          f"{one[0]['chunk_plain_s']:.4f} s = "
          f"{solves / one[0]['chunk_plain_s']:.1f} without (medians of "
          f"four; each run, s: "
          + "; ".join(f"{k} " + ", ".join(f"{t:.4f}" for t in v)
                      for k, v in one[0]["chunk_turns_s"].items())
          + f"; phase 6: {chunk_s:.4f} s = {solves / chunk_s:.1f}); "
          f"workers' wall {one_wall:.1f} s")
    print(f"mesh (b) gloo, two ranks sharing cuda:0 ({smi}): the chunk == "
          f"phase 5 bit for bit on both ranks; K1 launches rank 0 "
          f"{r0['launches']}, rank 1 {two[1]['launches']} (list capacity a launch "
          f"{ {k: round(v, 1) for k, v in r0['subsets_a_launch'].items()} }); "
          f"chunk {r0['chunk_first_s']:.3f} s first, {r0['chunk_s']:.4f} s = "
          f"{solves / r0['chunk_s']:.1f} solves/s warm, "
          f"{solves / r0['chunk_s'] / (solves / chunk_s):.3f}x phase 6's; "
          + "; ".join(f"{name} == phase 8 bit for bit, {v['pairs']} pairs in "
                      f"{v['wall_s']:.3f} s = "
                      f"{NUM_SUBSETS * v['pairs'] / v['wall_s']:.1f} solves/s"
                      for name, v in r0["sequences"].items())
          + f"; lagrangian-previous cancelled by should_stop on rank 0 "
          f"(polled {r0['stopped_polls']} times, broadcast to rank 1): its "
          f"one record == phase 8's; workers' wall {two_wall:.1f} s")
    print(f"mesh (c) assemble_pixel_sharded over the two gloo ranks "
          f"({smi}): the blob's {r0['pixel_px']} level-0 px, max relative "
          f"difference to the unsharded field assembly on the card A "
          f"{r0['pixel_rel']['A']:.3e}, b {r0['pixel_rel']['b']:.3e}, chi "
          f"{r0['pixel_rel']['chi']:.3e} (tolerances {PIXEL_RTOL}), err "
          f"equal, identical on a second call; {r0['pixel_first_s'] * 1e3:.2f}"
          f" ms first, {r0['pixel_s'] * 1e3:.2f} ms second (host clock, "
          f"barriers included); phase wall "
          f"{time.perf_counter() - phase_t0:.1f} s")
    return one, two


def main() -> int:
    script_t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "correlation_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import numpy as np

    from correlation_tpu_torch import config as cfgmod
    from correlation_tpu_torch import engine
    from correlation_tpu_torch.domains import SubsetBatch
    from correlation_tpu_torch.engine import correlate_frames
    from correlation_tpu_torch.ops import _build
    from correlation_tpu_torch.ops import assemble_v2 as v2
    from correlation_tpu_torch.ops import solve as lm
    from correlation_tpu_torch.ops.pyramid import build_pyramid
    from correlation_tpu_torch.problems import (
        assembly_levels,
        dense_grid_problem,
        speckle,
    )
    from correlation_tpu_torch.utils.profiling import (
        card_name_and_power,
        cuda_time_ms,
        graph_ms,
    )

    dev = torch.device("cuda:0")

    # ---- 1. device --------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = card_name_and_power()
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    print(f"nvidia-smi: {smi}")

    # ---- 2. build ---------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s to build and load "
          f"{_build.library_path().name} (nvcc {_build.build_seconds:.2f} s); "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # ---- 3. kernel vs plain on the card ------------------------------------
    max_err = 0.0
    names = []
    identical = 0
    for name, num_p, args in grid_cases(torch, v2, cfgmod, speckle, dev):
        got = v2.fused_assemble(*args)
        ref = v2.fused_assemble_reference(*args)
        torch.cuda.synchronize()
        err, same = gram_check(got.cpu().numpy(), ref.cpu().numpy(), num_p,
                               name)
        max_err = max(max_err, err)
        identical += same
        names.append(name)

    cfg, und, dfm, batch, params0 = dense_grid_problem(NUM_SUBSETS)
    pair = torch.as_tensor(np.stack([und, dfm])[..., None], device=dev)
    pyr = build_pyramid(pair, cfg.pyramid.stop)
    # Subset 7 is warped out of the image.
    level_args = assembly_levels(cfg, batch, pyr, dev)
    for lvl, args in level_args.items():
        tile_h, tile_w = args[2:4]
        p_len = args[7].shape[2]
        got = v2.fused_assemble(*args).cpu().numpy()
        ref = v2.fused_assemble_reference(*args).cpu().numpy()
        check(got[7, 7, 7] > 0 and ref[7, 7, 7] > 0,
              f"L{lvl}: out-of-image subset not flagged")
        err, same = gram_check(got, ref, 6, f"L{lvl}")
        max_err = max(max_err, err)
        identical += same
        names.append(f"L{lvl} {NUM_SUBSETS}x{p_len}px tile {tile_h}x{tile_w} "
                     f"({v2.subset_threads(p_len)} threads a subset)")
    check(identical == len(names),
          f"kernel and plain differ in {len(names) - identical} cases")
    print(f"kernel vs plain: {len(names)} cases agree ({', '.join(names)}); "
          f"max |kernel - plain| {max_err:.4e}; bit-identical in {identical} "
          f"of {len(names)}")
    step_names, step_err = lm_step_cases(torch, dev, v2, level_args)
    print(f"LM step and K1's device length vs plain: {len(step_names)} cases "
          f"bit-identical, a NaN as a NaN ({', '.join(step_names)}); max "
          f"|kernel - plain| {step_err:.4e}")

    # ---- 4. pyramid --------------------------------------------------------
    cpu_pyr = build_pyramid(pair.cpu(), cfg.pyramid.stop)
    for lvl, (a, b) in enumerate(zip(pyr, cpu_pyr)):
        check(torch.equal(a.cpu(), b), f"pyramid level {lvl} differs")
    print(f"pyramid: card == CPU at levels 0-{cfg.pyramid.stop} "
          f"({' '.join(str(tuple(a.shape[1:3])) for a in pyr)})")

    # ---- 5. the slice ------------------------------------------------------
    synced = _build.synchronising_calls()
    check(not synced, f"kernel launchers synchronise: {synced}")
    stack = np.stack([und] + [dfm] * FRAMES)[..., None].astype(np.uint8)
    stack_dev = torch.from_numpy(stack).to(dev)
    # Staged on the card, so that the chunk's first solve op is its first
    # operation; from there to the packed result nothing may wait for the
    # card.
    batch_dev = batch.to_device(dev)
    params0_dev = torch.as_tensor(params0, device=dev)
    torch.cuda.synchronize()
    v2.reset_launches()
    lm.reset_launches()
    # active_list builds a level's first list; the LM step writes the rest.
    sorts = []
    orig_list = engine.active_list

    def counted_list(mask):
        sorts.append(mask)
        return orig_list(mask)

    engine.active_list = counted_list
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = correlate_frames(cfg, stack_dev, batch_dev, params0_dev,
                               device=dev)
        issue_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
        engine.active_list = orig_list
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    lm.resolve_launches()
    launches = v2.LAUNCHES
    step_launches = lm.LAUNCHES
    level_runs = FRAMES * len(cfg.pyramid.levels_coarse_to_fine())
    step_bound = level_runs * (cfg.max_iterations + 3)
    check(2 * level_runs <= step_launches < step_bound,
          f"the LM-step kernel ran {step_launches} times, not at least the "
          f"initial step and one iteration at each of {level_runs} levels "
          f"and fewer than their bound of {step_bound} steps")
    check(launches == step_launches,
          f"K1 ran {launches} times, the LM step {step_launches}: not once "
          "each a step")
    check(len(sorts) == level_runs,
          f"active_list ran {len(sorts)} times, not once a level of every "
          "pair")
    # [launches, subsets assembled] of each level's shape
    by_level = {lvl: list(v2.LAUNCHES_BY_SHAPE.get(
        (a[7].shape[2], a[2], a[3]), [0, 0])) for lvl, a in level_args.items()}
    params = out["params"].cpu().numpy()
    errors = out["error"].cpu().numpy()
    check(launches > 0, "the main path launched no kernel")
    check(all(k > 0 for k, _ in by_level.values()),
          f"a level's kernel was never launched: {by_level}")
    check(np.isfinite(params).all(), "non-finite parameters")
    hard = float(np.mean((errors != 0) & (errors != 3)))
    check(hard < 0.005, f"hard-error fraction {hard}")
    med_u = float(np.median(params[-1][:, 0]))
    med_v = float(np.median(params[-1][:, 1]))
    check(abs(med_u) <= 0.02 and abs(med_v - 1.0) <= 0.02,
          f"median (u, v) = ({med_u}, {med_v}), expected (0, 1)")
    sub = SubsetBatch([a[:CPU_SUBSETS] for a in batch.xy],
                      [m[:CPU_SUBSETS] for m in batch.mask],
                      batch.center0[:CPU_SUBSETS], batch.extents)
    cpu = correlate_frames(cfg, stack[:3], sub, params0[:CPU_SUBSETS],
                           device="cpu")
    g = {k: out[k][:2, :CPU_SUBSETS].cpu().numpy()
         for k in ("params", "iterations", "error")}
    c = {k: cpu[k].numpy() for k in ("params", "iterations", "error")}
    p_diff = float(np.abs(g["params"] - c["params"]).max())
    mismatch = int(((g["iterations"] != c["iterations"])
                    | (g["error"] != c["error"])).sum())
    check(p_diff <= 1e-3, f"card vs CPU params differ by {p_diff}")
    check(mismatch <= 0.01 * g["error"].size,
          f"{mismatch} iteration/error mismatches card vs CPU")
    # Phase 12's ranks hold their solves to this one's, through a file.
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    np.savez(MESH_DIR / "phase5.npz",
             **{k: out[k].cpu().numpy()
                for k in ("params", "guess", "chi", "iterations", "error",
                          "packed", "center0", "n_points0")})
    print(f"slice: correlate_frames {NUM_SUBSETS} subsets x {FRAMES} frames "
          f"in {first_s:.3f} s (first run; enqueued in {issue_s:.3f} s under "
          f"sync debug mode \"error\": no host sync), {launches} K1 launches ("
          + ", ".join(f"L{lvl} {k}, list capacity {m / k:.1f} a launch"
                      for lvl, (k, m) in sorted(by_level.items()))
          + f"), {step_launches} LM-step launches, {len(sorts)} "
          f"active_list calls; launchers free of "
          f"{', '.join(_build.SYNC_CALLS[:3])}; "
          f"hard-error fraction {hard}; median (u, v) = ({med_u:.5f}, "
          f"{med_v:.5f}); card vs CPU plain ({CPU_SUBSETS} subsets x 2 "
          f"frames): max |dp| {p_diff:.3e}, {mismatch} iteration/error "
          f"mismatches of {g['error'].size}")

    # ---- 6. time -----------------------------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = correlate_frames(cfg, stack_dev, batch, params0, device=dev)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    mean_it = float(out["iterations"].float().mean())
    per_level = {}
    for lvl, args in sorted(level_args.items()):
        per_level[lvl] = (
            graph_ms(lambda: v2.fused_assemble(*args), 20),
            cuda_time_ms(lambda: v2.fused_assemble(*args), 20),
            cuda_time_ms(lambda: v2.fused_assemble_reference(*args), 5),
        )
    asm = "; ".join(f"L{lvl} kernel {k:.4f} ms (graph), {e:.4f} ms (eager "
                    f"wrapper), plain {p:.4f} ms"
                    for lvl, (k, e, p) in per_level.items())
    print(f"time ({smi}): {FRAMES}-frame chunk {chunk_s:.4f} s = "
          f"{NUM_SUBSETS * FRAMES / chunk_s:.1f} solves/s, mean iterations "
          f"{mean_it:.3f}; one assembly of {NUM_SUBSETS} subsets: {asm}")

    kernels = []
    for lvl, (kernel_ms, _, plain_ms) in sorted(per_level.items()):
        img, pix, center, params, bbox = level_args[lvl][6:]
        rows = 5 + img.shape[2]  # pix rows the kernel reads: x, y, m, dx, dy, und
        n, p_len = pix.shape[0], pix.shape[2]
        moved = (nbytes(img, center, params, bbox) + n * rows * p_len * 4
                 + n * 64 * 4)
        ops = n * p_len * K1_OPS_PER_PIXEL
        bound_ms, bound_by = bound(moved, ops, "fp32")
        k_launches, k_subsets = by_level[lvl]
        kernels.append({
            "name": f"fused_assemble_L{lvl}",
            "route": "cuda",
            "source": "correlation_tpu_torch/csrc/fused_assemble.cu",
            "replaces": "correlation_tpu/ops/assemble_v2.py:964",
            "launches": k_launches,  # this level's, on the main path
            # The list's capacity a launch (K1's grid), not its length.
            "capacity_per_launch": k_subsets / k_launches,
            "threads_per_subset": v2.subset_threads(p_len),
            "max_abs_err": max_err,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_call": None,
            "library_ms": None,
        })
        print(f"bound L{lvl}: {moved / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP "
              f"-> {bound_ms:.4f} ms ({bound_by}), kernel at "
              f"{bound_ms / kernel_ms:.1%} of it")

    kernels.append(lm_step_record(torch, dev, step_launches, step_err))

    # ---- 7. experiment kernels ----------------------------------------------
    kernels += experiments_phase(torch, dev, smi)

    # ---- 8. the sequence runs -----------------------------------------------
    np.savez(MESH_DIR / "phase8.npz", **sequence_phase(torch, dev, smi, v2))

    # ---- 9. annular and blob domains, multi-ROI ----------------------------
    kernels += domains_phase(torch, dev, smi, v2)

    # ---- 10. the coefficient-field assembly ---------------------------------
    again, field_ms = field_phase(torch, dev, smi, v2, cfg, pyr, cpu_pyr,
                                  level_args, batch, params0, stack_dev,
                                  (chunk_s, per_level))
    for rec in kernels:
        lvl = {f"fused_assemble_L{k}": k for k in again}.get(rec["name"])
        if lvl is not None:
            rec["ms_second_reading"] = again[lvl]

    # ---- 11. the command line on the card -----------------------------------
    surface_phase(torch, smi)

    # ---- 12. multi-GPU: torch.distributed -------------------------------------
    mesh_phase(torch, smi, chunk_s)

    # ---- 13. the separable-tile assembly ----------------------------------
    sep_phase(torch, dev, smi, v2, cfg, level_args, batch, params0,
              stack_dev, (chunk_s, per_level), field_ms)

    # ---- 14. the per-phase profile ----------------------------------------
    profile_phase()

    print(f"wall: {time.perf_counter() - script_t0:.1f} s for phases 1-14")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        backend, rank, size, port = sys.argv[2:6]
        mesh_worker(backend, int(rank), int(size), int(port))
        sys.exit(0)
    sys.exit(main())
