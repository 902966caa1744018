#!/usr/bin/env python3
"""Smoke run of correlation_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one informational line each:
  1. device: the card's name and `nvidia-smi` name / power limit;
  2. build: compile csrc/fused_assemble.cu with nvcc into build/ and turn
     TF32 off for float32 matmuls and cuDNN;
  3. kernel vs plain: the CUDA fused assembly against its plain PyTorch
     version on the card, bit for bit, over the model x interpolation x
     channel grid and at the dense-grid problem's level 0/1/2 shapes
     (4096 subsets; the block path at level 0, the warp path at 1-2),
     with one subset warped out of the image;
  4. pyramid: the pyramid built on the card equals the CPU pyramid;
  5. slice: correlate_frames on the dense-grid problem (4096 21x21
     subsets, AFFINE/BICUBIC, levels 2-1-0, 64 chained frame pairs) on
     the card, checked for finite parameters, the hard-error fraction, the
     recovered shift (u, v) = (0, 1) and kernel launches at every level
     (launches and subsets a launch per level); then the first 256 subsets
     for 2 frames through the plain version on the CPU;
  6. time: the 64-frame chunk after a warm-up, and one assembly per level
     by the kernel (replayed from a CUDA graph, and called eagerly through
     its wrapper) and by the plain version;
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
     plain version on the CPU.
Then a JSON line with the kernel records (K1 at each level, K2, the five
stages): launches on the main path (K1: its level's, with the mean subsets
a launch and the threads a subset), agreement with the plain version, the
kernel's, the plain version's and the library call's times, and the
kernel's bound, the least time the card could take for the same work
(bound()); and, last, the JSON line {"ok": true, "device": {...}}.  Any failed phase raises and the script
exits non-zero without those lines; so does a machine without a CUDA
device, or a directory without the package.
"""

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
FRAMES = 64
NUM_SUBSETS = 4096
CPU_SUBSETS = 256
SEQ_PAIRS = 32
STRICT_PAIRS = 4


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


def grid_cases(torch, v2, cfgmod, speckle, dev):
    """tests/test_assemble_v2.py's grid: four model/interpolation pairs x
    C in {1, 3}, five 11x11 subsets on a 96x130 texture (the warp path),
    and again with 23x23 subsets (the block path)."""
    import numpy as np

    rng = np.random.default_rng(9)
    img1 = speckle(96, 130, 9)
    fm, fi = cfgmod.FittingModel, cfgmod.Interpolation
    grid = [(fm.AFFINE, fi.BICUBIC), (fm.UV, fi.BILINEAR),
            (fm.UVQ, fi.BICUBIC), (fm.U, fi.NEAREST)]
    s = 5
    for side in (11, 23):
        half = side // 2
        xy = np.zeros((s, side * side, 2), np.float32)
        for i in range(s):
            cx, cy = 20 + 13 * i, 25 + 9 * i
            gx, gy = np.meshgrid(np.arange(cx - half, cx + half + 1),
                                 np.arange(cy - half, cy + half + 1),
                                 indexing="ij")
            xy[i] = np.stack([gx.ravel(), gy.ravel()], -1)
        mask = np.ones((s, side * side), bool)
        center = xy.mean(axis=1).astype(np.float32)
        path = f"{side}x{side}, {v2.subset_threads(side * side)} threads"
        for channels in (1, 3):
            img = np.stack([img1 * f for f in (1.0, 0.8, 0.6)[:channels]], -1)
            und_w = img[xy[..., 1].astype(int), xy[..., 0].astype(int)]
            th, tw = v2.choose_tile(side - 1, side - 1, 96, 136)

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
                yield (f"{model.name}/{interp.name}/C{channels} ({path})",
                       num_p, (model, interp, th, tw, 96, 130, dimg, pix,
                               center_t, t(params), bbox))


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

    from correlation_tpu_torch.config import (
        DeformationDescription,
        ReferenceImage,
    )
    from correlation_tpu_torch.problems import sequence_problem
    from correlation_tpu_torch.sequence import SequenceConfig, run_sequence
    from correlation_tpu_torch.utils.profiling import SolveMeter

    cfg, frames, pts, centers = sequence_problem(NUM_SUBSETS, SEQ_PAIRS)
    lagr, strict = (DeformationDescription.LAGRANGIAN,
                    DeformationDescription.STRICT_LAGRANGIAN)
    prev = ReferenceImage.PREVIOUS
    modes = [
        ("eulerian-first", SequenceConfig(solver=cfg, frame_chunk=SEQ_PAIRS),
         SEQ_PAIRS, True),
        ("lagrangian-previous",
         SequenceConfig(solver=cfg, deformation=lagr, reference=prev,
                        frame_chunk=SEQ_PAIRS), SEQ_PAIRS, False),
        ("strict-lagrangian-per-frame",
         SequenceConfig(solver=cfg, deformation=strict, reference=prev),
         STRICT_PAIRS, False),
    ]
    for name, scfg, pairs, accumulates in modes:
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


def main() -> int:
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
    from correlation_tpu_torch.domains import SubsetBatch
    from correlation_tpu_torch.engine import correlate_frames
    from correlation_tpu_torch.ops import _build
    from correlation_tpu_torch.ops import assemble_v2 as v2
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

    # ---- 4. pyramid --------------------------------------------------------
    cpu_pyr = build_pyramid(pair.cpu(), cfg.pyramid.stop)
    for lvl, (a, b) in enumerate(zip(pyr, cpu_pyr)):
        check(torch.equal(a.cpu(), b), f"pyramid level {lvl} differs")
    print(f"pyramid: card == CPU at levels 0-{cfg.pyramid.stop} "
          f"({' '.join(str(tuple(a.shape[1:3])) for a in pyr)})")

    # ---- 5. the slice ------------------------------------------------------
    stack = np.stack([und] + [dfm] * FRAMES)[..., None].astype(np.uint8)
    stack_dev = torch.from_numpy(stack).to(dev)
    torch.cuda.synchronize()
    v2.reset_launches()
    t0 = time.perf_counter()
    out = correlate_frames(cfg, stack_dev, batch, params0, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = v2.LAUNCHES
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
    print(f"slice: correlate_frames {NUM_SUBSETS} subsets x {FRAMES} frames "
          f"in {first_s:.3f} s (first run), {launches} kernel launches ("
          + ", ".join(f"L{lvl} {k}, {m / k:.1f} subsets a launch"
                      for lvl, (k, m) in sorted(by_level.items()))
          + "); "
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
            "subsets_per_launch": k_subsets / k_launches,
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

    # ---- 7. experiment kernels ----------------------------------------------
    kernels += experiments_phase(torch, dev, smi)

    # ---- 8. the sequence runs -----------------------------------------------
    sequence_phase(torch, dev, smi, v2)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
