#!/usr/bin/env python3
"""Smoke run of correlation_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one informational line each:
  1. device: the card's name and `nvidia-smi` name / power limit;
  2. build: compile csrc/fused_assemble.cu with nvcc into build/ and turn
     TF32 off for float32 matmuls and cuDNN;
  3. kernel vs plain: the CUDA fused assembly against its plain PyTorch
     version on the card, over the model x interpolation x channel grid
     and at the dense-grid problem's level 0/1/2 shapes (4096 subsets),
     with one subset warped out of the image;
  4. pyramid: the pyramid built on the card equals the CPU pyramid;
  5. slice: correlate_frames on the dense-grid problem (4096 21x21
     subsets, AFFINE/BICUBIC, levels 2-1-0, 64 chained frame pairs) on
     the card, checked for finite parameters, the hard-error fraction, the
     recovered shift (u, v) = (0, 1) and kernel launches; then the first
     256 subsets for 2 frames through the plain version on the CPU;
  6. time: the 64-frame chunk after a warm-up, and one assembly per level
     by the kernel (replayed from a CUDA graph, and called eagerly through
     its wrapper) and by the plain version.
Then a JSON line with the kernel record and, last, the JSON line
{"ok": true, "device": {...}}.  Any failed phase raises and the script
exits non-zero without those lines; so does a machine without a CUDA
device, or a directory without the package.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
FRAMES = 64
NUM_SUBSETS = 4096
CPU_SUBSETS = 256


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


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
    C in {1, 3}, five 11x11 subsets on a 96x130 texture."""
    import numpy as np

    rng = np.random.default_rng(9)
    img1 = speckle(96, 130, 9)
    fm, fi = cfgmod.FittingModel, cfgmod.Interpolation
    grid = [(fm.AFFINE, fi.BICUBIC), (fm.UV, fi.BILINEAR),
            (fm.UVQ, fi.BICUBIC), (fm.U, fi.NEAREST)]
    s, side = 5, 11
    xy = np.zeros((s, side * side, 2), np.float32)
    for i in range(s):
        cx, cy = 20 + 13 * i, 25 + 9 * i
        gx, gy = np.meshgrid(np.arange(cx - 5, cx + 6),
                             np.arange(cy - 5, cy + 6), indexing="ij")
        xy[i] = np.stack([gx.ravel(), gy.ravel()], -1)
    mask = np.ones((s, side * side), bool)
    center = xy.mean(axis=1).astype(np.float32)
    for channels in (1, 3):
        img = np.stack([img1 * f for f in (1.0, 0.8, 0.6)[:channels]], -1)
        und_w = img[xy[..., 1].astype(int), xy[..., 0].astype(int)]
        th, tw = v2.choose_tile(10, 10, 96, 136)

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
            yield (f"{model.name}/{interp.name}/C{channels}", num_p,
                   (model, interp, th, tw, 96, 130, dimg, pix, center_t,
                    t(params), bbox))


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps):
    """Device time per call of `fn` without the host's issue cost: `reps`
    calls captured in one CUDA graph, the replay timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    from correlation_tpu_torch.engine import (
        compute_level_statics,
        correlate_frames,
        prepare_levels,
    )
    from correlation_tpu_torch.ops import _build
    from correlation_tpu_torch.ops import assemble_v2 as v2
    from correlation_tpu_torch.ops.pyramid import build_pyramid
    from correlation_tpu_torch.problems import dense_grid_problem, speckle

    dev = torch.device("cuda:0")

    # ---- 1. device --------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
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
    statics = compute_level_statics(cfg, batch, pyr)
    gb = batch.to_device(dev)
    levels = prepare_levels(cfg, [p[0] for p in pyr], [p[1] for p in pyr],
                            gb.xy, gb.mask, gb.center0, statics)
    rng = np.random.default_rng(1)
    level_args = {}
    for lvl in cfg.pyramid.levels_coarse_to_fine():
        st, lv = statics[lvl], levels[lvl]
        p = np.zeros((NUM_SUBSETS, 6), np.float32)
        p[:, :2] = rng.normal(0, 0.3, (NUM_SUBSETS, 2))
        p[:, 1] += 1.0 / (1 << lvl)
        p[:, 2:] = rng.normal(0, 0.003, (NUM_SUBSETS, 4))
        p[7, 0] = 4000.0  # one subset warped out of the image
        args = (cfg.model, cfg.interpolation, st.tile_h, st.tile_w, st.img_h,
                st.img_w, lv.def_img, lv.pix, lv.center,
                torch.as_tensor(p, device=dev), lv.bbox)
        got = v2.fused_assemble(*args).cpu().numpy()
        ref = v2.fused_assemble_reference(*args).cpu().numpy()
        check(got[7, 7, 7] > 0 and ref[7, 7, 7] > 0,
              f"L{lvl}: out-of-image subset not flagged")
        err, same = gram_check(got, ref, 6, f"L{lvl}")
        max_err = max(max_err, err)
        identical += same
        names.append(f"L{lvl} {NUM_SUBSETS}x{lv.pix.shape[2]}px "
                     f"tile {st.tile_h}x{st.tile_w}")
        level_args[lvl] = args
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
    v2.LAUNCHES = 0
    t0 = time.perf_counter()
    out = correlate_frames(cfg, stack_dev, batch, params0, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = v2.LAUNCHES
    params = out["params"].cpu().numpy()
    errors = out["error"].cpu().numpy()
    check(launches > 0, "the main path launched no kernel")
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
    cpu = correlate_frames(cfg, stack[:3], sub, params0[:CPU_SUBSETS])
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
          f"in {first_s:.3f} s (first run), {launches} kernel launches; "
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
            graph_ms(torch, lambda: v2.fused_assemble(*args), 20),
            time_ms(torch, lambda: v2.fused_assemble(*args), 20),
            time_ms(torch, lambda: v2.fused_assemble_reference(*args), 5),
        )
    kernel_ms, _, plain_ms = per_level[0]
    asm = "; ".join(f"L{lvl} kernel {k:.4f} ms (graph), {e:.4f} ms (eager "
                    f"wrapper), plain {p:.4f} ms"
                    for lvl, (k, e, p) in per_level.items())
    print(f"time ({smi}): {FRAMES}-frame chunk {chunk_s:.4f} s = "
          f"{NUM_SUBSETS * FRAMES / chunk_s:.1f} solves/s, mean iterations "
          f"{mean_it:.3f}; one assembly of {NUM_SUBSETS} subsets: {asm}")

    print(json.dumps({"kernels": [{
        "name": "fused_assemble",
        "route": "cuda",
        "source": "correlation_tpu_torch/csrc/fused_assemble.cu",
        "replaces": "correlation_tpu/ops/assemble_v2.py:964",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
