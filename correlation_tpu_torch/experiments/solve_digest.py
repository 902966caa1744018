"""Solve outputs and solve rates of one checkout of the port, to hold two
checkouts to each other on one card, run after run.

  python correlation_tpu_torch/experiments/solve_digest.py \\
      [--root DIR] [--device cuda|cpu] [--small] [--out FILE]

Imports correlation_tpu_torch from the checkout at DIR (default: the one
this file lies in), so that one copy of the script drives an older tree,
and solves on `device` (default cuda; it raises without a card):
  - the dense-grid chunk of chip_smoke.py's phase 5 (problems.
    dense_grid_problem(4096), 64 pairs, correlate_frames) on backends
    "cuda" (the tiled assembly, K1), "sep" and "field": a warm run, then
    a timed one;
  - run_sequence on problems.sequence_problem(4096, 32) in the modes of
    phase 8: Eulerian-First and Lagrangian-Previous chunked 32 pairs a
    call, strict-Lagrangian pair by pair over 4 pairs (uint8 frames from
    memory): whole-run and solver-call solves/s (SolveMeter) and the host
    share, 1 - whole run / solver calls;
  - phase 9's annulus (512 sectors, 32 pairs, both chunked modes) and
    blob (8 pairs).
--small shrinks every problem to CPU size (64 subsets of 256 x 256
frames, 3 pairs; the annulus and the blob at their smallest).  For each
run it records the SHA-256 of the solve's parameters, chi, iterations and
error codes (bytes in that order, a sequence's records stacked), the mean
iterations and the times; it prints one line a run and, last, one JSON
object {run: {...}}, also written to FILE.  Two checkouts solve alike
bit for bit where their digests are equal.  Times are the device's wall
(host clock after a synchronise), on the card only.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path


def _digest(np, *arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


class _Frames:
    """An in-memory uint8 frame source, staged to the device as uint8."""

    uint8_source = True

    def __init__(self, stack):
        self.stack = stack

    def __len__(self):
        return len(self.stack)

    def __getitem__(self, idx):
        return self.stack[idx]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import dataclasses

    import numpy as np
    import torch

    from correlation_tpu_torch import problems
    from correlation_tpu_torch.config import (
        DeformationDescription,
        ReferenceImage,
    )
    from correlation_tpu_torch.engine import correlate_frames
    from correlation_tpu_torch.sequence import SequenceConfig, run_sequence
    from correlation_tpu_torch.utils.profiling import SolveMeter

    dev = torch.device(args.device)
    card = dev.type == "cuda"
    if card and not torch.cuda.is_available():
        raise RuntimeError("solve_digest solves on a CUDA device; none is "
                           "available (pass --device cpu)")

    def sync():
        if card:
            torch.cuda.synchronize()

    small = args.small
    subsets = 64 if small else 4096
    hw = 256 if small else 1024
    pairs = 3 if small else 64
    seq_pairs = 3 if small else 32
    results = {}

    def report(name, entry):
        results[name] = entry
        print(f"{name}: " + ", ".join(f"{k} {v}" for k, v in entry.items()),
              flush=True)

    # The dense-grid chunk on each assembly.
    cfg, und, dfm, batch, params0 = problems.dense_grid_problem(subsets,
                                                                img_hw=hw)
    stack = torch.from_numpy(np.stack([und] + [dfm] * pairs)[..., None]
                             .astype(np.uint8)).to(dev)
    for backend in ("cuda" if card else "torch", "sep", "field"):
        bcfg = dataclasses.replace(cfg, backend=backend)
        correlate_frames(bcfg, stack, batch, params0, device=dev)
        sync()
        t0 = time.perf_counter()
        out = correlate_frames(bcfg, stack, batch, params0, device=dev)
        sync()
        seconds = time.perf_counter() - t0
        arrays = [out[k].cpu().numpy()
                  for k in ("params", "chi", "iterations", "error")]
        report(f"chunk/{backend}", {
            "sha256": _digest(np, *arrays),
            "mean_iterations": float(arrays[2].mean()),
            "seconds": seconds,
            "solves_per_s": subsets * pairs / seconds,
        })

    def sequence(name, scfg, frames, pts, centers):
        meter = SolveMeter()
        sync()
        t0 = time.perf_counter()
        recs = run_sequence(_Frames(frames), pts, scfg, centers=centers,
                            meter=meter, device=dev)
        sync()
        wall = time.perf_counter() - t0
        n = len(recs) * len(pts)
        stacked = [np.stack([getattr(r, k) for r in recs])
                   for k in ("params", "chi", "iterations", "error")]
        report(name, {
            "sha256": _digest(np, *stacked),
            "records": len(recs),
            "mean_iterations": float(stacked[2].mean()),
            "seconds": wall,
            "solves_per_s": n / wall,
            "solver_solves_per_s": meter.solves_per_s,
            "host_share": 1.0 - (n / wall) / meter.solves_per_s,
        })

    scfg_solver, frames, pts, centers = problems.sequence_problem(
        subsets, seq_pairs, img_hw=hw)
    prev = ReferenceImage.PREVIOUS
    for name, scfg, n in (
        ("sequence/eulerian-first",
         SequenceConfig(solver=scfg_solver, frame_chunk=seq_pairs),
         seq_pairs),
        ("sequence/lagrangian-previous",
         SequenceConfig(solver=scfg_solver,
                        deformation=DeformationDescription.LAGRANGIAN,
                        reference=prev, frame_chunk=seq_pairs), seq_pairs),
        ("sequence/strict-lagrangian",
         SequenceConfig(solver=scfg_solver,
                        deformation=DeformationDescription.STRICT_LAGRANGIAN,
                        reference=prev), min(4, seq_pairs)),
    ):
        sequence(name, scfg, frames[: n + 1], pts, centers)

    ann = ({"img_hw": 256, "center": (128.0, 120.0), "radii": (30.0, 100.0),
            "subdivisions": (2, 8)} if small else {})
    acfg, aframes, apts, _ = problems.annular_problem(seq_pairs, **ann)
    for name, scfg in (
        ("annulus/eulerian-first",
         SequenceConfig(solver=acfg, frame_chunk=seq_pairs)),
        ("annulus/lagrangian-previous",
         SequenceConfig(solver=acfg, frame_chunk=seq_pairs,
                        deformation=DeformationDescription.LAGRANGIAN,
                        reference=prev)),
    ):
        sequence(name, scfg, aframes, apts, None)
    blob = ({"img_hw": 256, "center": (128.0, 120.0), "radius": 60.0}
            if small else {})
    bpairs = 2 if small else 8
    bcfg, bframes, bpts, _ = problems.blob_problem(bpairs, **blob)
    sequence("blob/eulerian-first",
             SequenceConfig(solver=bcfg, frame_chunk=bpairs), bframes, bpts,
             None)

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
