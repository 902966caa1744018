"""One run of one cell: set-up, the measured window, the traced slice,
the per-layer metrics and the correctness check, and the result line.

The system under test is correlation_tpu_torch.sequence.run_sequence,
called with the whole sequence of frames (uint8, staged as uint8), the
configuration's point lists and centers, the SequenceConfig that the
configuration's solver settings and the mix's modes make, and a
SolveMeter.  A closed loop of one analyst: sequences run back to back
until the window's seconds are spent; the last one ends the window.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import sys
import time

import numpy as np

from dicbench import spec

# Top-level module names that no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "correlation_tpu")
TRACED_SEQUENCES = 2
WARM_SEQUENCES = 2


class NoCard(RuntimeError):
    """The run needs more CUDA devices than there are."""


class Frames:
    """The sequence as the program reads it: uint8 frames in memory,
    staged to the device as uint8."""

    uint8_source = True

    def __init__(self, stack: np.ndarray):
        self.stack = stack

    def __len__(self):
        return len(self.stack)

    def __getitem__(self, idx):
        return self.stack[idx]


def forbidden_modules() -> list[str]:
    """The FORBIDDEN top-level names that sys.modules holds, each module
    name compared by its part before the first dot, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Inputs:
    frames: np.ndarray  # [T, H, W, C] uint8
    points: list  # level-0 point lists
    centers: np.ndarray | None
    pairs: int


def make_inputs(cell: spec.Cell, seed: int, device) -> Inputs:
    """The frames and point lists of a cell's configuration under its mix,
    from the seed: the same seed gives the same inputs."""
    import torch

    config, mix = cell.config, cell.mix
    motion = spec.load("motions", mix["motion"]["kind"], cell.root)
    stack = motion.frames(config["frame"], mix, seed, device)
    if stack.is_cuda:
        torch.cuda.synchronize()
    domain = spec.load("domains", config["domain"]["kind"], cell.root)
    pts, centers = domain.points(config["domain"], config["frame"])
    return Inputs(stack.cpu().numpy(), pts, centers, int(mix["pairs"]))


def sequence_config(config: dict, mix: dict, backend: str | None = None):
    """The program's SequenceConfig of a configuration and a mix."""
    from correlation_tpu_torch.config import (
        DeformationDescription,
        ErrorMode,
        FittingModel,
        Interpolation,
        PyramidConfig,
        ReferenceImage,
        SolverConfig,
    )
    from correlation_tpu_torch.sequence import SequenceConfig

    s = config["solver"]
    levels = sorted(s["pyramid"])
    step = levels[1] - levels[0] if len(levels) > 1 else 1
    solver = SolverConfig(
        model=FittingModel[s["model"]],
        interpolation=Interpolation[s["interpolation"]],
        pyramid=PyramidConfig(levels[0], step, levels[-1]),
        max_iterations=int(s["max_iterations"]),
        precision=float(s["precision"]),
        backend=backend or s["backend"],
    )
    extra = {}
    if mix.get("frame_chunk") is not None:
        extra["frame_chunk"] = int(mix["frame_chunk"])
    return SequenceConfig(
        solver=solver,
        deformation=DeformationDescription[mix["deformation"]],
        reference=ReferenceImage[mix["reference"]],
        error_mode=ErrorMode[mix["error_mode"]],
        **extra,
    )


@dataclasses.dataclass
class Outputs:
    """What the timed calls produced, each distinct output once."""

    distinct: dict = dataclasses.field(default_factory=dict)  # sha -> arrays
    sequences: int = 0
    solves: int = 0
    failed: int = 0
    pairs: int = 0
    iterations: int = 0

    def add(self, recs) -> None:
        arrays = {k: np.stack([getattr(r, k) for r in recs])
                  for k in ("params", "chi", "iterations", "error")}
        h = hashlib.sha256()
        for a in arrays.values():
            h.update(np.ascontiguousarray(a).tobytes())
        self.distinct.setdefault(h.hexdigest(), arrays)
        err = arrays["error"]
        self.sequences += 1
        self.pairs += err.shape[0]
        self.solves += err.size
        self.failed += int(((err != 0) & (err != 3)).sum())
        self.iterations += int(arrays["iterations"].sum())


@dataclasses.dataclass
class Run:
    """What the per-layer metrics read."""

    cell: spec.Cell
    device: object
    scfg: object
    inputs: Inputs
    window: dict  # wall, meter_s, solves, failed, pairs, iterations, sequences
    trace: dict | None
    outputs: Outputs


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             t0: float, device=None, backend: str | None = None) -> dict:
    """One run of `cell`: returns the result line's object.  t0: the
    process's start on the perf_counter clock; device / backend: where
    and how the program solves (default: the first card, the
    configuration's backend)."""
    import torch

    from correlation_tpu_torch.sequence import run_sequence
    from correlation_tpu_torch.utils.profiling import SolveMeter

    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            raise NoCard(f"{cell.name} needs {cell.chips} CUDA device(s); "
                         f"{torch.cuda.device_count()} available")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    inputs = make_inputs(cell, seed, device)
    scfg = sequence_config(cell.config, cell.mix, backend)
    frames = Frames(inputs.frames)

    def sequence(meter=None):
        with torch.profiler.record_function("dicbench.run_sequence"):
            recs = run_sequence(frames, inputs.points, scfg,
                                centers=inputs.centers, meter=meter,
                                device=device)
        _sync(device)
        return recs

    # Set-up: loading (the kernel library is built on a checkout's first
    # run), the inputs, and whole sequences, which meet every shape the
    # window does; the second finds the allocators' pools as the window
    # will.
    for _ in range(WARM_SEQUENCES):
        sequence()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    # The measured window.
    outputs = Outputs()
    meter = SolveMeter()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    w0 = time.perf_counter()
    ends = []
    while True:
        outputs.add(sequence(meter))
        ends.append(time.perf_counter() - w0)
        if ends[-1] >= seconds:
            break
    _sync(device)
    wall = time.perf_counter() - w0
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    print(f"dicbench: set-up {setup_s:.3f} s; window {wall:.3f} s, "
          f"solve blocks {meter.seconds:.3f} s, "
          f"{len(ends)} sequences ending at "
          + " ".join(f"{t:.3f}" for t in ends), file=sys.stderr)
    window = dict(wall=wall, meter_s=meter.seconds, solves=outputs.solves,
                  failed=outputs.failed, pairs=outputs.pairs,
                  iterations=outputs.iterations, sequences=outputs.sequences)

    trace_res = None
    if traced:
        from dicbench import trace

        trace_res = {}
        with trace.profiled(trace_res):
            for _ in range(TRACED_SEQUENCES):
                outputs.add(sequence())
        trace_res["pairs"] = TRACED_SEQUENCES * inputs.pairs
        # The profiler's own cost: the traced slice's wall a sequence
        # against the untraced window's.
        print(f"dicbench: traced slice {trace_res.get('window_s', 0.0):.3f} s "
              f"for {TRACED_SEQUENCES} sequences, "
              f"{trace_res.get('window_s', 0.0) / TRACED_SEQUENCES:.3f} s a "
              f"sequence; the window's {wall / len(ends):.3f} s",
              file=sys.stderr)

    result = {
        "correct": False,
        "attempted": window["solves"],
        "failed": window["failed"],
        "metrics": {},
        "device": {
            "platform": "gpu" if on_card else device.type,
            "kind": (torch.cuda.get_device_name(device) if on_card
                     else device.type),
            "count": cell.chips,
            "memory_peak_bytes": int(max(setup_peak, window_peak)),
        },
    }
    run = Run(cell, device, scfg, inputs, window, trace_res, outputs)
    if not traced:
        values = {"solves_per_s": (window["solves"] / wall, "solves/s"),
                  "peak_mem_gib": (window_peak / 2 ** 30, "GiB"),
                  "setup_s": (setup_s, "s")}
        for m in cell.end_to_end:
            if m["name"] in values:
                v, unit = values[m["name"]]
                result["metrics"][m["name"]] = {"value": v, "unit": unit}
    else:
        for m in cell.per_layer:
            value = spec.load("metrics", m["name"], cell.root).read(run)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["device"]["busy_s"] = trace_res.get("busy_s", 0.0)
        result["device"]["window_s"] = trace_res.get("window_s", 0.0)
        result["breakdown"] = {
            "device_ops": [list(x) for x in trace_res.get("device_ops",
                                                          [])[:10]],
            "idle_gaps": [list(x) for x in trace_res.get("idle_gaps",
                                                         [])[:10]],
        }

    # The check, once the window has closed and the program's state is
    # freed: the plain reference on the same inputs, against every
    # distinct output of the timed calls.
    del run
    if on_card:
        torch.cuda.empty_cache()
    from dicbench.check import check_outputs

    numbers = check_outputs(cell, inputs, outputs, device)
    result["correct"] = bool(outputs.solves > 0 and all(
        v["value"] <= v["limit"] for v in numbers.values()))
    result["checks"] = numbers
    return result


def main(argv=None, t0: float | None = None) -> int:
    """The command line: one run of one cell; prints the result as the
    last line of standard output and the compared numbers as the last
    lines of standard error."""
    import argparse

    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description="One run of one dicbench cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), t0)
    except NoCard as exc:
        print(f"dicbench: {exc}", file=sys.stderr)
        return 5
    found = forbidden_modules()
    if found:
        print(f"dicbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 6
    for name, v in result["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
