"""The readings that a cell's correctness limits are set from, on the
chip at the cell's own size (dicbench/cells/<cell>.json keeps the
limits, PERF.md the readings).

  python3 dicbench/readings.py --workload <cell> --first-seed <n> \\
      [--seeds 12] [--control-seeds 3] [--out FILE]

For each of --seeds seeds from --first-seed on: the cell's inputs, one
sequence through the timed path (run_sequence, as a run's window calls
it), the float64 reference on the same inputs, and the compared numbers
(dicbench.check.gaps): the lower readings.  For the first --control-seeds
of them, the control: the reference put in the program's place with its
pixel arithmetic in bfloat16 (the nearest precision below the float32
the configuration states), held to the float64 reference: the upper
readings.  Prints one JSON object, last, and writes it to FILE.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> dict:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from dicbench import check, harness, spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("readings.py measures on a CUDA device")
    device = torch.device("cuda", 0)
    scfg = harness.sequence_config(cell.config, cell.mix)
    from correlation_tpu_torch.sequence import run_sequence

    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + i
        row = {"seed": seed}
        inputs = harness.make_inputs(cell, seed, device)
        t = time.perf_counter()
        recs = run_sequence(harness.Frames(inputs.frames), inputs.points,
                            scfg, centers=inputs.centers, device=device)
        row["program_s"] = time.perf_counter() - t
        got = harness.Outputs()
        got.add(recs)
        arrays = next(iter(got.distinct.values()))
        t = time.perf_counter()
        ref = check.reference_outputs(cell, inputs, device)
        row["reference_s"] = time.perf_counter() - t
        row["program"] = check.gaps(arrays, ref)
        row["program_iterations"] = float(arrays["iterations"].mean())
        row["reference_iterations"] = float(ref["iterations"].mean())
        row["iterations_differ"] = float(
            (arrays["iterations"] != ref["iterations"]).mean())
        codes, counts = np.unique(arrays["error"], return_counts=True)
        row["errors"] = {int(k): int(v) for k, v in zip(codes, counts)}
        if i < args.control_seeds:
            t = time.perf_counter()
            ctrl = check.reference_outputs(cell, inputs, device,
                                           torch.float32, torch.bfloat16)
            row["control_s"] = time.perf_counter() - t
            row["control"] = check.gaps(ctrl, ref)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for key in rows[0]["program"]:
        summary[key] = {
            "lower": max(r["program"][key] for r in rows),
            "upper": min((r["control"][key] for r in rows if "control" in r),
                         default=None),
        }
    out = {"workload": cell.name, "rows": rows, "summary": summary}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({"summary": summary}))
    return out


if __name__ == "__main__":
    main()
