"""The program's own spans and counters, for the metrics that read them.

record(run) runs harness.TRACED_SEQUENCES more sequences, called as the
window calls them, inside the program's
correlation_tpu_torch.utils.profiling.recording() and with no torch
profiler running, and keeps the Recording on the run, so that every
metric of the run reads one recording.  Their records join the run's
outputs, which the correctness check holds to the reference.  A program
without recording() (a checkout from before it had one) gives None, and
the metrics that read it are left out of the result.

The program's spans (names as utils.profiling's constants): seq.run is one
run_sequence call; seq.make_batch, seq.stage, seq.dispatch, seq.fetch and
seq.emit its phases; engine.solve_level one pyramid level's LM loop.
The counters steps and empty_steps count the LM steps issued and those
issued on an empty list (the lengths the steps wrote on the device, read
when the recording closes).
"""

from __future__ import annotations

import sys
import time

from dicbench import harness

_NOT_YET = object()


def record(run):
    """The run's Recording, made on the first call; None where the program
    has no recording()."""
    rec = getattr(run, "_program_record", _NOT_YET)
    if rec is not _NOT_YET:
        return rec
    try:
        from correlation_tpu_torch.utils.profiling import recording
    except ImportError:
        run._program_record = None
        return None
    import torch

    from correlation_tpu_torch.ops import solve
    from correlation_tpu_torch.sequence import run_sequence

    frames = harness.Frames(run.inputs.frames)
    launches = solve.LAUNCHES
    t0 = time.perf_counter()
    with recording() as rec:
        for _ in range(harness.TRACED_SEQUENCES):
            recs = run_sequence(frames, run.inputs.points, run.scfg,
                                centers=run.inputs.centers,
                                device=run.device)
            if run.device.type == "cuda":
                torch.cuda.synchronize(run.device)
            run.outputs.add(recs)
    wall = time.perf_counter() - t0
    w = run.window
    # The recording's own cost: its wall a sequence against the window's;
    # and its counters beside the LM-step launches the program counted.
    print(f"dicbench: recorded {harness.TRACED_SEQUENCES} sequences in "
          f"{wall:.3f} s, {wall / harness.TRACED_SEQUENCES:.3f} s a "
          f"sequence; the window's {w['wall'] / w['sequences']:.3f} s; "
          f"counters {rec.counters}, LM-step launches "
          f"{solve.LAUNCHES - launches}", file=sys.stderr)
    run._program_record = rec
    return rec


def seconds(run, name: str) -> float | None:
    """The summed seconds of the recording's spans named `name`; None where
    there is no recording or no such span."""
    rec = record(run)
    spans = [] if rec is None else [s for s in rec.spans if s.name == name]
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) * 1e-9


def share(run, name: str) -> float | None:
    """The spans named `name` as a share (%) of the recorded run_sequence
    calls' (seq.run) wall."""
    part, whole = seconds(run, name), seconds(run, "seq.run")
    if part is None or not whole:
        return None
    return 100.0 * part / whole
