"""sequence layer: the share (%) of the measured window's wall outside
run_sequence's solve blocks, 1 - SolveMeter seconds / wall.  The meter is
the program's own, passed as meter=; it times the chunk's dispatch and
the waits for its results, so the rest is staging, batch building and
records on the host."""


def read(run):
    w = run.window
    if w["wall"] <= 0 or w["meter_s"] <= 0:
        return None
    return 100.0 * (1.0 - w["meter_s"] / w["wall"])
