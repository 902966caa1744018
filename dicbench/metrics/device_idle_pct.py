"""device: the share (%) of the traced slice in which no kernel, copy or
memset ran on the card (the union of the profile's device intervals)."""


def read(run):
    t = run.trace
    if not t or not t.get("busy_s") or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
