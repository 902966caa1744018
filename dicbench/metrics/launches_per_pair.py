"""engine layer: device kernels launched a frame pair, counted in the
traced slice's profile and divided by the pairs solved there."""


def read(run):
    t = run.trace
    if not t or not t.get("kernels") or not t.get("pairs"):
        return None
    return t["kernels"] / t["pairs"]
