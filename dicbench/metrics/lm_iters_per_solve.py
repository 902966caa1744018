"""engine layer: the mean LM iterations of a solve over the measured
window, from the records' iterations (the finest level's)."""


def read(run):
    w = run.window
    if not w["solves"]:
        return None
    return w["iterations"] / w["solves"]
