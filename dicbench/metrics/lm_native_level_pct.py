"""engine layer: the share (%) of the pyramid levels whose LM loop was
issued by one call into the kernel library (the program's native_levels
over levels counters, recorded over two more sequences by
dicbench.program_record).  A program without these counters gives None."""

from dicbench.program_record import record


def read(run):
    rec = record(run)
    if rec is None or not rec.counters.get("levels"):
        return None
    return 100.0 * rec.counters["native_levels"] / rec.counters["levels"]
