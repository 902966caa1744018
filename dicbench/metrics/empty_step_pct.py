"""engine layer: the share (%) of the LM steps issued whose active list
was empty (the program's empty_steps over steps counters, the list
lengths the steps wrote on the device, recorded over two more sequences
by dicbench.program_record)."""

from dicbench.program_record import record


def read(run):
    rec = record(run)
    if rec is None or not rec.counters.get("steps"):
        return None
    return 100.0 * rec.counters["empty_steps"] / rec.counters["steps"]
