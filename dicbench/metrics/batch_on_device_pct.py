"""sequence layer: the share (%) of the subset batches run_sequence built
on the card (the program's batches_on_device over batches counters,
recorded over two more sequences by dicbench.program_record).  A program
without these counters gives None."""

from dicbench.program_record import record


def read(run):
    rec = record(run)
    if rec is None or not rec.counters.get("batches"):
        return None
    return 100.0 * rec.counters["batches_on_device"] / rec.counters["batches"]
