"""sequence layer: the share (%) of run_sequence's wall spent building
the subset batch and moving it to the device (the program's
seq.make_batch spans over its seq.run spans, recorded over two more
sequences by dicbench.program_record)."""

from dicbench.program_record import share


def read(run):
    return share(run, "seq.make_batch")
