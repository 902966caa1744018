"""sequence layer: the share (%) of run_sequence's wall spent emitting
the FrameRecords and checkpoints (the program's seq.emit spans over its
seq.run spans, recorded over two more sequences by
dicbench.program_record)."""

from dicbench.program_record import share


def read(run):
    return share(run, "seq.emit")
