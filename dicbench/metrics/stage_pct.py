"""sequence layer: the share (%) of run_sequence's wall spent staging a
chunk's frame stack (stacked, pinned, its copy started: the program's
seq.stage spans over its seq.run spans, recorded over two more sequences
by dicbench.program_record)."""

from dicbench.program_record import share


def read(run):
    return share(run, "seq.stage")
