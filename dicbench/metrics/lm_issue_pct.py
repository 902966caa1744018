"""engine layer: the share (%) of run_sequence's wall spent in the LM
loops of the pyramid levels (the program's engine.solve_level spans over
its seq.run spans, recorded over two more sequences by
dicbench.program_record).  On the card the loop reads nothing back, so
the span is the host's issue of its launches."""

from dicbench.program_record import share


def read(run):
    return share(run, "engine.solve_level")
