"""engine layer: the share (%) of the pyramid levels run as one CUDA graph
launch whose graph was kept from an earlier level, not instantiated
(100 x (graph_levels - graph_instantiations) / graph_levels, the
program's counters, recorded over two more sequences by
dicbench.program_record).  A program without these counters, or with no
level run as a graph, gives None."""

from dicbench.program_record import record


def read(run):
    rec = record(run)
    if rec is None or not rec.counters.get("graph_levels"):
        return None
    levels = rec.counters["graph_levels"]
    return 100.0 * (levels - rec.counters["graph_instantiations"]) / levels
