"""kernels layer: the share (%) of the pyramid levels whose fused
assembly took K1's split path, a subset cut into spans of a block each
(the program's split_levels over levels counters, recorded over two more
sequences by dicbench.program_record).  A program without the
split_levels counter gives None."""

from dicbench.program_record import record


def read(run):
    rec = record(run)
    if (rec is None or not rec.counters.get("levels")
            or "split_levels" not in rec.counters):
        return None
    return 100.0 * rec.counters["split_levels"] / rec.counters["levels"]
