"""kernels layer: K1 (ops/assemble_v2.fused_assemble) at the cell's
level-0 shapes, every subset listed, as a share (%) of the least time
one H100 needs for the assembly's bytes and operations
(dicbench.kernels.k1_share)."""


def read(run):
    if run.device.type != "cuda" or not run.outputs.distinct:
        return None
    from dicbench.kernels import k1_share

    return k1_share(run)
