"""kernels layer: the LM-step kernel (ops/solve.lm_step) at the cell's
subset count, on the device list and writing the next one, as a share
(%) of the least time one H100 needs for the step's bytes
(dicbench.kernels.lm_step_share)."""


def read(run):
    if run.device.type != "cuda" or not run.outputs.distinct:
        return None
    from dicbench.kernels import lm_step_share

    return lm_step_share(run)
