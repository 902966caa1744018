"""Host utilities of the port: checkpoints, timing and tracing."""

from correlation_tpu_torch.utils.profiling import (
    SolveMeter,
    recording,
    trace_region,
)

__all__ = ["SolveMeter", "recording", "trace_region"]
