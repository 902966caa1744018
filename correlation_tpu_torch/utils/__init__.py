"""Host utilities of the port: checkpoints, timing and tracing."""

from correlation_tpu_torch.utils.profiling import SolveMeter, trace_region

__all__ = ["SolveMeter", "trace_region"]
