"""correlation_tpu_torch: the PyTorch and CUDA port of correlation_tpu.

Batched Lucas-Kanade digital image correlation: Levenberg-Marquardt damped
Gauss-Newton over parametric subset warps, solved for thousands of subsets
at once.  The fused assembly runs as a hand-written CUDA kernel on CUDA
tensors and as its plain PyTorch version on CPU tensors.  This package
imports torch and never jax; correlation_tpu stays the reference it is
tested against.
"""

from correlation_tpu_torch.config import (
    ErrorCode,
    FittingModel,
    Interpolation,
    PyramidConfig,
    SolverConfig,
)
from correlation_tpu_torch.domains import SubsetBatch, make_batch
from correlation_tpu_torch.engine import (
    CorrelationResult,
    correlate,
    correlate_frames,
)
from correlation_tpu_torch.ops.pyramid import build_pyramid

__all__ = [
    "ErrorCode",
    "FittingModel",
    "Interpolation",
    "PyramidConfig",
    "SolverConfig",
    "SubsetBatch",
    "CorrelationResult",
    "correlate",
    "correlate_frames",
    "make_batch",
    "build_pyramid",
]
