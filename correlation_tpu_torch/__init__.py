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
from correlation_tpu_torch.domains import (
    AnnularDomain,
    BlobDomain,
    RectangularDomain,
    SubsetBatch,
    combine_batches,
    make_batch,
    split_result,
)
from correlation_tpu_torch.engine import (
    CorrelationResult,
    correlate,
    correlate_frames,
    correlate_many,
)
from correlation_tpu_torch.ops.pyramid import build_pyramid
from correlation_tpu_torch.sequence import (
    FrameRecord,
    SequenceConfig,
    run_sequence,
    run_sequence_from_files,
)

__all__ = [
    "ErrorCode",
    "FittingModel",
    "Interpolation",
    "PyramidConfig",
    "SolverConfig",
    "SubsetBatch",
    "RectangularDomain",
    "AnnularDomain",
    "BlobDomain",
    "CorrelationResult",
    "correlate",
    "correlate_frames",
    "correlate_many",
    "combine_batches",
    "split_result",
    "make_batch",
    "build_pyramid",
    "FrameRecord",
    "SequenceConfig",
    "run_sequence",
    "run_sequence_from_files",
]
