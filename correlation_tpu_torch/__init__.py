"""correlation_tpu_torch: the PyTorch and CUDA port of correlation_tpu.

Batched Lucas-Kanade digital image correlation: Levenberg-Marquardt damped
Gauss-Newton over parametric subset warps, solved for thousands of subsets
at once.  The fused assembly runs as a hand-written CUDA kernel on CUDA
tensors and as its plain PyTorch version on CPU tensors; the
separable-tile assembly (backend "sep") and the coefficient-field one
(backend "field") run as the same PyTorch code on either.  The command line is `python -m correlation_tpu_torch.cli`.
parallel/ shards the subsets over processes, one a card, on
torch.distributed (correlate, correlate_frames and run_sequence take a
mesh=).
This package imports torch and never jax; correlation_tpu stays the
reference it is tested against.
"""

from correlation_tpu_torch.config import (
    DeformationDescription,
    ErrorCode,
    ErrorMode,
    FittingModel,
    Interpolation,
    PyramidConfig,
    ReferenceImage,
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
from correlation_tpu_torch.ops.assemble import field_assemble
from correlation_tpu_torch.ops.interp import (
    InterpField,
    precompute_field,
    sample_field,
)
from correlation_tpu_torch.ops.pyramid import build_pyramid
from correlation_tpu_torch.ops.seed import (
    global_guess_from_pair,
    phase_correlation_guess,
)
from correlation_tpu_torch.parallel import (
    Mesh,
    assemble_pixel_sharded,
    init_distributed,
    make_mesh,
)
from correlation_tpu_torch.sequence import (
    FrameRecord,
    SequenceConfig,
    run_sequence,
    run_sequence_from_files,
)

__all__ = [
    "DeformationDescription",
    "ErrorCode",
    "ErrorMode",
    "FittingModel",
    "Interpolation",
    "ReferenceImage",
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
    "InterpField",
    "precompute_field",
    "sample_field",
    "field_assemble",
    "phase_correlation_guess",
    "global_guess_from_pair",
    "Mesh",
    "init_distributed",
    "make_mesh",
    "assemble_pixel_sharded",
    "cli",
]


def __getattr__(name):
    # The command line loads on first use, so that `python -m
    # correlation_tpu_torch.cli` does not find it imported already.
    if name == "cli":
        import importlib

        return importlib.import_module("correlation_tpu_torch.cli")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
