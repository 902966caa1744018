"""Operators of the port: pyramid, integer sampling and the coefficient
field, the fused assembly (CUDA kernel and plain version), the field
assembly, phase-correlation seeds and the LM step.

The names below are the JAX package's ops exports with a counterpart of
the same name and signature.  Its assemble_normal_equations has none: the
port's assemblies (assemble.field_assemble, assemble.sep_assemble,
assemble_v2.fused_assemble) take packed pixel rows.  Importing this
package neither builds nor loads the CUDA library.
"""

from correlation_tpu_torch.ops.interp import (
    InterpField,
    precompute_field,
    sample_field,
    sample_integer,
)
from correlation_tpu_torch.ops.pyramid import BINOMIAL_1D, build_pyramid
from correlation_tpu_torch.ops.solve import lm_delta

__all__ = [
    "InterpField",
    "precompute_field",
    "sample_field",
    "sample_integer",
    "build_pyramid",
    "BINOMIAL_1D",
    "lm_delta",
]
