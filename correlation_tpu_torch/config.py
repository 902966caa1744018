"""Configuration enums and dataclasses (PyTorch port).

Mirrors correlation_tpu/config.py: the same enums with the same integer
values, and the same PyramidConfig / SolverConfig defaults, so a
configuration serialised from one package loads in the other
(interop.solver_config_from_dict).
"""

from __future__ import annotations

import dataclasses
import enum


class FittingModel(enum.IntEnum):
    """Warp models: U (1 param), UV (2), UVQ (3), AFFINE (6)."""

    U = 0
    UV = 1
    UVQ = 2
    AFFINE = 3


NUM_PARAMS = {
    FittingModel.U: 1,
    FittingModel.UV: 2,
    FittingModel.UVQ: 3,
    FittingModel.AFFINE: 6,
}


class Interpolation(enum.IntEnum):
    NEAREST = 0
    BILINEAR = 1
    BICUBIC = 2


class DeformationDescription(enum.IntEnum):
    STRICT_LAGRANGIAN = 0
    LAGRANGIAN = 1
    EULERIAN = 2


class ErrorMode(enum.IntEnum):
    STOP_ALL = 0
    STOP_FRAME = 1
    CONTINUE = 2


class ReferenceImage(enum.IntEnum):
    FIRST = 0
    PREVIOUS = 1


class DomainType(enum.IntEnum):
    RECTANGULAR = 0
    ANNULAR = 1
    BLOB = 2


class ErrorCode(enum.IntEnum):
    """Per-subset error codes."""

    NONE = 0
    MODEL_OUT_OF_IMAGE = 1
    INTERPOLATION_OUT_OF_IMAGE = 2
    MAX_ITERS_REACHED = 3
    BAD_DOMAIN = 4
    SOLVER = 5
    DEVICE = 6
    MULTITHREAD = 7


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    """Coarse-to-fine pyramid schedule: levels stop, stop-step, ..., start."""

    start: int = 0
    step: int = 1
    stop: int = 2

    def levels_coarse_to_fine(self) -> list[int]:
        return list(range(self.stop, self.start - 1, -self.step))

    def __post_init__(self):
        if self.step <= 0 or self.start < 0 or self.stop < self.start:
            raise ValueError(f"invalid pyramid schedule {self}")


BACKENDS = ("auto", "cuda", "torch", "sep", "field")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """LM/Gauss-Newton solver settings (defaults as in the JAX package)."""

    model: FittingModel = FittingModel.AFFINE
    interpolation: Interpolation = Interpolation.BICUBIC
    pyramid: PyramidConfig = dataclasses.field(default_factory=PyramidConfig)
    max_iterations: int = 50
    precision: float = 1e-3
    lambda_init: float = 1e-4
    lambda_min: float = 1e-9
    lambda_max: float = 1e9
    lambda_up: float = 10.0
    lambda_down: float = 0.4
    # Which assembly, and where.  "cuda" and "torch" take the tiled fused
    # assembly, at most 3 channels: the CUDA kernel on CUDA tensors and its
    # plain PyTorch version on CPU tensors; "cuda" requires CUDA tensors
    # and "torch" CPU tensors, and the solve raises on the other device.
    # "sep" takes the separable-tile assembly (JAX's "xla_sep": tiles
    # placed from the warped pixels, any number of channels) and "field"
    # the coefficient-field assembly (JAX's "xla"; any number of channels,
    # no tile limit on warps), both on the device of the tensors.  "auto"
    # takes the tiled assembly on either device up to 3 channels and the
    # separable one above.  Given numpy input and no device, "torch"
    # solves on the CPU and the others on the card, raising where there is
    # none (engine.resolve_device).
    backend: str = "auto"
    # Extra pixels of warp headroom in the per-subset image tiles: warps
    # that grow the subset span by more than this flag the subset
    # out-of-image.
    tile_margin: int = 8

    @property
    def num_params(self) -> int:
        return NUM_PARAMS[self.model]

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of {BACKENDS}"
            )
