"""Configuration enums and dataclasses (PyTorch port).

Mirrors correlation_tpu/config.py: the same enums with the same integer
values, and the same PyramidConfig / SolverConfig fields and defaults, so
a JAX configuration constructs here as it is (its backend names are
stored as the port's) and one serialised from one package loads in the
other (interop.solver_config_from_dict).
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
# The JAX package's assembly backends and the port's for each: "xla_sep",
# the separable tiles, maps to "sep", "xla", the coefficient field, to
# "field", and the fused kernel ("pallas", "pallas_dma") to "auto", which
# picks the CUDA kernel or its plain version by the device of the tensors
# (and the separable tiles above 3 channels, as JAX's "auto" does).
JAX_BACKENDS = {"pallas": "auto", "pallas_dma": "auto", "xla_sep": "sep",
                "xla": "field"}


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
    # none (engine.resolve_device).  The JAX package's names are taken too
    # and stored as the port's (JAX_BACKENDS).
    backend: str = "auto"
    # Extra pixels of warp headroom in the per-subset image tiles: warps
    # that grow the subset span by more than this flag the subset
    # out-of-image.
    tile_margin: int = 8
    # The JAX package's straggler-compaction schedule (its defaults; 0
    # stages turns it off there), kept so that a JAX configuration
    # constructs as it is.  Compaction exists because a TPU needs static
    # shapes; it leaves every subset's result unchanged.  The port's LM
    # loop lists the still-active subsets on the device at every
    # iteration, and its kernels' threads past the list's length exit at
    # once, which does the cascade's job, so nothing in the port reads
    # these.
    compact_stages: int = 6
    compact_factor: int = 2
    compact_min: int = 128

    @property
    def num_params(self) -> int:
        return NUM_PARAMS[self.model]

    def __post_init__(self):
        backend = JAX_BACKENDS.get(self.backend, self.backend)
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of "
                f"{BACKENDS} or the JAX package's {tuple(JAX_BACKENDS)}"
            )
        object.__setattr__(self, "backend", backend)
