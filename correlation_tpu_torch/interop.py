"""Carrying problems and state over from the JAX package.

The system has no weights.  What has to cross between correlation_tpu and
this port is the subset geometry, the solver configuration and the chain
state between chunks of a sequence.  These functions take the JAX
package's values as numpy arrays or plain dicts; none of them imports
correlation_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from correlation_tpu_torch.config import (
    FittingModel,
    Interpolation,
    PyramidConfig,
    SolverConfig,
)
from correlation_tpu_torch.domains import SubsetBatch, _level_extents

# JAX assembly backends; all of them map to the port's "auto", which picks
# the CUDA kernel or its plain version by the device of the tensors.
_JAX_BACKENDS = ("auto", "pallas", "pallas_dma", "xla_sep", "xla")
# JAX SolverConfig fields the port has no counterpart for: they schedule
# the straggler compaction of the JAX while loop, which leaves every
# subset's result unchanged, and the port's host loop has no compaction.
JAX_ONLY_FIELDS = ("compact_stages", "compact_factor", "compact_min")


def subset_batch_from_numpy(xy_levels, mask_levels, center0, extents=None):
    """A SubsetBatch from a JAX SubsetBatch's arrays (xy[l] [S, P_l, 2],
    mask[l] [S, P_l], center0 [S, 2], extents [(ext_y, ext_x)] or None)."""
    xs = [np.array(a, np.float32) for a in xy_levels]
    ms = [np.array(a, bool) for a in mask_levels]
    center0 = np.array(center0, np.float32)
    s = center0.shape[0]
    for lvl, (xy, mask) in enumerate(zip(xs, ms)):
        if xy.shape[:2] != mask.shape or xy.shape[0] != s or xy.shape[2] != 2:
            raise ValueError(
                f"level {lvl}: xy {xy.shape} and mask {mask.shape} do not "
                f"match {s} subsets"
            )
    if extents is None:
        extents = _level_extents(xs, ms)
    return SubsetBatch(
        xs, ms, center0, extents=[(int(y), int(x)) for y, x in extents]
    )


def solver_config_from_dict(d: dict) -> SolverConfig:
    """A SolverConfig from dataclasses.asdict of the JAX SolverConfig
    (enums as ints, pyramid as a dict).  The JAX-only compaction fields
    are dropped."""
    d = {k: v for k, v in d.items() if k not in JAX_ONLY_FIELDS}
    backend = d.pop("backend", "auto")
    if backend not in _JAX_BACKENDS and backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    pyramid = d.pop("pyramid", {})
    if not isinstance(pyramid, PyramidConfig):
        pyramid = PyramidConfig(**dict(pyramid))
    model = FittingModel(int(d.pop("model", FittingModel.AFFINE)))
    interp = Interpolation(int(d.pop("interpolation", Interpolation.BICUBIC)))
    return SolverConfig(
        model=model,
        interpolation=interp,
        pyramid=pyramid,
        backend=backend if backend in ("cuda", "torch") else "auto",
        **d,
    )


def chain_seed_from_numpy(carry, device=None):
    """The port's (p_seed, prev_seed, chi_seed, it_seed) from the JAX
    correlate_frames carry (p, prev, chi, it) as numpy arrays."""
    if len(carry) != 4:
        raise ValueError(
            f"expected the Eulerian carry (p, prev, chi, it), got "
            f"{len(carry)} arrays"
        )
    p, prev, chi, it = (np.array(a) for a in carry)
    if p.shape != prev.shape or p.ndim != 2 or chi.shape != (p.shape[0],):
        raise ValueError(f"carry shapes {p.shape}, {prev.shape}, {chi.shape}")
    f32 = torch.float32
    return (
        torch.as_tensor(p, dtype=f32, device=device),
        torch.as_tensor(prev, dtype=f32, device=device),
        torch.as_tensor(chi, dtype=f32, device=device),
        torch.as_tensor(it, dtype=torch.int32, device=device),
    )
