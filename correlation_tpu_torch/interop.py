"""Carrying problems and state over from the JAX package.

The system has no weights.  What has to cross between correlation_tpu and
this port is the subset geometry (domains and their batches), the solver
and sequence configurations and the chain state between chunks of a
sequence (checkpoint files load in
both packages as they are: utils/checkpoint.py).  These functions take the JAX
package's values as numpy arrays or plain dicts; none of them imports
correlation_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from correlation_tpu_torch.config import (
    DeformationDescription,
    DomainType,
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
    _level_extents,
)


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


_DOMAINS = {
    DomainType.RECTANGULAR: RectangularDomain,
    DomainType.ANNULAR: AnnularDomain,
    DomainType.BLOB: BlobDomain,
}


def domain_from_dict(kind, d: dict):
    """The port's RectangularDomain / AnnularDomain / BlobDomain from
    dataclasses.asdict of the JAX domain of that DomainType (`kind`, the
    enum or its int); the same domain gives the same point lists in both
    packages."""
    cls = _DOMAINS[DomainType(int(kind))]
    d = dict(d)
    if cls is BlobDomain:
        d["contour"] = np.array(d["contour"], np.float32).reshape(-1, 2)
    return cls(**d)


def solver_config_from_dict(d: dict) -> SolverConfig:
    """A SolverConfig from dataclasses.asdict of the JAX SolverConfig
    (enums as ints, pyramid as a dict); a JAX backend name is stored as
    the port's (config.JAX_BACKENDS)."""
    d = dict(d)
    pyramid = d.pop("pyramid", {})
    if not isinstance(pyramid, PyramidConfig):
        pyramid = PyramidConfig(**dict(pyramid))
    model = FittingModel(int(d.pop("model", FittingModel.AFFINE)))
    interp = Interpolation(int(d.pop("interpolation", Interpolation.BICUBIC)))
    return SolverConfig(
        model=model,
        interpolation=interp,
        pyramid=pyramid,
        **d,
    )


def sequence_config_from_dict(d: dict):
    """A sequence.SequenceConfig from dataclasses.asdict of the JAX
    SequenceConfig (enums as ints, the solver as a dict)."""
    from correlation_tpu_torch.sequence import SequenceConfig

    d = dict(d)
    solver = d.pop("solver", {})
    if not isinstance(solver, SolverConfig):
        solver = solver_config_from_dict(solver)
    return SequenceConfig(
        solver=solver,
        deformation=DeformationDescription(
            int(d.pop("deformation", DeformationDescription.EULERIAN))),
        reference=ReferenceImage(int(d.pop("reference", ReferenceImage.FIRST))),
        error_mode=ErrorMode(int(d.pop("error_mode", ErrorMode.CONTINUE))),
        **d,
    )


def chain_seed_from_numpy(carry, device=None):
    """The port's seeds from the JAX correlate_frames carry as numpy
    arrays: (p_seed, prev_seed, chi_seed, it_seed) from the Eulerian carry
    (p, prev, chi, it), and off_seed, ucen_seed as well from the Lagrangian
    carry (p, prev, chi, it, off, ucen)."""
    if len(carry) not in (4, 6):
        raise ValueError(
            f"expected the carry (p, prev, chi, it) or (p, prev, chi, it, "
            f"off, ucen), got {len(carry)} arrays"
        )
    p, prev, chi, it, *lagr = (np.array(a) for a in carry)
    if p.shape != prev.shape or p.ndim != 2 or chi.shape != (p.shape[0],):
        raise ValueError(f"carry shapes {p.shape}, {prev.shape}, {chi.shape}")
    if any(a.shape != (p.shape[0], 2) for a in lagr):
        raise ValueError(f"off / ucen shapes {[a.shape for a in lagr]}")
    f32 = torch.float32
    return (
        torch.as_tensor(p, dtype=f32, device=device),
        torch.as_tensor(prev, dtype=f32, device=device),
        torch.as_tensor(chi, dtype=f32, device=device),
        torch.as_tensor(it, dtype=torch.int32, device=device),
    ) + tuple(torch.as_tensor(a, dtype=f32, device=device) for a in lagr)
