"""The correctness check: the plain reference (dicbench/reference) solves
the run's own frames and point lists once the window has closed, and
each distinct output of the timed calls is held to it.

Numbers compared, over every pair and subset of a sequence, each against
the cell's limit (cells/<cell>.json):
  uv_gap_px    the widest gap of u or v (level-0 pixels);
  strain_gap   the widest gap of the other parameters (the displacement
               gradients of AFFINE, the rotation of UVQ).
A NaN on one side only reads as an infinite gap.
"""

from __future__ import annotations

import numpy as np
import torch

from dicbench import spec
from dicbench.reference.solver import PairSolver, Settings


def reference_outputs(cell, inputs, device, dtype=torch.float64,
                      pixel_dtype=None) -> dict:
    """The reference's params, chi, iterations and error [pairs, S, ...]
    on the run's inputs, in `dtype` (pixel arithmetic in `pixel_dtype`)."""
    mix = cell.mix
    st = Settings.of(cell.config["solver"])
    chain = spec.load("reference/chains", f"{mix['deformation'].lower()}_"
                      f"{mix['reference'].lower()}", cell.root)
    solver = PairSolver(st, inputs.points, inputs.centers, device, dtype,
                        pixel_dtype)
    frames = torch.as_tensor(inputs.frames, device=device)
    with torch.no_grad():
        return chain.run(solver, frames, inputs.pairs, st.num_params)


def _widest(a: np.ndarray, b: np.ndarray) -> float:
    if a.size == 0:
        return 0.0
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    d = np.where(np.isnan(a) & np.isnan(b), 0.0, d)
    d = np.where(np.isnan(d), np.inf, d)
    return float(d.max())


NUMBERS = ("uv_gap_px", "strain_gap")


def gaps(got: dict, ref: dict) -> dict:
    """The compared numbers of one output against the reference's."""
    p, r = got["params"], ref["params"]
    if p.shape != r.shape:
        return dict.fromkeys(NUMBERS, float("inf"))
    return {"uv_gap_px": _widest(p[..., :2], r[..., :2]),
            "strain_gap": _widest(p[..., 2:], r[..., 2:])}


def check_outputs(cell, inputs, outputs, device) -> dict:
    """{number: {"value", "limit"}} for each number the cell limits: the
    widest reading over the run's distinct outputs (infinite where there
    is none)."""
    ref = reference_outputs(cell, inputs, device)
    worst = dict.fromkeys(NUMBERS, float("inf") if not outputs.distinct
                          else 0.0)
    for arrays in outputs.distinct.values():
        for k, v in gaps(arrays, ref).items():
            worst[k] = max(worst[k], v)
    return {k: {"value": worst[k], "limit": float(limit)}
            for k, limit in cell.checks.items()}
