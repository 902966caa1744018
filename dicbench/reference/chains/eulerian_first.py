"""Eulerian description, reference First: every pair solves frame 0
against frame i + 1 on the same points, from the constant-velocity guess
p_i + (p_i - p_{i-1}) (zero for the first pair, and p_{-1} = 0)."""

from __future__ import annotations

import numpy as np
import torch


def run(solver, frames, pairs: int, num_params: int) -> dict:
    s = len(solver.points)
    p = prev = torch.zeros((s, num_params), dtype=solver.dtype,
                           device=solver.dev)
    out = {k: [] for k in ("params", "chi", "iterations", "error")}
    for i in range(pairs):
        guess = p if i == 0 else p + (p - prev)
        res = solver.solve(0, frames[0], frames[i + 1], guess)
        prev, p = p, res[0]
        for key, val in zip(out, res):
            out[key].append(val.cpu().numpy())
    return {k: np.stack(v) for k, v in out.items()}
