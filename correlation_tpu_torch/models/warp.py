"""Parametric warp models as batched tensor functions.

Forward-additive warps, parameters p, subset center c, d = (x, y) - c:

  U      (p = [u])                    : T(x,y) = (x + u, y)
  UV     (p = [u, v])                 : T(x,y) = (x + u, y + v)
  UVQ    (p = [u, v, q])              : T(x,y) = (x + u - q*dy, y + v + q*dx)
  AFFINE (p = [u, v, ux, uy, vx, vy]) : T(x,y) = (x + u + ux*dx + uy*dy,
                                                  y + v + vx*dx + vy*dy)

The arithmetic order follows correlation_tpu/models/warp.py term for term,
so both packages round identically.
"""

from __future__ import annotations

import torch

from correlation_tpu_torch.config import NUM_PARAMS, FittingModel


def warp_points(model: FittingModel, params, xy, center):
    """params [..., NP], xy [..., P, 2], center [..., 2] -> [..., P, 2]."""
    x = xy[..., 0]
    y = xy[..., 1]
    if model == FittingModel.U:
        return torch.stack([x + params[..., 0:1], y], dim=-1)
    if model == FittingModel.UV:
        return torch.stack(
            [x + params[..., 0:1], y + params[..., 1:2]], dim=-1
        )
    dx = x - center[..., 0:1]
    dy = y - center[..., 1:2]
    if model == FittingModel.UVQ:
        u, v, q = (params[..., i : i + 1] for i in range(3))
        return torch.stack([x + u - q * dy, y + v + q * dx], dim=-1)
    if model == FittingModel.AFFINE:
        u, v, ux, uy, vx, vy = (params[..., i : i + 1] for i in range(6))
        return torch.stack(
            [x + u + ux * dx + uy * dy, y + v + vx * dx + vy * dy], dim=-1
        )
    raise ValueError(f"unknown model {model}")


def warp_jacobian(model: FittingModel, xy, center):
    """Closed-form dT/dp: (jac_x, jac_y), each [..., P, NP]."""
    ones = torch.ones(xy.shape[:-1], dtype=torch.float32, device=xy.device)
    zeros = torch.zeros_like(ones)
    if model == FittingModel.U:
        return ones[..., None], zeros[..., None]
    if model == FittingModel.UV:
        return (
            torch.stack([ones, zeros], dim=-1),
            torch.stack([zeros, ones], dim=-1),
        )
    dx = xy[..., 0] - center[..., 0:1]
    dy = xy[..., 1] - center[..., 1:2]
    if model == FittingModel.UVQ:
        return (
            torch.stack([ones, zeros, -dy], dim=-1),
            torch.stack([zeros, ones, dx], dim=-1),
        )
    if model == FittingModel.AFFINE:
        return (
            torch.stack([ones, zeros, dx, dy, zeros, zeros], dim=-1),
            torch.stack([zeros, ones, zeros, zeros, dx, dy], dim=-1),
        )
    raise ValueError(f"unknown model {model}")


def steepest_descent(model: FittingModel, xy, center, dwdx, dwdy):
    """H[p] = dw/dx * dTx/dp + dw/dy * dTy/dp: [..., P, NP]."""
    if model == FittingModel.U:
        return dwdx[..., None]
    if model == FittingModel.UV:
        return torch.stack([dwdx, dwdy], dim=-1)
    dx = xy[..., 0] - center[..., 0:1]
    dy = xy[..., 1] - center[..., 1:2]
    if model == FittingModel.UVQ:
        return torch.stack([dwdx, dwdy, -dwdx * dy + dwdy * dx], dim=-1)
    if model == FittingModel.AFFINE:
        return torch.stack(
            [dwdx, dwdy, dwdx * dx, dwdx * dy, dwdy * dx, dwdy * dy], dim=-1
        )
    raise ValueError(f"unknown model {model}")


def translate_params(params, src_level: int, dst_level: int):
    """Rescale u, v by 2^(src - dst) between pyramid levels; strain and
    rotation parameters are scale-invariant."""
    if src_level == dst_level:
        return params
    magnification = float(2.0 ** (src_level - dst_level))
    num_params = params.shape[-1]
    scale = torch.ones(num_params, dtype=params.dtype, device=params.device)
    scale[: min(2, num_params)] = magnification
    return params * scale


def best_rotation_affine(params):
    """Best-fit rotation angle of AFFINE parameters [..., 6]:
    atan2(vx - uy, ux + vy + 2)."""
    return torch.atan2(params[..., 4] - params[..., 3],
                       params[..., 2] + params[..., 5] + 2.0)


def rotation_angle(model: FittingModel, params):
    """The rotation angle reported per model: 0 for U / UV, q for UVQ, the
    best-fit rotation for AFFINE.  params [..., NP] -> [...]."""
    if model in (FittingModel.U, FittingModel.UV):
        return torch.zeros(params.shape[:-1], dtype=torch.float32,
                           device=params.device)
    if model == FittingModel.UVQ:
        return params[..., 2]
    return best_rotation_affine(params)


def num_params(model: FittingModel) -> int:
    return NUM_PARAMS[model]
