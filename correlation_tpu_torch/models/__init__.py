from correlation_tpu_torch.models.warp import (
    best_rotation_affine,
    num_params,
    rotation_angle,
    steepest_descent,
    translate_params,
    warp_jacobian,
    warp_points,
)

__all__ = [
    "warp_points",
    "warp_jacobian",
    "steepest_descent",
    "translate_params",
    "best_rotation_affine",
    "rotation_angle",
    "num_params",
]
