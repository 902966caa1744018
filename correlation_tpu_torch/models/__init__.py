from correlation_tpu_torch.models.warp import (
    num_params,
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
    "num_params",
]
