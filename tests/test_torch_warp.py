"""The port's warp models against correlation_tpu/models/warp.py.

Both evaluate the same float32 expressions term for term, so results must
be equal to the last bit; the tolerance is zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from correlation_tpu.config import FittingModel as JModel
from correlation_tpu.models import warp as jwarp
from correlation_tpu_torch.config import NUM_PARAMS, FittingModel
from correlation_tpu_torch.models import warp as twarp

torch.set_num_threads(2)


def _inputs(model, seed=0):
    rng = np.random.default_rng(seed)
    num_p = NUM_PARAMS[model]
    params = rng.normal(0, 0.1, (3, num_p)).astype(np.float32)
    xy = rng.uniform(0, 50, (3, 11, 2)).astype(np.float32)
    center = rng.uniform(10, 40, (3, 2)).astype(np.float32)
    dwdx = rng.normal(size=(3, 11)).astype(np.float32)
    dwdy = rng.normal(size=(3, 11)).astype(np.float32)
    return params, xy, center, dwdx, dwdy


@pytest.mark.parametrize("model", list(FittingModel))
def test_warp_functions_match_jax(model):
    params, xy, center, dwdx, dwdy = _inputs(model)
    jm = JModel(int(model))
    t = torch.as_tensor
    np.testing.assert_array_equal(
        twarp.warp_points(model, t(params), t(xy), t(center)).numpy(),
        np.asarray(jwarp.warp_points(jm, jnp.asarray(params), jnp.asarray(xy),
                                     jnp.asarray(center))),
    )
    for got, ref in zip(
        twarp.warp_jacobian(model, t(xy), t(center)),
        jwarp.warp_jacobian(jm, jnp.asarray(xy), jnp.asarray(center)),
    ):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        twarp.steepest_descent(model, t(xy), t(center), t(dwdx),
                               t(dwdy)).numpy(),
        np.asarray(jwarp.steepest_descent(
            jm, jnp.asarray(xy), jnp.asarray(center), jnp.asarray(dwdx),
            jnp.asarray(dwdy))),
    )
    for src, dst in ((0, 2), (2, 0), (1, 1)):
        np.testing.assert_array_equal(
            twarp.translate_params(t(params), src, dst).numpy(),
            np.asarray(jwarp.translate_params(jnp.asarray(params), src, dst)),
        )
    assert twarp.num_params(model) == jwarp.num_params(jm)
