"""The port's LM step (ops/solve.lm_delta) against correlation_tpu's.

Same unrolled Cholesky; JAX takes lax.rsqrt of the pivot, the port 1/sqrt,
so the two differ by float32 rounding: rtol 1e-5 on well-conditioned
systems.  A singular system must give a non-finite update in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from correlation_tpu.ops.solve import lm_delta as jax_lm_delta
from correlation_tpu_torch.ops.solve import lm_delta

torch.set_num_threads(2)


@pytest.mark.parametrize("n", [1, 2, 3, 6])
def test_lm_delta_matches_jax(n):
    rng = np.random.default_rng(n)
    s = 9
    g = rng.normal(size=(s, n, 40)).astype(np.float32)
    a = np.einsum("sip,sjp->sij", g, g).astype(np.float32) * 50.0
    b = rng.normal(size=(s, n)).astype(np.float32) * 30.0
    lam = rng.uniform(1e-6, 10.0, s).astype(np.float32)
    scaling = (1.0 / rng.integers(30, 450, s)).astype(np.float32)
    a[0] = 0.0  # singular: zero gradients (flat patch)
    b[0] = 0.0
    if n > 1:
        a[1, 1, :] = a[1, 0, :]  # rank-deficient rows
        a[1, :, 1] = a[1, :, 0]
    got = lm_delta(torch.as_tensor(a), torch.as_tensor(b),
                   torch.as_tensor(lam), torch.as_tensor(scaling)).numpy()
    ref = np.asarray(jax_lm_delta(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(lam), jnp.asarray(scaling)))
    assert got.shape == (s, n)
    # Row 0 is singular; row 1 (rank-deficient) is positive definite once
    # damped, so its update stays finite.
    bad = 1
    assert not np.isfinite(got[:bad]).all(axis=1).any()
    assert not np.isfinite(ref[:bad]).all(axis=1).any()
    np.testing.assert_allclose(got[bad:], ref[bad:], rtol=1e-5, atol=1e-7)
    # the damped normal equations hold
    a_d = a[bad:] * scaling[bad:, None, None]
    idx = np.arange(n)
    a_d[:, idx, idx] *= 1.0 + lam[bad:, None]
    np.testing.assert_allclose(
        np.einsum("sij,sj->si", a_d.astype(np.float64), got[bad:]),
        b[bad:] * scaling[bad:, None], rtol=1e-3, atol=1e-4,
    )
