"""The port's phase-correlation seeds (ops/seed.py) against the JAX
package's.  Seeds are whole pixels, so they must be equal, not close: the
test images are clearly shifted speckle, whose correlation peak stands far
above the rest (pocketfft, cuFFT and JAX's FFT differ in the last bits)."""

import numpy as np
import pytest
import torch

from correlation_tpu.ops.seed import global_guess_from_pair as jax_global
from correlation_tpu.ops.seed import phase_correlation_guess as jax_guess
from correlation_tpu_torch import engine
from correlation_tpu_torch.config import (
    FittingModel,
    Interpolation,
    PyramidConfig,
    SolverConfig,
)
from correlation_tpu_torch.domains import make_batch
from correlation_tpu_torch.ops import seed
from correlation_tpu_torch.ops.pyramid import build_pyramid
from correlation_tpu_torch.sequence import SequenceConfig, run_sequence
from synthetic import Speckle


def test_integer_shift_equals_jax():
    spk = Speckle(128, 128, seed=44)
    und = spk.image(quantize=True)[..., None]
    dfm = np.roll(und, (7, -11), axis=(0, 1))  # u = -11, v = 7
    centers = np.array([[64.0, 64.0], [40.0, 80.0], [5.0, 120.0]],
                       np.float32)
    got = seed.phase_correlation_guess(und, dfm, centers, win=64,
                                       device="cpu")
    np.testing.assert_array_equal(got, np.asarray(jax_guess(und, dfm, centers,
                                                            win=64)))
    np.testing.assert_array_equal(got[:2], [[-11.0, 7.0], [-11.0, 7.0]])
    assert got.dtype == np.float32


def test_divergent_per_sector_field_equals_jax():
    """Half the image moves (+12, 0), the other half (-12, 0): each
    sector's window finds its own half's shift, as in JAX."""
    spk = Speckle(160, 160, seed=46)
    gy, gx = np.mgrid[0:160, 0:160]
    u_field = np.where(gy < 80, 12.0, -12.0)
    und = spk.image(quantize=True)[..., None]
    dfm = np.floor(spk.eval(gx - u_field, gy))[..., None].astype(np.float32)
    centers = np.array([(cx, cy) for cy in (36, 56, 104, 124)
                        for cx in (36, 60, 84, 108, 124)], np.float32)
    got = seed.phase_correlation_guess(und, dfm, centers, win=48,
                                       device="cpu")
    np.testing.assert_array_equal(got, np.asarray(jax_guess(und, dfm, centers,
                                                            win=48)))
    np.testing.assert_array_equal(got[:, 0],
                                  np.where(centers[:, 1] < 80, 12.0, -12.0))


@pytest.mark.parametrize("num_params", [1, 2, 6])
def test_global_guess_equals_jax(num_params):
    spk = Speckle(128, 128, seed=45)
    und = spk.image(quantize=True)[..., None]
    dfm = spk.warped_image(u=17.3, v=-9.6, quantize=True)[..., None]
    center = np.array([62.0, 62.0], np.float32)
    got = seed.global_guess_from_pair(und, dfm, center, num_params,
                                      device="cpu")
    np.testing.assert_array_equal(got, jax_global(und, dfm, center,
                                                  num_params))
    assert got.shape == (num_params,)
    np.testing.assert_allclose(got[:2], [17.0, -10.0][:num_params], atol=1.01)


def test_forty_pixel_shift_converges_from_the_seed():
    """A 40 px shift is far beyond the 3-level pyramid's capture range: the
    zero guess fails, the phase-correlation seed converges."""
    spk = Speckle(192, 192, seed=47)
    true_u, true_v = 40.3, -3.6
    und = spk.image(quantize=True)[..., None]
    dfm = spk.warped_image(u=true_u, v=true_v, quantize=True)[..., None]
    cfg = SolverConfig(model=FittingModel.UV,
                       interpolation=Interpolation.BICUBIC,
                       pyramid=PyramidConfig(0, 1, 2), precision=1e-5)
    gx, gy = np.meshgrid(np.arange(60, 90), np.arange(70, 100),
                         indexing="ij")
    pts = [np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)]
    batch = make_batch(pts, None, 2)
    und_pyr = build_pyramid(torch.from_numpy(und), 2)
    def_pyr = build_pyramid(torch.from_numpy(dfm), 2)
    guess = seed.global_guess_from_pair(und, dfm, batch.center0[0], 2,
                                        win=128, device="cpu")
    np.testing.assert_array_equal(guess, [40.0, -4.0])
    res = engine.correlate(cfg, und_pyr, def_pyr, batch, guess[None],
                           device="cpu")
    assert int(res.error[0]) == 0
    np.testing.assert_allclose(res.params.numpy()[0], [true_u, true_v],
                               atol=0.02)
    res0 = engine.correlate(cfg, und_pyr, def_pyr, batch,
                            np.zeros((1, 2), np.float32), device="cpu")
    p0 = res0.params.numpy()[0]
    assert int(res0.error[0]) != 0 or abs(p0[0] - true_u) > 1.0
    # The per-sector seeds drive run_sequence the same way.
    recs = run_sequence([und, dfm], pts, SequenceConfig(solver=cfg),
                        per_sector_guess=seed.phase_correlation_guess(
                            und, dfm, batch.center0, win=128, device="cpu"),
                        device="cpu")
    np.testing.assert_allclose(recs[0].params[0], [true_u, true_v], atol=0.02)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((32, 32, 1), np.float32)
    with pytest.raises(RuntimeError, match="CUDA device"):
        seed.phase_correlation_guess(img, img, np.zeros((1, 2)))
    with pytest.raises(RuntimeError, match="CUDA device"):
        seed.global_guess_from_pair(img, img, np.zeros(2), 2)
