"""The port's chained multi-frame solve (correlate_frames) against the JAX
engine's, and chain state handed over between the packages.

Both get the same uint8 frame stack and build their own pyramids; the test
first checks that the pyramids agree for this stack (they can differ by
one count where a window sum lies within float32 rounding of an integer,
see test_torch_pyramid.py).  Tolerances as in test_torch_engine.py:
parameters ~1e-5 (Gram summation order), identical iterations and codes.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from correlation_tpu.config import PyramidConfig as JPyramid
from correlation_tpu.config import SolverConfig as JSolver
from correlation_tpu.domains import make_batch as jax_make_batch
from correlation_tpu.engine import correlate_frames as jax_frames
from correlation_tpu.ops import assemble_v2 as jv2
from correlation_tpu.ops.pyramid import build_pyramid as jax_pyramid
from correlation_tpu_torch import correlate_frames, make_batch
from correlation_tpu_torch.config import PyramidConfig, SolverConfig
from correlation_tpu_torch.interop import chain_seed_from_numpy
from correlation_tpu_torch.ops.pyramid import build_pyramid
from synthetic import Speckle

torch.set_num_threads(2)


@contextlib.contextmanager
def _pallas_interpret():
    """Run JAX's Pallas kernel in interpret mode (as test_assemble_v2.py)."""
    orig = jv2.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    jv2.pl.pallas_call = patched
    jv2.fused_assemble.clear_cache()
    try:
        yield
    finally:
        jv2.pl.pallas_call = orig
        jv2.fused_assemble.clear_cache()


@pytest.fixture(scope="module")
def problem():
    spk = Speckle(96, 96, seed=42)
    frames = np.stack(
        [spk.warped_image(u=0.6 * t, v=-0.35 * t, quantize=True)
         for t in range(4)]
    )[..., None].astype(np.uint8)
    pts = []
    for cx in (32, 60):
        for cy in (34, 62):
            gx, gy = np.meshgrid(np.arange(cx - 8, cx + 9),
                                 np.arange(cy - 8, cy + 9), indexing="ij")
            pts.append(np.stack([gx.ravel(), gy.ravel()], -1))
    return frames, pts


@pytest.fixture(scope="module")
def jax_run(problem):
    frames, pts = problem
    with _pallas_interpret():
        out = jax_frames(JSolver(pyramid=JPyramid(0, 1, 2), backend="pallas"),
                         jnp.asarray(frames), jax_make_batch(pts, None, 2),
                         np.zeros((len(pts), 6), np.float32))
    return {k: (tuple(np.asarray(a) for a in v) if k == "carry"
                else np.asarray(v)) for k, v in out.items()}


def _port(frames, pts, **kw):
    cfg = SolverConfig(pyramid=PyramidConfig(0, 1, 2))
    return correlate_frames(cfg, frames, make_batch(pts, None, 2),
                            np.zeros((len(pts), 6), np.float32), **kw)


def test_pyramids_agree_for_this_stack(problem):
    frames, _ = problem
    for f in frames:
        ref = jax_pyramid(jnp.asarray(f, jnp.float32), 2)
        got = build_pyramid(torch.as_tensor(f, dtype=torch.float32), 2)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_packed_output_matches_jax(problem, jax_run):
    frames, pts = problem
    got = _port(frames, pts)
    packed, ref = got["packed"].numpy(), jax_run["packed"]
    assert packed.shape == ref.shape == (3, 4, 9)
    np.testing.assert_allclose(packed[..., :6], ref[..., :6], atol=5e-5)
    np.testing.assert_allclose(packed[..., 6], ref[..., 6], rtol=5e-5)
    np.testing.assert_array_equal(packed[..., 7:], ref[..., 7:])
    np.testing.assert_allclose(got["guess"].numpy(), jax_run["guess"],
                               atol=1e-4)
    # The chain tracks the drift: frame t moved by (0.6 t, -0.35 t).
    for t in range(3):
        np.testing.assert_allclose(packed[t, :, :2],
                                   np.tile([0.6 * (t + 1), -0.35 * (t + 1)],
                                           (4, 1)), atol=0.02)
    np.testing.assert_array_equal(got["n_points0"].numpy(), 289)


def test_chain_continues_from_jax_carry(problem, jax_run):
    """A sequence started in JAX continues in the port: frames 2-3 solved
    from the JAX carry after frame 1 equal the port's own chained run."""
    frames, pts = problem
    whole = _port(frames, pts)
    with _pallas_interpret():
        out = jax_frames(
            JSolver(pyramid=JPyramid(0, 1, 2), backend="pallas"),
            jnp.asarray(frames[:2]), jax_make_batch(pts, None, 2),
            np.zeros((len(pts), 6), np.float32),
        )
    p, prev, chi, it = chain_seed_from_numpy(
        [np.asarray(a) for a in out["carry"]]
    )
    assert p.dtype == torch.float32 and it.dtype == torch.int32
    rest = _port(frames[[0, 2, 3]], pts, first_chunk=False, p_seed=p,
                 prev_seed=prev, chi_seed=chi, it_seed=it)
    np.testing.assert_allclose(rest["params"].numpy(),
                               whole["params"].numpy()[1:], atol=5e-5)
    np.testing.assert_array_equal(rest["iterations"].numpy(),
                                  whole["iterations"].numpy()[1:])
    np.testing.assert_allclose(rest["packed"].numpy()[..., :6],
                               jax_run["packed"][1:, :, :6], atol=5e-5)


def test_chunks_chain_exactly():
    """Two chunks of two frames equal one chunk of four, bit for bit."""
    spk = Speckle(80, 80, seed=42)
    frames = np.stack(
        [spk.warped_image(u=0.3 * t, v=0.2 * t, quantize=True)
         for t in range(5)]
    )[..., None]
    gx, gy = np.meshgrid(np.arange(30, 51), np.arange(28, 49), indexing="ij")
    pts = [np.stack([gx.ravel(), gy.ravel()], -1)]
    whole = _port(frames, pts)
    first = _port(frames[:3], pts)
    p, prev, chi, it = first["carry"]
    second = _port(frames[[0, 3, 4]], pts, first_chunk=False, p_seed=p,
                   prev_seed=prev, chi_seed=chi, it_seed=it)
    joined = torch.cat([first["packed"], second["packed"]])
    assert torch.equal(joined, whole["packed"])


def test_unported_modes_raise():
    with pytest.raises(NotImplementedError):
        _port(np.zeros((2, 32, 32, 1), np.uint8), [np.zeros((1, 2))],
              lagrangian=True)
