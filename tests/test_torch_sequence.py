"""The port's run_sequence against the JAX package's, in
the chunked Eulerian-First and Lagrangian-Previous modes, and the port's
correlate_frames in the modes run_sequence chains.

Both packages get the same uint8-valued frames and build their own
pyramids; the first test checks that the pyramids agree for these frames.
JAX runs SolverConfig(backend="pallas") with its Pallas kernel in
interpret mode, the port the plain version of its kernel.  Tolerances as
in test_torch_frames.py: parameters 5e-5 (Gram summation order), chi
5e-5 relative, identical iterations and codes; the fields derived from the
parameters (guesses, centers, angles) 1e-4.
"""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from correlation_tpu import sequence as jseq
from correlation_tpu.config import PyramidConfig as JPyramid
from correlation_tpu.config import SolverConfig as JSolver
from correlation_tpu.ops import assemble_v2 as jv2
from correlation_tpu.ops.pyramid import build_pyramid as jax_pyramid
from correlation_tpu_torch import sequence as tseq
from correlation_tpu_torch.config import (
    DeformationDescription,
    PyramidConfig,
    ReferenceImage,
    SolverConfig,
)
from correlation_tpu_torch.domains import make_batch
from correlation_tpu_torch.engine import correlate_frames
from correlation_tpu_torch.interop import sequence_config_from_dict
from correlation_tpu_torch.ops.pyramid import build_pyramid
from synthetic import Speckle

torch.set_num_threads(2)

PARAM_ATOL = 5e-5
CHI_RTOL = 5e-5
DERIVED_ATOL = 1e-4


@contextlib.contextmanager
def pallas_interpret():
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


def drift_frames(n, du, dv, h=96, w=96, seed=42):
    spk = Speckle(h, w, seed=seed)
    return [spk.warped_image(u=du * t, v=dv * t, quantize=True)[..., None]
            for t in range(n)]


def sectors(centers, half=8):
    out = []
    for cx, cy in centers:
        gx, gy = np.meshgrid(np.arange(cx - half, cx + half + 1),
                             np.arange(cy - half, cy + half + 1),
                             indexing="ij")
        out.append(np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32))
    return out


CENTERS = [(32, 34), (60, 34), (32, 62), (60, 62)]


def run_both(frames, pts, stop=2, **kw):
    """(JAX records, port records) of one sequence configuration; kw are
    SequenceConfig fields (deformation / reference / error_mode as port
    enums) and run_sequence arguments."""
    fields = {f.name for f in dataclasses.fields(tseq.SequenceConfig)}
    cfg_kw = {k: v for k, v in kw.items() if k in fields}
    run_kw = {k: v for k, v in kw.items() if k not in fields}
    jcfg = jseq.SequenceConfig(
        solver=JSolver(pyramid=JPyramid(0, 1, stop), backend="pallas"),
        **{k: type(getattr(jseq.SequenceConfig(), k))(int(v))
           if k in ("deformation", "reference", "error_mode") else v
           for k, v in cfg_kw.items()},
    )
    with pallas_interpret():
        ref = jseq.run_sequence(frames, pts, jcfg, **run_kw)
    d = dataclasses.asdict(jcfg)
    d["solver"]["model"] = int(d["solver"]["model"])
    d["solver"]["interpolation"] = int(d["solver"]["interpolation"])
    got = tseq.run_sequence(frames, pts, sequence_config_from_dict(d),
                            device="cpu", **run_kw)
    return ref, got


def assert_same_records(ref, got):
    assert [r.frame for r in got] == [r.frame for r in ref]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.error, b.error)
        np.testing.assert_array_equal(a.iterations, b.iterations)
        np.testing.assert_array_equal(a.n_points, b.n_points)
        np.testing.assert_allclose(a.params, b.params, atol=PARAM_ATOL)
        np.testing.assert_allclose(a.chi, b.chi, rtol=CHI_RTOL)
        for name in ("initial_guess", "und_center", "def_center", "und_angle",
                     "def_angle", "und_global_center", "def_global_center",
                     "und_global_angle", "def_global_angle", "und_e", "def_e",
                     "und_global_e", "def_global_e"):
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       atol=DERIVED_ATOL, err_msg=name)
        for name in ("und_contours", "def_contours", "und_points"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            for p, q in zip(x or [], y or []):
                np.testing.assert_allclose(p, q, atol=DERIVED_ATOL)


@pytest.fixture(scope="module")
def frames():
    return drift_frames(4, 1.3, -0.8)


def test_pyramids_agree_for_these_frames(frames):
    for f in frames:
        ref = jax_pyramid(jnp.asarray(f, jnp.float32), 2)
        got = build_pyramid(torch.as_tensor(f, dtype=torch.float32), 2)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_eulerian_first_chunked_matches_jax(frames):
    ref, got = run_both(frames, sectors(CENTERS))
    assert len(got) == 3
    assert_same_records(ref, got)
    for t, rec in enumerate(got):
        np.testing.assert_allclose(rec.params[:, :2],
                                   np.tile([1.3 * (t + 1), -0.8 * (t + 1)],
                                           (4, 1)), atol=0.02)


def test_lagrangian_previous_chunked_matches_jax(frames):
    """The chunked Lagrangian chain translates the frame-0 level-l point
    sets by floor(off / 2^l + 0.5) at levels >= 1; the port does as JAX
    does, and so equals it.  Centers are the point means (the host mirror
    of the offsets); test_torch_sequence_modes.py has explicit centers."""
    pts = sectors(CENTERS)
    ref, got = run_both(
        frames, pts, deformation=DeformationDescription.LAGRANGIAN,
        reference=ReferenceImage.PREVIOUS, record_points=True,
    )
    assert len(got) == 3
    assert_same_records(ref, got)
    for rec in got:
        np.testing.assert_allclose(rec.params[:, :2],
                                   np.tile([1.3, -0.8], (4, 1)), atol=0.02)
    # The domain moved by whole pixels from frame 1 on.
    off = got[2].und_points[0] - pts[0]
    assert np.all(off == off[0]) and np.abs(off[0]).max() >= 1.0


def test_chunked_lagrangian_matches_port_per_frame(frames):
    """The chunked Lagrangian approximation at levels >= 1 stays within the
    JAX package's own bound of the per-frame path (test_sequence.py)."""
    pts = sectors(CENTERS)
    kw = dict(solver=SolverConfig(pyramid=PyramidConfig(0, 1, 2)),
              deformation=DeformationDescription.LAGRANGIAN,
              reference=ReferenceImage.PREVIOUS)
    chunked = tseq.run_sequence(frames, pts, tseq.SequenceConfig(**kw),
                                device="cpu")
    single = tseq.run_sequence(
        frames, pts, tseq.SequenceConfig(frame_chunk=1, **kw), device="cpu")
    for a, b in zip(chunked, single):
        np.testing.assert_array_equal(a.error, b.error)
        np.testing.assert_allclose(a.params, b.params, atol=5e-3)
        np.testing.assert_allclose(a.und_center, b.und_center, atol=5e-3)


def test_nonzero_guess_chunked_matches_per_frame():
    """With a global guess that is not zero, the chunked Eulerian-First
    chain equals JAX's chunked chain: both seed the first chunk from the
    host state, so the solver starts the second pair from 2 p1 while the
    records report the per-frame path's p1 + (p1 - guess).  The solutions
    stay within 1e-5 of the per-frame path's, with the same iterations."""
    frames = drift_frames(4, 0.6, -0.35)
    pts = sectors(CENTERS)
    guess = np.array([0.5, -0.2, 0.0, 0.0, 0.0, 0.0], np.float32)
    ref, chunked = run_both(frames, pts, global_guess=guess)
    assert len(chunked) == 3
    assert_same_records(ref, chunked)
    single = tseq.run_sequence(
        frames, pts,
        tseq.SequenceConfig(solver=SolverConfig(pyramid=PyramidConfig(0, 1, 2)),
                            frame_chunk=1),
        global_guess=guess, device="cpu")
    for a, b in zip(chunked, single):
        np.testing.assert_allclose(a.initial_guess, b.initial_guess,
                                   atol=1e-5)
        np.testing.assert_allclose(a.params, b.params, atol=1e-5)
        np.testing.assert_array_equal(a.iterations, b.iterations)
    np.testing.assert_allclose(chunked[1].initial_guess[:, :2],
                               2 * chunked[0].params[:, :2] - guess[:2],
                               atol=1e-6)


def test_nonzero_guess_per_frame_matches_jax():
    """The per-frame path with a guess that is not zero equals JAX's
    per-frame path."""
    frames = drift_frames(4, 0.6, -0.35)
    guess = np.array([0.5, -0.2, 0.0, 0.0, 0.0, 0.0], np.float32)
    ref, got = run_both(frames, sectors(CENTERS), frame_chunk=1,
                        global_guess=guess)
    assert len(got) == 3
    assert_same_records(ref, got)
    np.testing.assert_allclose(got[0].initial_guess, np.tile(guess, (4, 1)))


def test_correlate_frames_previous_and_stop_frame_modes():
    """correlate_frames runs reference-Previous, Lagrangian and STOP_FRAME
    (they raised before), and its Lagrangian carry holds off and ucen."""
    frames = np.stack(drift_frames(3, 1.3, -0.8))
    batch = make_batch(sectors(CENTERS[:2]), None, 2)
    cfg = SolverConfig(pyramid=PyramidConfig(0, 1, 2))
    prev = correlate_frames(cfg, frames, batch, np.zeros((2, 6), np.float32),
                            reference_first=False, stop_frame=True,
                            device="cpu")
    np.testing.assert_allclose(prev["params"][:, :, :2].numpy(),
                               np.tile([1.3, -0.8], (2, 2, 1)), atol=0.02)
    lagr = correlate_frames(cfg, frames, batch, np.zeros((2, 6), np.float32),
                            reference_first=False, lagrangian=True,
                            float_centers=False, device="cpu")
    assert len(lagr["carry"]) == 6
    off, ucen = lagr["carry"][4:]
    np.testing.assert_array_equal(off.numpy(), np.tile([1.0, -1.0], (2, 1)))
    np.testing.assert_allclose(
        ucen.numpy(),
        batch.center0 + lagr["params"][0, :, :2].numpy(), atol=1e-5)


@pytest.mark.parametrize("entry", ["run_sequence", "run_sequence_from_files"])
def test_default_device_without_a_card_raises(monkeypatch, tmp_path, entry):
    """Backend "auto" and no device: the sequence solves on the card, so
    without one it raises before any frame is read; nothing falls back to
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tseq.SequenceConfig(solver=SolverConfig(pyramid=PyramidConfig(0, 1, 2)))
    pts = sectors(CENTERS[:1])
    with pytest.raises(RuntimeError, match="CUDA device"):
        if entry == "run_sequence":
            tseq.run_sequence(drift_frames(2, 0.6, -0.35), pts, cfg)
        else:
            missing = [str(tmp_path / f"frame_{i}.png") for i in range(2)]
            tseq.run_sequence_from_files(missing, pts, cfg)


def test_torch_backend_runs_on_the_cpu_by_default():
    """Backend "torch" and no device solves on the CPU and gives the
    records of backend "auto" with device="cpu"."""
    frames = drift_frames(3, 0.6, -0.35)
    pts = sectors(CENTERS[:2])
    solver = dict(pyramid=PyramidConfig(0, 1, 2))
    plain = tseq.run_sequence(frames, pts, tseq.SequenceConfig(
        solver=SolverConfig(backend="torch", **solver)))
    auto = tseq.run_sequence(frames, pts, tseq.SequenceConfig(
        solver=SolverConfig(**solver)), device="cpu")
    assert len(plain) == len(auto) == 2
    for a, b in zip(plain, auto):
        np.testing.assert_array_equal(a.params, b.params)
        np.testing.assert_array_equal(a.iterations, b.iterations)
        np.testing.assert_array_equal(a.error, b.error)
