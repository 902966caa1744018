"""Several domains over one frame pair, and an annular sequence: the port's
correlate_many, combine_batches / split_result and run_sequence against
the JAX package's, on the CPU.

The problem is tests/test_domains.py's multi-domain one: a 2 x 2
rectangle, a 1 x 4 annulus and a freehand blob on a 160 x 160 speckle,
UV / BICUBIC at levels 1-0.  JAX runs SolverConfig(backend="pallas") with
its Pallas kernel in interpret mode, the port the plain version of its
kernel.  Tolerances as tests/test_torch_engine.py's: both run the same
float32 arithmetic per pixel and differ in the order of the Gram sums, so
parameters agree within 5e-5 and chi within 5e-5 relative; iterations and
error codes must be identical.

The solves stop at the reference's rule (precision 1e-3), as the port's
other parity tests do, and not at that JAX test's 1e-5: a chi differs
between the two packages' sum orders by up to 2e-5 relative
(tests/test_torch_assemble.py), which at a delta-chi threshold of 1e-5
can end a subset's loop one iteration apart (two annular sectors do).
"""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from correlation_tpu import domains as jdom
from correlation_tpu import native as jnative
from correlation_tpu import sequence as jseq
from correlation_tpu.config import FittingModel as JModel
from correlation_tpu.config import Interpolation as JInterp
from correlation_tpu.config import PyramidConfig as JPyramid
from correlation_tpu.config import SolverConfig as JSolver
from correlation_tpu.engine import correlate_many as jax_correlate_many
from correlation_tpu.ops import assemble_v2 as jv2
from correlation_tpu.ops.pyramid import build_pyramid as jax_pyramid
from correlation_tpu_torch import (
    combine_batches,
    correlate,
    correlate_many,
    split_result,
)
from correlation_tpu_torch import domains as tdom
from correlation_tpu_torch import sequence as tseq
from correlation_tpu_torch.config import (
    DeformationDescription,
    FittingModel,
    Interpolation,
    PyramidConfig,
    ReferenceImage,
    SolverConfig,
)
from correlation_tpu_torch.interop import sequence_config_from_dict
from correlation_tpu_torch.ops import assemble_v2 as tv2
from synthetic import Speckle

torch.set_num_threads(2)

PARAM_ATOL = 5e-5
CHI_RTOL = 5e-5


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


@contextlib.contextmanager
def jax_numpy_generators():
    """The JAX package on its NumPy point generators, the port's only ones
    (its native library computes in float32 and can keep other pixels)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_load_attempted", True)
        yield


def _domains(mod):
    theta = np.linspace(0, 2 * np.pi, 40, endpoint=False)
    contour = np.stack([60 + 22 * np.cos(theta), 118 + 16 * np.sin(theta)],
                       -1).astype(np.float32)
    return [
        mod.rectangular_batch(mod.RectangularDomain(24, 24, 72, 72, 2, 2), 1),
        mod.annular_batch(mod.AnnularDomain(110, 60, 10, 28, 1, 4), 1),
        mod.blob_batch(mod.BlobDomain(contour), 1),
    ]


@pytest.fixture(scope="module")
def problem():
    """(port cfg, JAX cfg, und pyramid, def pyramid, port batches, JAX
    batches, guesses)."""
    spk = Speckle(160, 160, seed=51)
    und = spk.image(quantize=True)[..., None]
    dfm = spk.warped_image(u=0.7, v=-0.5, quantize=True)[..., None]
    # Both packages get the same pyramids (pyramid parity is its own
    # test; the two may differ by one count, PERF.md section 7).
    und_pyr = [np.asarray(a) for a in jax_pyramid(jnp.asarray(und), 1)]
    def_pyr = [np.asarray(a) for a in jax_pyramid(jnp.asarray(dfm), 1)]
    kw = dict(pyramid=(0, 1, 1), precision=1e-3)
    cfg = SolverConfig(model=FittingModel.UV,
                       interpolation=Interpolation.BICUBIC,
                       pyramid=PyramidConfig(*kw["pyramid"]),
                       precision=kw["precision"])
    jcfg = JSolver(model=JModel.UV, interpolation=JInterp.BICUBIC,
                   pyramid=JPyramid(*kw["pyramid"]),
                   precision=kw["precision"], backend="pallas")
    with jax_numpy_generators():
        batches, jbatches = _domains(tdom), _domains(jdom)
    p0s = [np.zeros((b.num_subsets, 2), np.float32) for b in batches]
    return cfg, jcfg, und_pyr, def_pyr, batches, jbatches, p0s


def _assert_same_solve(got, ref):
    np.testing.assert_array_equal(got.error.numpy(), np.asarray(ref.error))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(got.params.numpy(), np.asarray(ref.params),
                               atol=PARAM_ATOL)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=CHI_RTOL)
    np.testing.assert_array_equal(got.n_points.numpy(),
                                  np.asarray(ref.n_points))
    np.testing.assert_array_equal(got.center.numpy(), np.asarray(ref.center))


def test_correlate_many_matches_jax(problem):
    cfg, jcfg, und_pyr, def_pyr, batches, jbatches, p0s = problem
    for b, jb in zip(batches, jbatches):  # the same point lists
        for a, c in zip(b.xy + b.mask, jb.xy + jb.mask):
            np.testing.assert_array_equal(a, c)
    with pallas_interpret():
        ref = jax_correlate_many(jcfg, und_pyr, def_pyr, jbatches, p0s)
    got = correlate_many(cfg, und_pyr, def_pyr, batches, p0s, device="cpu")
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        _assert_same_solve(g, r)
        np.testing.assert_allclose(g.params[:, 0].numpy(), 0.7, atol=0.02)


def test_correlate_many_equals_separate_calls(problem):
    cfg, _, und_pyr, def_pyr, batches, _, p0s = problem
    many = correlate_many(cfg, und_pyr, def_pyr, batches, p0s, device="cpu")
    for b, p0, got in zip(batches, p0s, many):
        sep = correlate(cfg, und_pyr, def_pyr, b, p0, device="cpu")
        for name in got._fields:
            assert torch.equal(getattr(got, name), getattr(sep, name)), name
    with pytest.raises(ValueError):
        correlate_many(cfg, und_pyr, def_pyr, batches, p0s[:2], device="cpu")


def test_combined_batch_matches_separate_and_jax(problem):
    """One solve of the three domains as one batch: every subset gets the
    blob's tile and padded length, so the Gram sums run in another order
    than the separate solves' (the tolerances of the JAX package's own
    test_combine_batches_matches_separate_dispatches); the same combined
    solve in JAX agrees within the port's tolerances."""
    cfg, jcfg, und_pyr, def_pyr, batches, jbatches, _ = problem
    combined, counts = combine_batches(batches)
    jcombined, _ = jdom.combine_batches(jbatches)
    p0 = np.zeros((combined.num_subsets, 2), np.float32)
    got = correlate(cfg, und_pyr, def_pyr, combined, p0, device="cpu")
    with pallas_interpret():
        ref = jax_correlate_many(jcfg, und_pyr, def_pyr, [jcombined], [p0])
    _assert_same_solve(got, ref[0])
    parts = split_result(got, counts)
    assert [len(p.params) for p in parts] == counts == [4, 4, 1]
    for b, part in zip(batches, parts):
        sep = correlate(cfg, und_pyr, def_pyr, b,
                        np.zeros((b.num_subsets, 2), np.float32),
                        device="cpu")
        np.testing.assert_array_equal(part.error.numpy(), sep.error.numpy())
        np.testing.assert_allclose(part.params.numpy(), sep.params.numpy(),
                                   atol=2e-4)
        np.testing.assert_allclose(part.chi.numpy(), sep.chi.numpy(),
                                   rtol=1e-3)


def test_combined_batch_differs_from_separate_only_by_padding(problem):
    """The padded length alone sets the order of the Gram sums: each
    domain solved on its own tiles but zero-padded to the combined
    batch's lengths equals its share of the combined solve bit for bit."""
    cfg, _, und_pyr, def_pyr, batches, _, _ = problem
    combined, counts = combine_batches(batches)
    got = correlate(cfg, und_pyr, def_pyr, combined,
                    np.zeros((combined.num_subsets, 2), np.float32),
                    device="cpu")
    for b, part in zip(batches, split_result(got, counts)):
        pad = [n.shape[1] - a.shape[1] for n, a in zip(combined.xy, b.xy)]
        padded = tdom.SubsetBatch(
            [np.pad(a, ((0, 0), (0, k), (0, 0))) for a, k in zip(b.xy, pad)],
            [np.pad(m, ((0, 0), (0, k))) for m, k in zip(b.mask, pad)],
            b.center0, b.extents)
        sep = correlate(cfg, und_pyr, def_pyr, padded,
                        np.zeros((b.num_subsets, 2), np.float32),
                        device="cpu")
        for name in ("params", "chi", "iterations", "error"):
            assert torch.equal(getattr(sep, name), getattr(part, name)), name


def test_split_blob_matches_jax(problem):
    """A blob of more than CHUNK_MIN_PIXELS points at level 0, so its Gram
    sums take the split path's order (spans of CHUNK_PIXELS, added in
    span order), against JAX's correlate_many: iterations and error codes
    identical, parameters and chi within this file's tolerances."""
    cfg, jcfg, und_pyr, def_pyr, _, _, _ = problem
    theta = np.linspace(0, 2 * np.pi, 48, endpoint=False)
    contour = np.stack([80 + 34 * np.cos(theta), 80 + 30 * np.sin(theta)],
                       -1).astype(np.float32)
    with jax_numpy_generators():
        jb = jdom.blob_batch(jdom.BlobDomain(contour), 1)
    b = tdom.blob_batch(tdom.BlobDomain(contour), 1)
    for a, c in zip(b.xy + b.mask, jb.xy + jb.mask):
        np.testing.assert_array_equal(a, c)
    assert tv2.subset_chunks(b.xy[0].shape[1]) > 1
    p0 = [np.zeros((1, 2), np.float32)]
    with pallas_interpret():
        ref = jax_correlate_many(jcfg, und_pyr, def_pyr, [jb], p0)
    got = correlate_many(cfg, und_pyr, def_pyr, [b], p0, device="cpu")
    _assert_same_solve(got[0], ref[0])
    assert int(got[0].error[0]) == 0
    np.testing.assert_allclose(got[0].params[0].numpy(), [0.7, -0.5],
                               atol=0.02)


def _drift_frames(n, du, dv, h=96, w=96, seed=42):
    spk = Speckle(h, w, seed=seed)
    return [spk.warped_image(u=du * t, v=dv * t, quantize=True)[..., None]
            for t in range(n)]


@pytest.mark.parametrize(
    "deformation,reference",
    [(DeformationDescription.EULERIAN, ReferenceImage.FIRST),
     (DeformationDescription.LAGRANGIAN, ReferenceImage.PREVIOUS)],
    ids=["eulerian-first", "lagrangian-previous"])
def test_annular_sequence_matches_jax(deformation, reference):
    """run_sequence over a 1 x 4-sector annulus with centers=None (the
    sectors' point means), as the command line runs annular domains."""
    frames = _drift_frames(4, 0.9, -0.6)
    with jax_numpy_generators():
        jb = jdom.annular_batch(jdom.AnnularDomain(48, 47, 10, 30, 1, 4),
                                0)
    tb = tdom.annular_batch(tdom.AnnularDomain(48, 47, 10, 30, 1, 4), 0)
    pts = [xy[m] for xy, m in zip(tb.xy[0], tb.mask[0])]
    for p, xy, m in zip(pts, jb.xy[0], jb.mask[0]):
        np.testing.assert_array_equal(p, xy[m])
    jcfg = jseq.SequenceConfig(
        solver=JSolver(pyramid=JPyramid(0, 1, 1), backend="pallas"),
        deformation=type(jseq.SequenceConfig().deformation)(int(deformation)),
        reference=type(jseq.SequenceConfig().reference)(int(reference)),
        frame_chunk=3,
    )
    with pallas_interpret():
        ref = jseq.run_sequence(frames, pts, jcfg, centers=None)
    d = dataclasses.asdict(jcfg)
    d["solver"]["model"] = int(d["solver"]["model"])
    d["solver"]["interpolation"] = int(d["solver"]["interpolation"])
    got = tseq.run_sequence(frames, pts, sequence_config_from_dict(d),
                            centers=None, device="cpu")
    assert [r.frame for r in got] == [r.frame for r in ref] == [0, 1, 2]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.error, b.error)
        np.testing.assert_array_equal(a.iterations, b.iterations)
        np.testing.assert_array_equal(a.n_points, b.n_points)
        np.testing.assert_allclose(a.params, b.params, atol=PARAM_ATOL)
        np.testing.assert_allclose(a.chi, b.chi, rtol=CHI_RTOL)
        np.testing.assert_allclose(a.und_center, b.und_center, atol=1e-4)
        assert (a.error == 0).all()
    per_pair = deformation == DeformationDescription.LAGRANGIAN
    for t, rec in enumerate(got, start=1):
        expect = np.array([0.9, -0.6]) * (1 if per_pair else t)
        np.testing.assert_allclose(np.median(rec.params[:, :2], axis=0),
                                   expect, atol=0.05)
