"""The port's separable-tile assembly (backend "sep") against the JAX
package's backend "xla_sep".

Both place a subset's tile from the masked minimum of its warped pixels
and read the same Catmull-Rom / bilinear / nearest taps from it; they
differ in the order of two sums: the taps (a fixed order of gathers in
the port, two einsums over the whole tile in JAX) and the Gram (the fused
kernel's order in the port, one matmul in JAX).  The assembly is held to
test_torch_field.py's summation-order tolerances on A and b and to 2e-5
relative on chi (both evaluate w alike, so the field test's polynomial
term is not needed), with the err flags identical; the solves to
test_torch_engine.py's params within 5e-5 and chi within 5e-5 relative,
with identical iterations and error codes, on every subset, those at the
image edges and an annulus near the edge included.
"""

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
from correlation_tpu.domains import make_batch as jax_make_batch
from correlation_tpu.engine import correlate as jax_correlate
from correlation_tpu.engine import correlate_frames as jax_frames
from correlation_tpu.ops.assemble import assemble_normal_equations_tiles
from correlation_tpu.ops.pyramid import build_pyramid as jax_pyramid
from correlation_tpu_torch import domains as tdom
from correlation_tpu_torch import engine
from correlation_tpu_torch import sequence as tseq
from correlation_tpu_torch.config import (
    DeformationDescription,
    ErrorCode,
    FittingModel,
    Interpolation,
    PyramidConfig,
    ReferenceImage,
    SolverConfig,
)
from correlation_tpu_torch.domains import make_batch
from correlation_tpu_torch.interop import (
    sequence_config_from_dict,
    solver_config_from_dict,
)
from correlation_tpu_torch.ops import assemble_v2 as v2
from correlation_tpu_torch.ops.assemble import sep_assemble
from synthetic import Speckle
from test_torch_sequence import CENTERS, drift_frames, sectors

torch.set_num_threads(2)

PARAM_ATOL = 5e-5
CHI_RTOL = 5e-5
_NP = {0: 1, 1: 2, 2: 3, 3: 6}
H, W = 90, 94  # not multiples of 8: the coarse levels pad to their tiles


def _grid(x0, y0, x1, y1):
    return np.stack(
        np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1),
                    indexing="ij"),
        axis=-1,
    ).reshape(-1, 2).astype(np.float32)


SQUARE = _grid(-5, -5, 5, 5)
# A triangle: its bounding box's top-left corner is not one of its pixels.
TRIANGLE = SQUARE[SQUARE.sum(axis=1) >= 0]


def _assembly_problem(model, channels):
    """Seven subsets of up to 121 px on a 90 x 94 speckle pair at
    parameters near (0.7, -0.4): 0 interior; 1 past the right edge (out of
    the interpolation window); 2 a triangle, sheared (AFFINE) so that the
    fused kernel's corner rule would place its tile 4 px lower; 3 pushed
    into the top-left corner (the origin clipped to 0); 4 stretched (UVQ,
    AFFINE) until pixels leave the tile inside the image; 5 without a
    masked pixel (origin 0); 6 near the bottom-right edge (the origin
    clipped to the image less the tile)."""
    spk = Speckle(H, W, seed=9)
    scale = (1.0, 0.8, 0.6, 0.4)[:channels]
    und = np.stack([np.floor(spk.image()) * f for f in scale], -1)
    dfm = np.stack([np.floor(spk.warped_image(u=0.7, v=-0.4)) * f
                    for f in scale], -1)
    pts = [SQUARE + (30, 30), SQUARE + (89, 40), TRIANGLE + (55, 30),
           SQUARE + (6, 6), SQUARE + (40, 65), SQUARE[:0],
           SQUARE + (75, 80)]
    p_len = len(SQUARE)
    xy = np.zeros((len(pts), p_len, 2), np.float32)
    mask = np.zeros((len(pts), p_len), bool)
    for i, p in enumerate(pts):
        xy[i, :len(p)] = p
        mask[i, :len(p)] = True
    n = np.maximum(mask.sum(axis=1), 1)[:, None]
    center = ((xy * mask[..., None]).sum(axis=1) / n).astype(np.float32)
    iy = np.clip(xy[..., 1].astype(int), 0, H - 1)
    ix = np.clip(xy[..., 0].astype(int), 0, W - 1)
    und_w = np.where(mask[..., None], und[iy, ix], 0.0).astype(np.float32)
    rng = np.random.default_rng(4)
    params = rng.normal(0, 0.01, (len(pts), _NP[int(model)])).astype(
        np.float32)
    params[:, 0] += 0.7
    params[3, 0] = -6.0
    params[6, 0] = 6.0
    if params.shape[1] > 1:
        params[:, 1] -= 0.4
    if model == FittingModel.UVQ:
        params[4, 2] = 1.5
    if model == FittingModel.AFFINE:
        params[4, 2] = 1.2
        params[2, 3] = 0.4
    return dfm.astype(np.float32), xy, mask, center, und_w, params


MODELS = list(FittingModel)
INTERPS = list(Interpolation)
ASSEMBLY_CASES = (
    [(m, i, 1) for m in MODELS for i in INTERPS]
    + [(FittingModel.AFFINE, Interpolation.BICUBIC, c) for c in (3, 4)])


@pytest.mark.parametrize(
    "model,interp,channels", ASSEMBLY_CASES,
    ids=lambda v: getattr(v, "name", f"C{v}"))
def test_sep_assembly_matches_jax(model, interp, channels):
    dfm, xy, mask, center, und_w, params = _assembly_problem(model, channels)
    tile = 24  # choose_tile of the 10 px extents
    a0, b0, chi0, err0 = (np.asarray(t) for t in
                          assemble_normal_equations_tiles(
        JModel(int(model)), JInterp(int(interp)), jnp.asarray(dfm), H, W,
        tile, tile, jnp.asarray(und_w), jnp.asarray(xy), jnp.asarray(mask),
        jnp.asarray(center), jnp.asarray(params)))
    t = torch.as_tensor
    pix = v2.pack_pixels(t(xy), t(mask), t(und_w), t(center))
    got = sep_assemble(model, interp, tile, tile, H, W, t(dfm), pix,
                       t(center), t(params)).numpy()
    n = _NP[int(model)]
    # test_torch_field.py's (test_torch_assemble.py's) tolerances.
    np.testing.assert_allclose(got[:, :n, :n], a0, rtol=2e-4,
                               atol=np.abs(a0).max() * 5e-6)
    np.testing.assert_allclose(got[:, :n, n], b0, rtol=2e-4,
                               atol=np.abs(b0).max() * 2e-5)
    np.testing.assert_allclose(got[:, n, n], chi0, rtol=2e-5)
    np.testing.assert_array_equal(got[:, n + 1, n + 1] > 0, err0)
    flagged = {1, 3} | ({4} if model in (FittingModel.UVQ,
                                         FittingModel.AFFINE) else set())
    assert set(np.flatnonzero(err0)) == flagged
    assert (got[5] == 0).all()
    # Subsets picked by index, repeated, equal the whole batch's rows.
    idx = torch.tensor([4, 1, 1, 2], dtype=torch.int32)
    part = sep_assemble(model, interp, tile, tile, H, W, t(dfm), pix,
                        t(center), t(params), idx)
    assert torch.equal(part, torch.as_tensor(got)[idx.long()])


def test_sep_origins_follow_the_masked_pixels():
    """The triangle's tile starts from its lowest warped pixel, not from its
    bounding box's warped corners (the fused kernel's origin), and the
    subset without a masked pixel gets origin 0."""
    from correlation_tpu_torch.models.warp import warp_points
    from correlation_tpu_torch.ops.assemble import sep_origins

    _, xy, mask, center, _, params = _assembly_problem(FittingModel.AFFINE, 1)
    t = torch.as_tensor
    xd, yd = warp_points(FittingModel.AFFINE, t(params), t(xy),
                         t(center)).unbind(-1)
    org = sep_origins(t(mask), xd, yd, 1, H, W, 24, 24).long()
    want_x = int(np.floor(np.where(mask[2], xd[2].numpy(), np.inf).min())) - 2
    assert int(org[2, 1]) == want_x
    corners = v2.compute_origins(
        FittingModel.AFFINE, Interpolation.BICUBIC,
        v2.subset_bbox(t(xy), t(mask)), t(center), t(params), H, W, 24, 24)
    assert int(corners[2, 1]) == want_x - 4
    assert org[5].tolist() == [0, 0]
    assert org[3].tolist() == [0, 0]  # clipped at the top-left corner
    assert int(org[6, 1]) == W - 24  # clipped at the right edge


def _pyramids(und, dfm, stop):
    return (jax_pyramid(jnp.asarray(und, jnp.float32), stop),
            jax_pyramid(jnp.asarray(dfm, jnp.float32), stop))


def _assert_same_solve(got, ref):
    np.testing.assert_array_equal(got.error.numpy(), np.asarray(ref.error))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(got.params.numpy(), np.asarray(ref.params),
                               atol=PARAM_ATOL)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=CHI_RTOL)


def _both(model, interp, stop, up, dp, batches, guesses, **kw):
    """(JAX xla_sep result, the port's "sep" result) of one pair."""
    jbatch, batch = batches
    ref = jax_correlate(
        JSolver(model=JModel(int(model)), interpolation=JInterp(int(interp)),
                pyramid=JPyramid(0, 1, stop), backend="xla_sep", **kw),
        up, dp, jbatch, guesses)
    got = engine.correlate(
        SolverConfig(model=model, interpolation=interp,
                     pyramid=PyramidConfig(0, 1, stop), backend="sep", **kw),
        [np.asarray(a) for a in up], [np.asarray(a) for a in dp], batch,
        guesses, device="cpu")
    return ref, got


EDGE_SUBSETS = [
    _grid(16, 16, 32, 34),    # interior
    _grid(36, 20, 52, 36),    # interior
    _grid(52, 40, 68, 56),    # 1 px from the right edge
    _grid(16, 16, 32, 34),    # guessed out of the image
    _grid(1, 1, 13, 13),      # in the top-left corner
    _grid(0, 52, 16, 68),     # on the left and bottom edges
]


@pytest.mark.parametrize(
    "model,interp,stop",
    [(FittingModel.AFFINE, Interpolation.BICUBIC, 2),
     (FittingModel.UVQ, Interpolation.BILINEAR, 1),
     (FittingModel.UV, Interpolation.NEAREST, 1),
     (FittingModel.U, Interpolation.BICUBIC, 0)],
    ids=lambda v: getattr(v, "name", str(v)))
def test_correlate_matches_jax_xla_sep_on_all_subsets(model, interp, stop):
    """One 70 x 69 pair (odd sizes: the coarse levels pad to their tiles),
    interior and edge subsets, one guessed out of the image, solved on
    every subset."""
    spk = Speckle(69, 70, seed=23)
    und = np.floor(spk.image())[..., None]
    dfm = np.floor(spk.warped_image(u=0.9, v=0.7))[..., None]
    guesses = np.zeros((len(EDGE_SUBSETS), _NP[int(model)]), np.float32)
    guesses[:, 0] = 0.5
    guesses[3, 0] = 300.0
    up, dp = _pyramids(und, dfm, stop)
    ref, got = _both(model, interp, stop, up, dp,
                     (jax_make_batch(EDGE_SUBSETS, None, stop),
                      make_batch(EDGE_SUBSETS, None, stop)), guesses)
    _assert_same_solve(got, ref)
    assert int(got.error[3]) == ErrorCode.MODEL_OUT_OF_IMAGE
    assert (got.error.numpy()[:2] == 0).all()


@pytest.fixture
def jax_numpy_generators(monkeypatch):
    """The JAX package on its NumPy point generators, the port's only ones
    (test_torch_multi_roi.py)."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_load_attempted", True)


def test_annulus_near_the_edge_matches_jax_xla_sep(jax_numpy_generators):
    """A 1 x 8 annulus whose outer ring reaches within 2 px of the top and
    left edges: sectors whose bounding-box corners are not their pixels,
    and tiles clipped at the edges."""
    spk = Speckle(96, 96, seed=61)
    und = spk.image(quantize=True)[..., None]
    dfm = spk.warped_image(u=0.8, v=-0.6, quantize=True)[..., None]
    up, dp = _pyramids(und, dfm, 1)
    ann = (42, 40, 14, 38, 1, 8)
    batches = (jdom.annular_batch(jdom.AnnularDomain(*ann), 1),
               tdom.annular_batch(tdom.AnnularDomain(*ann), 1))
    guesses = np.zeros((8, 6), np.float32)
    ref, got = _both(FittingModel.AFFINE, Interpolation.BICUBIC, 1, up, dp,
                     batches, guesses)
    _assert_same_solve(got, ref)
    assert (got.error.numpy() == 0).sum() >= 4


def test_sep_solves_where_the_tiled_auto_leaves_jax():
    """A 21 x 21 triangle sheared by du/dy = 0.4: the fused kernel places
    its tile from the warped bounding-box corner that is not a pixel, 8 px
    left of the lowest warped pixel, so its tile ends before the far pixels
    and the tiled "auto" flags the subset out of the image.  JAX's xla_sep
    and the port's "sep" place the tile from the pixels and solve it.  The
    21 x 21 square beside it, whose corners are pixels, grows past the
    tile margin under either rule."""
    spk = Speckle(96, 96, seed=8)
    shear = np.array([[0.0, 0.4], [0.0, 0.0]])
    und = spk.image(quantize=True)[..., None]
    dfm = spk.warped_image(affine=shear, center=(48.0, 48.0),
                           quantize=True)[..., None]
    tri = _grid(-10, -10, 10, 10)
    pts = [tri[tri.sum(axis=1) >= 0] + 48, _grid(38, 38, 58, 58)]
    guesses = np.tile(np.array([0.0, 0.0, 0.0, 0.4, 0.0, 0.0], np.float32),
                      (2, 1))
    up, dp = _pyramids(und, dfm, 0)
    batches = (jax_make_batch(pts, None, 0), make_batch(pts, None, 0))
    ref, got = _both(FittingModel.AFFINE, Interpolation.BICUBIC, 0, up, dp,
                     batches, guesses)
    _assert_same_solve(got, ref)
    out = int(ErrorCode.INTERPOLATION_OUT_OF_IMAGE)
    assert got.error.tolist() == [int(ErrorCode.NONE), out]
    tiled = engine.correlate(SolverConfig(pyramid=PyramidConfig(0, 1, 0)),
                             [np.asarray(a) for a in up],
                             [np.asarray(a) for a in dp], batches[1],
                             guesses, device="cpu")
    assert tiled.error.tolist() == [out, out]
    # The triangle's center lies (10/3, 10/3) px from the shear's.
    np.testing.assert_allclose(got.params.numpy()[0],
                               [0.4 * 10 / 3, 0.0, 0.0, 0.4, 0.0, 0.0],
                               atol=0.01)


def test_four_channels_under_auto_match_jax_auto_on_all_subsets():
    """Four channels: the port's "auto" and JAX's "auto" both take the
    separable tiles, so they solve alike on every subset, the edge ones
    included."""
    spk = Speckle(69, 70, seed=31)
    und1 = spk.image(quantize=True)
    dfm1 = spk.warped_image(u=0.9, v=0.7, quantize=True)
    scale = (1.0, 0.8, 0.6, 0.5)
    und = np.floor(np.stack([und1 * f for f in scale], -1))
    dfm = np.floor(np.stack([dfm1 * f for f in scale], -1))
    guesses = np.zeros((len(EDGE_SUBSETS), 6), np.float32)
    guesses[:, 0] = 0.5
    guesses[3, 0] = 300.0
    up, dp = _pyramids(und, dfm, 2)
    ref = jax_correlate(JSolver(pyramid=JPyramid(0, 1, 2)), up, dp,
                        jax_make_batch(EDGE_SUBSETS, None, 2), guesses)
    cfg = SolverConfig(pyramid=PyramidConfig(0, 1, 2))
    assert engine.resolve_assembly(cfg, 4) == "sep"
    got = engine.correlate(cfg, [np.asarray(a) for a in up],
                           [np.asarray(a) for a in dp],
                           make_batch(EDGE_SUBSETS, None, 2), guesses,
                           device="cpu")
    _assert_same_solve(got, ref)
    assert int(got.error[3]) == ErrorCode.MODEL_OUT_OF_IMAGE


@pytest.fixture(scope="module")
def frames():
    spk = Speckle(90, 94, seed=42)
    stack = np.stack([spk.warped_image(u=0.6 * t, v=-0.35 * t, quantize=True)
                      for t in range(3)])[..., None].astype(np.uint8)
    pts = [_grid(cx - 8, cy - 8, cx + 8, cy + 8)
           for cx in (9, 32, 60, 84) for cy in (34, 80)]
    return stack, pts


@pytest.mark.parametrize("mode", ["eulerian-first", "lagrangian-previous"])
def test_correlate_frames_matches_jax_xla_sep(frames, mode, monkeypatch):
    stack, pts = frames
    kw = ({} if mode == "eulerian-first"
          else dict(reference_first=False, lagrangian=True,
                    float_centers=False))
    guess = np.zeros((len(pts), 6), np.float32)

    def no_kernel(*args, **kwargs):
        raise AssertionError("the sep path reached the fused assembly")

    monkeypatch.setattr(v2, "fused_assemble", no_kernel)
    ref = jax_frames(JSolver(pyramid=JPyramid(0, 1, 2), backend="xla_sep"),
                     jnp.asarray(stack), jax_make_batch(pts, None, 2), guess,
                     **kw)
    got = engine.correlate_frames(
        SolverConfig(pyramid=PyramidConfig(0, 1, 2), backend="sep"), stack,
        make_batch(pts, None, 2), guess, device="cpu", **kw)
    packed, want = got["packed"].numpy(), np.asarray(ref["packed"])
    assert packed.shape == want.shape == (2, len(pts), 9)
    np.testing.assert_allclose(packed[..., :6], want[..., :6],
                               atol=PARAM_ATOL)
    np.testing.assert_allclose(packed[..., 6], want[..., 6], rtol=CHI_RTOL)
    np.testing.assert_array_equal(packed[..., 7:], want[..., 7:])


def test_lagrangian_sequence_matches_jax_xla_sep(monkeypatch):
    """run_sequence, Lagrangian-Previous in chunks of 2 pairs, on a config
    carried over from JAX's (xla_sep maps to "sep"), never reaching the
    fused assembly."""
    frames = drift_frames(4, 1.3, -0.8)
    pts = sectors(CENTERS)
    jcfg = jseq.SequenceConfig(
        solver=JSolver(pyramid=JPyramid(0, 1, 2), backend="xla_sep"),
        deformation=type(jseq.SequenceConfig().deformation)(
            int(DeformationDescription.LAGRANGIAN)),
        reference=type(jseq.SequenceConfig().reference)(
            int(ReferenceImage.PREVIOUS)),
        frame_chunk=2)
    ref = jseq.run_sequence(frames, pts, jcfg)
    d = dataclasses.asdict(jcfg)
    d["solver"]["model"] = int(d["solver"]["model"])
    d["solver"]["interpolation"] = int(d["solver"]["interpolation"])
    cfg = sequence_config_from_dict(d)
    assert cfg.solver.backend == "sep"

    def no_kernel(*args, **kwargs):
        raise AssertionError("the sep path reached the fused assembly")

    monkeypatch.setattr(v2, "fused_assemble", no_kernel)
    monkeypatch.setattr(v2, "fused_assemble_reference", no_kernel)
    got = tseq.run_sequence(frames, pts, cfg, device="cpu")
    assert [r.frame for r in got] == [r.frame for r in ref] == [0, 1, 2]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.error, b.error)
        np.testing.assert_array_equal(a.iterations, b.iterations)
        np.testing.assert_allclose(a.params, b.params, atol=PARAM_ATOL)
        np.testing.assert_allclose(a.chi, b.chi, rtol=CHI_RTOL)


@pytest.mark.parametrize("jax_backend,port_backend", [
    ("xla_sep", "sep"), ("xla", "field"), ("pallas", "auto"),
    ("pallas_dma", "auto"), ("auto", "auto"), ("sep", "sep")])
def test_interop_maps_jax_backends(jax_backend, port_backend):
    assert (solver_config_from_dict({"backend": jax_backend}).backend
            == port_backend)


def test_resolve_assembly_and_device():
    cfg = SolverConfig(backend="sep")
    assert engine.resolve_assembly(cfg, 1) == "sep"
    assert engine.resolve_assembly(SolverConfig(), 3) == "tiled"
    assert engine.resolve_assembly(SolverConfig(backend="field"), 4) == "field"
    assert engine.resolve_assembly(SolverConfig(backend="torch"), 4) == "tiled"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="'sep' solves on a CUDA"):
            engine.resolve_device(cfg)
    assert engine.resolve_device(cfg, "cpu").type == "cpu"
    with pytest.raises(ValueError, match="4 channels"):
        engine.check_channels(SolverConfig(backend="cuda"), (8, 8, 4), "x")
    engine.check_channels(cfg, (8, 8, 4), "x")
