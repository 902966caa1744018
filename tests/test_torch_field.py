"""The port's coefficient-field assembly (backend "field") against the JAX
package's backend "xla".

Both read the same coefficient field (equal bit for bit,
test_torch_interp.py) and differ in the order of two sums: the bicubic
polynomial (a fixed order in the port, einsum in JAX) and the Gram (the
fused kernel's order in the port, one matmul in JAX).  The assembly is
held to test_torch_assemble.py's summation-order tolerances; the solves
to params within 5e-4 and chi within 1e-3 relative, with identical
iterations and error codes.  (The bicubic polynomial's float32 rounding,
~1e-4 of w on a speckle, is what makes these wider than the tiled path's
5e-5: the tiled path and JAX's Pallas kernel evaluate the same separable
taps.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from correlation_tpu.config import FittingModel as JModel
from correlation_tpu.config import Interpolation as JInterp
from correlation_tpu.config import PyramidConfig as JPyramid
from correlation_tpu.config import SolverConfig as JSolver
from correlation_tpu.domains import make_batch as jax_make_batch
from correlation_tpu.engine import correlate as jax_correlate
from correlation_tpu.engine import correlate_frames as jax_frames
from correlation_tpu.ops.assemble import assemble_normal_equations
from correlation_tpu.ops.interp import precompute_field as jax_field
from correlation_tpu.ops.pyramid import build_pyramid as jax_pyramid
from correlation_tpu_torch import engine
from correlation_tpu_torch.config import (
    ErrorCode,
    FittingModel,
    Interpolation,
    PyramidConfig,
    SolverConfig,
)
from correlation_tpu_torch.domains import make_batch
from correlation_tpu_torch.interop import solver_config_from_dict
from correlation_tpu_torch.ops import assemble_v2 as v2
from correlation_tpu_torch.ops.assemble import field_assemble
from correlation_tpu_torch.models.warp import warp_points
from correlation_tpu_torch.ops.interp import precompute_field, sample_field
from synthetic import Speckle

torch.set_num_threads(2)

PARAM_ATOL = 5e-4
CHI_RTOL = 1e-3
_NP = {0: 1, 1: 2, 2: 3, 3: 6}


def _grid(x0, y0, x1, y1):
    return np.stack(
        np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1),
                    indexing="ij"),
        axis=-1,
    ).reshape(-1, 2).astype(np.float32)


def _assembly_problem(model, channels=1):
    """Five 11x11 subsets (the last ragged) on a 96x130 speckle pair at
    parameters near (0.7, -0.4); subset 4 reaches past the right edge, so
    some of its pixels leave the interpolation window."""
    spk = Speckle(96, 130, seed=9)
    und = np.floor(spk.image())
    dfm = np.floor(spk.warped_image(u=0.7, v=-0.4))
    scale = (1.0, 0.8, 0.6, 0.4)[:channels]
    und = np.stack([und * f for f in scale], -1).astype(np.float32)
    dfm = np.stack([dfm * f for f in scale], -1).astype(np.float32)
    cxs = [20, 33, 46, 59, 125]
    xy = np.stack([_grid(cx - 5, 25 + 9 * i - 5, cx + 5, 25 + 9 * i + 5)
                   for i, cx in enumerate(cxs)])
    mask = np.ones(xy.shape[:2], bool)
    mask[3, -7:] = False
    center = xy.mean(axis=1).astype(np.float32)
    und_w = np.where(mask[..., None], und[xy[..., 1].astype(int),
                                          np.minimum(xy[..., 0], 129)
                                          .astype(int)], 0.0)
    rng = np.random.default_rng(4)
    params = rng.normal(0, 0.01, (5, _NP[int(model)])).astype(np.float32)
    params[:, 0] += 0.7
    if params.shape[1] > 1:
        params[:, 1] -= 0.4
    return dfm, xy, mask, center, und_w.astype(np.float32), params


MODELS = list(FittingModel)
INTERPS = list(Interpolation)


@pytest.mark.parametrize("interp", INTERPS, ids=lambda i: i.name)
@pytest.mark.parametrize("model", MODELS, ids=lambda m: m.name)
def test_field_assembly_matches_jax(model, interp):
    dfm, xy, mask, center, und_w, params = _assembly_problem(model)
    a0, b0, chi0, err0 = (np.asarray(t) for t in assemble_normal_equations(
        JModel(int(model)), JInterp(int(interp)),
        jax_field(jnp.asarray(dfm), JInterp(int(interp))),
        jnp.asarray(und_w), jnp.asarray(xy), jnp.asarray(mask),
        jnp.asarray(center), jnp.asarray(params)))
    t = torch.as_tensor
    pix = v2.pack_pixels(t(xy), t(mask), t(und_w), t(center))
    field = precompute_field(t(dfm), interp)
    got = field_assemble(model, interp, field, pix, t(center),
                         t(params)).numpy()
    n = _NP[int(model)]
    # test_torch_assemble.py's summation-order tolerances.
    np.testing.assert_allclose(got[:, :n, :n], a0, rtol=2e-4,
                               atol=np.abs(a0).max() * 5e-6)
    np.testing.assert_allclose(got[:, :n, n], b0, rtol=2e-4,
                               atol=np.abs(b0).max() * 2e-5)
    # chi also carries the two evaluations of w: within 2e-5 relative plus
    # sum_p (2 |V_p| d_p + d_p^2) over live pixels, d_p the bound on the
    # two w's difference (_w_rounding; zero but for bicubic).
    xy_t = t(xy)
    w, _, _, valid = sample_field(field, interp, warp_points(
        model, t(params), xy_t, t(center)))
    d = _w_rounding(field, interp, warp_points(model, t(params), xy_t,
                                               t(center)))
    live = t(mask) & valid
    v = (t(und_w) - w).abs() * live[..., None]
    extra = ((2 * v + d[..., None]) * d[..., None] * live[..., None]).sum(
        dim=(1, 2)).numpy()
    assert (np.abs(got[:, n, n] - chi0) <= 2e-5 * np.abs(chi0) + extra).all()
    np.testing.assert_array_equal(got[:, n + 1, n + 1] > 0, err0)
    assert err0[4] and not err0[:4].any()
    # Subsets picked by index equal the whole batch's rows.
    idx = torch.tensor([4, 1, 1], dtype=torch.int32)
    part = field_assemble(model, interp, field, pix, t(center), t(params),
                          idx)
    assert torch.equal(part, torch.as_tensor(got)[idx.long()])


def _w_rounding(field, interp, def_xy):
    """[...] bound on |w_port - w_jax| at def_xy: for bicubic, both sides'
    float32 rounding of the 16-term polynomial, 2 * 16 * 2^-24 *
    sum_k |c_k| 2^j 2^i (the local coordinates lie in [1, 2), so term
    4 j + i is at most |c_k| 2^j 2^i), maximised over the channels; zero
    for nearest and bilinear, which evaluate alike."""
    if interp != Interpolation.BICUBIC:
        return torch.zeros(def_xy.shape[:-1])
    hf, wf = field.field.shape[:2]
    ix = torch.clamp(torch.nan_to_num(torch.floor(def_xy[..., 0]) - 1),
                     0, wf - 1).long()
    iy = torch.clamp(torch.nan_to_num(torch.floor(def_xy[..., 1]) - 1),
                     0, hf - 1).long()
    j, i = np.divmod(np.arange(16), 4)
    weight = torch.as_tensor(2.0 ** j * 2.0 ** i, dtype=torch.float32)
    scale = (field.field[iy, ix].abs() * weight).sum(-1).amax(-1)
    return 2 * 16 * 2.0 ** -24 * scale


def _pyramids(und, dfm, stop):
    up = jax_pyramid(jnp.asarray(und, jnp.float32), stop)
    dp = jax_pyramid(jnp.asarray(dfm, jnp.float32), stop)
    return up, dp


def _assert_same_solve(got, ref, rows=slice(None)):
    np.testing.assert_array_equal(got.error.numpy()[rows],
                                  np.asarray(ref.error)[rows])
    np.testing.assert_array_equal(got.iterations.numpy()[rows],
                                  np.asarray(ref.iterations)[rows])
    np.testing.assert_allclose(got.params.numpy()[rows],
                               np.asarray(ref.params)[rows], atol=PARAM_ATOL)
    np.testing.assert_allclose(got.chi.numpy()[rows],
                               np.asarray(ref.chi)[rows], rtol=CHI_RTOL)


@pytest.mark.parametrize(
    "model,interp,stop",
    [(FittingModel.AFFINE, Interpolation.BICUBIC, 2),
     (FittingModel.UVQ, Interpolation.BILINEAR, 1),
     (FittingModel.UV, Interpolation.NEAREST, 1),
     (FittingModel.U, Interpolation.BICUBIC, 0)],
    ids=lambda v: getattr(v, "name", str(v)))
def test_correlate_matches_jax_xla(model, interp, stop):
    """One pair: the subsets of test_torch_engine.py's oracle case, one
    warped out of the image (MODEL_OUT_OF_IMAGE), one into the bicubic
    margin only, all frozen by their first assembly as in JAX."""
    spk = Speckle(72, 70, seed=23)
    und = np.floor(spk.image())[..., None]
    dfm = np.floor(spk.warped_image(u=0.9, v=0.7))[..., None]
    subsets = [_grid(16, 16, 32, 34), _grid(36, 20, 52, 36),
               _grid(24, 40, 44, 56), _grid(16, 16, 32, 34),
               _grid(10, 10, 20, 20)]
    guesses = np.zeros((5, _NP[int(model)]), np.float32)
    guesses[:, 0] = 0.5
    guesses[3, 0] = 300.0
    guesses[4, 0] = -9.5
    up, dp = _pyramids(und, dfm, stop)
    ref = jax_correlate(
        JSolver(model=JModel(int(model)), interpolation=JInterp(int(interp)),
                pyramid=JPyramid(0, 1, stop), backend="xla"),
        up, dp, jax_make_batch(subsets, None, stop), guesses)
    got = engine.correlate(
        SolverConfig(model=model, interpolation=interp,
                     pyramid=PyramidConfig(0, 1, stop), backend="field"),
        [np.asarray(a) for a in up], [np.asarray(a) for a in dp],
        make_batch(subsets, None, stop), guesses, device="cpu")
    _assert_same_solve(got, ref)
    assert int(got.error[3]) == ErrorCode.MODEL_OUT_OF_IMAGE
    assert (got.error.numpy()[:3] == 0).all()


@pytest.fixture(scope="module")
def frames():
    spk = Speckle(96, 96, seed=42)
    stack = np.stack([spk.warped_image(u=0.6 * t, v=-0.35 * t, quantize=True)
                      for t in range(3)])[..., None].astype(np.uint8)
    pts = [_grid(cx - 8, cy - 8, cx + 8, cy + 8)
           for cx in (32, 60) for cy in (34, 62)]
    return stack, pts


@pytest.mark.parametrize("mode", ["eulerian-first", "lagrangian-previous"])
def test_correlate_frames_matches_jax_xla(frames, mode, monkeypatch):
    stack, pts = frames
    kw = ({} if mode == "eulerian-first"
          else dict(reference_first=False, lagrangian=True,
                    float_centers=False))
    guess = np.zeros((len(pts), 6), np.float32)

    def no_kernel(*args, **kwargs):
        raise AssertionError("the field path reached the fused assembly")

    monkeypatch.setattr(v2, "fused_assemble", no_kernel)
    ref = jax_frames(JSolver(pyramid=JPyramid(0, 1, 2), backend="xla"),
                     jnp.asarray(stack), jax_make_batch(pts, None, 2), guess,
                     **kw)
    got = engine.correlate_frames(
        SolverConfig(pyramid=PyramidConfig(0, 1, 2), backend="field"), stack,
        make_batch(pts, None, 2), guess, device="cpu", **kw)
    packed, want = got["packed"].numpy(), np.asarray(ref["packed"])
    assert packed.shape == want.shape == (2, 4, 9)
    np.testing.assert_allclose(packed[..., :6], want[..., :6],
                               atol=PARAM_ATOL)
    np.testing.assert_allclose(packed[..., 6], want[..., 6], rtol=CHI_RTOL)
    np.testing.assert_array_equal(packed[..., 7:], want[..., 7:])
    step = [[0.6, -0.35]] if kw else [[0.6, -0.35], [1.2, -0.7]]
    for t, uv in enumerate(step):
        np.testing.assert_allclose(packed[t, :, :2], np.tile(uv, (4, 1)),
                                   atol=0.02)


@pytest.mark.parametrize("deformation", ["lagrangian", "strict-lagrangian"])
def test_run_sequence_carries_the_field_backend(frames, deformation,
                                                monkeypatch):
    """run_sequence on the chunked Lagrangian path and on the
    strict-Lagrangian pair-by-pair path reaches the field assembly and never
    the fused one, and tracks the drift as the tiled path does."""
    from correlation_tpu_torch.config import (
        DeformationDescription,
        ReferenceImage,
    )
    from correlation_tpu_torch.sequence import SequenceConfig, run_sequence

    stack, pts = frames
    desc = {"lagrangian": DeformationDescription.LAGRANGIAN,
            "strict-lagrangian": DeformationDescription.STRICT_LAGRANGIAN}

    def run(backend):
        cfg = SequenceConfig(
            solver=SolverConfig(pyramid=PyramidConfig(0, 1, 2),
                                backend=backend),
            deformation=desc[deformation], reference=ReferenceImage.PREVIOUS)
        return run_sequence(list(stack), pts, cfg, device="cpu")

    tiled = run("torch")
    with monkeypatch.context() as m:
        def no_kernel(*args, **kwargs):
            raise AssertionError("the field path reached the fused assembly")

        m.setattr(v2, "fused_assemble_reference", no_kernel)
        m.setattr(v2, "fused_assemble", no_kernel)
        field = run("field")
    assert len(field) == len(tiled) == 2
    for got, ref in zip(field, tiled):
        np.testing.assert_array_equal(got.error, ref.error)
        np.testing.assert_allclose(got.params, ref.params, atol=PARAM_ATOL)
    if deformation == "lagrangian":  # per-pair increments
        for got in field:
            np.testing.assert_allclose(got.params[:, :2],
                                       np.tile([0.6, -0.35], (len(pts), 1)),
                                       atol=0.02)


def test_warp_beyond_tile_margin_solves_on_the_field():
    """A 21x21 subset stretched by 60 % in x grows 12 px, past the tiled
    assembly's tile_margin of 8: the tiled path flags it out of image; the
    field path solves it, as JAX "xla" does."""
    spk = Speckle(96, 96, seed=8)
    strain = np.array([[0.6, 0.0], [0.0, 0.0]])
    und = spk.image(quantize=True)[..., None]
    dfm = spk.warped_image(affine=strain, center=(48.0, 48.0),
                           quantize=True)[..., None]
    pts = [_grid(38, 38, 58, 58)]
    guess = np.array([[0.0, 0.0, 0.6, 0.0, 0.0, 0.0]], np.float32)
    ref = jax_correlate(JSolver(pyramid=JPyramid(0, 1, 0), backend="xla"),
                        [jnp.asarray(und)], [jnp.asarray(dfm)],
                        jax_make_batch(pts, None, 0), guess)

    def port(backend):
        return engine.correlate(
            SolverConfig(pyramid=PyramidConfig(0, 1, 0), backend=backend),
            [und], [dfm], make_batch(pts, None, 0), guess, device="cpu")

    tiled = port("torch")
    assert int(tiled.error[0]) == ErrorCode.INTERPOLATION_OUT_OF_IMAGE
    got = port("field")
    _assert_same_solve(got, ref)
    assert int(got.error[0]) == ErrorCode.NONE
    np.testing.assert_allclose(got.params.numpy()[0],
                               [0.0, 0.0, 0.6, 0.0, 0.0, 0.0], atol=0.01)


def test_four_channels_under_auto_match_jax_auto_on_interior_subsets():
    """Four channels: the port's "auto" and JAX's both take the separable
    tiles ("sep", xla_sep) and solve alike on interior subsets (on every
    subset in test_torch_sep.py); the field assembly, which takes four
    channels too, stays selectable."""
    spk = Speckle(128, 128, seed=31)
    und1 = spk.image(quantize=True)
    dfm1 = spk.warped_image(u=1.3, v=-0.6, quantize=True)
    scale = (1.0, 0.8, 0.6, 0.5)
    und = np.floor(np.stack([und1 * f for f in scale], -1))
    dfm = np.floor(np.stack([dfm1 * f for f in scale], -1))
    subsets = [_grid(cx - 8, cy - 8, cx + 8, cy + 8)
               for cx in range(32, 100, 22) for cy in range(32, 100, 22)]
    guesses = np.zeros((len(subsets), 6), np.float32)
    up, dp = _pyramids(und, dfm, 2)
    ref = jax_correlate(JSolver(pyramid=JPyramid(0, 1, 2)), up, dp,
                        jax_make_batch(subsets, None, 2), guesses)
    cfg = SolverConfig(pyramid=PyramidConfig(0, 1, 2))
    assert engine.resolve_assembly(cfg, 4) == "sep"
    assert engine.resolve_assembly(cfg, 3) == "tiled"
    got = engine.correlate(cfg, [np.asarray(a) for a in up],
                           [np.asarray(a) for a in dp],
                           make_batch(subsets, None, 2), guesses, device="cpu")
    _assert_same_solve(got, ref)
    # Near the motion (the scaled channels are floored, so coarser).
    np.testing.assert_allclose(got.params.numpy()[:, :2],
                               np.tile([1.3, -0.6], (len(subsets), 1)),
                               atol=0.1)


def test_interop_maps_xla_to_field():
    assert solver_config_from_dict({"backend": "xla"}).backend == "field"
    assert solver_config_from_dict({"backend": "xla_sep"}).backend == "sep"
    assert solver_config_from_dict({"backend": "field"}).backend == "field"
    assert solver_config_from_dict({"backend": "pallas"}).backend == "auto"
