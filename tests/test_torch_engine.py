"""The port's single-pair solve (correlation_tpu_torch.engine.correlate)
against the JAX engine and the serial NumPy oracle.

The port follows the tile contract of the JAX Pallas backend, so it is held
against JAX `correlate` with backend="pallas" (pallas_call patched to
interpret mode, as tests/test_assemble_v2.py does).  JAX "auto" resolves to
xla_sep on the CPU, which places its tiles by another rule (from the masked
pixel minimum); against it only interior subsets, whose tiles never
matter, are compared.

Tolerances: both packages run the same per-pixel float32 arithmetic and
differ only in the order of the Gram sums, so parameters agree to ~1e-5
and chi to ~1e-5 relative; iteration counts and error codes must be
identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from correlation_tpu.config import FittingModel as JModel
from correlation_tpu.config import Interpolation as JInterp
from correlation_tpu.config import PyramidConfig as JPyramid
from correlation_tpu.config import SolverConfig as JSolver
from correlation_tpu.domains import make_batch as jax_make_batch
from correlation_tpu.engine import correlate as jax_correlate
from correlation_tpu.ops import assemble_v2 as jv2
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
from synthetic import Speckle

torch.set_num_threads(2)

PARAM_ATOL = 5e-5
CHI_RTOL = 5e-5


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = jv2.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jv2.pl, "pallas_call", patched)
    jv2.fused_assemble.clear_cache()
    yield
    jv2.fused_assemble.clear_cache()


def _grid(x0, y0, x1, y1):
    return np.stack(
        np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1),
                    indexing="ij"),
        axis=-1,
    ).reshape(-1, 2).astype(np.float32)


def _cfgs(model, interp, stop, **kw):
    jax_cfg = JSolver(model=JModel(int(model)), interpolation=JInterp(int(interp)),
                      pyramid=JPyramid(0, 1, stop), backend="pallas", **kw)
    port_cfg = SolverConfig(model=model, interpolation=interp,
                            pyramid=PyramidConfig(0, 1, stop), **kw)
    return jax_cfg, port_cfg


def _solve_both(model, interp, stop, und, dfm, subsets, guesses, **kw):
    jax_cfg, port_cfg = _cfgs(model, interp, stop, **kw)
    und_pyr = jax_pyramid(jnp.asarray(und[..., None], jnp.float32), stop)
    def_pyr = jax_pyramid(jnp.asarray(dfm[..., None], jnp.float32), stop)
    ref = jax_correlate(jax_cfg, und_pyr, def_pyr,
                        jax_make_batch(subsets, None, stop), guesses)
    # Both packages get the same pyramids (pyramid parity is its own test).
    got = engine.correlate(
        port_cfg, [np.asarray(a) for a in und_pyr],
        [np.asarray(a) for a in def_pyr], make_batch(subsets, None, stop),
        guesses, device="cpu",
    )
    return ref, got, und_pyr, def_pyr


def _assert_same_solve(ref, got):
    np.testing.assert_array_equal(got.error.numpy(), np.asarray(ref.error))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(got.params.numpy(), np.asarray(ref.params),
                               atol=PARAM_ATOL)
    np.testing.assert_allclose(got.chi.numpy(), np.asarray(ref.chi),
                               rtol=CHI_RTOL)


@pytest.mark.parametrize(
    "model,interp,omodel,ointerp,levels",
    [
        (FittingModel.UV, Interpolation.BICUBIC, "UV", "bicubic", (0,)),
        (FittingModel.AFFINE, Interpolation.BICUBIC, "AFFINE", "bicubic",
         (2, 1, 0)),
        (FittingModel.UVQ, Interpolation.BILINEAR, "UVQ", "bilinear", (1, 0)),
    ],
)
def test_trajectory_matches_oracle_and_jax(
    pallas_interpret, model, interp, omodel, ointerp, levels
):
    """tests/test_engine.py's oracle case: same converged parameters and
    the same iteration counts as the serial reference loop (its
    tolerances), and the JAX Pallas engine's results."""
    spk = Speckle(72, 70, seed=23)
    und = np.floor(spk.image())
    dfm = np.floor(spk.warped_image(u=0.9, v=0.7))
    stop = max(levels)
    subsets = [_grid(16, 16, 32, 34), _grid(36, 20, 52, 36),
               _grid(24, 40, 44, 56)]
    num_p = oracle.NP_OF[omodel]
    guesses = np.zeros((3, num_p), np.float32)
    guesses[:, 0] = 0.5
    if num_p > 1:
        guesses[:, 1] = 0.5
    ref, got, und_pyr, def_pyr = _solve_both(
        model, interp, stop, und, dfm, subsets, guesses,
        precision=1e-3, max_iterations=50,
    )
    _assert_same_solve(ref, got)
    und64 = [np.asarray(a)[..., 0].astype(np.float64) for a in und_pyr]
    def64 = [np.asarray(a)[..., 0].astype(np.float64) for a in def_pyr]
    for s, pts in enumerate(subsets):
        out = oracle.newton_raphson(
            omodel, ointerp, und64, def64, pts.astype(np.float64),
            guesses[s].astype(np.float64), levels=levels, max_iters=50,
            precision=1e-3,
        )
        assert out["error"] is None
        np.testing.assert_allclose(got.params.numpy()[s], out["params"],
                                   atol=5e-4)
        np.testing.assert_allclose(float(got.chi[s]), out["chi"], rtol=1e-3,
                                   atol=1e-3)
        assert int(got.iterations[s]) == out["iterations"]


def test_initial_failure_codes(pallas_interpret):
    """tests/test_engine.py's init-fail cases in one batch: a guess that
    moves the subset off the image freezes it (MODEL_OUT_OF_IMAGE, guess
    returned, chi FLT_MAX); one that only enters the bicubic margin gives
    INTERPOLATION_OUT_OF_IMAGE; a flat patch gives SOLVER."""
    spk = Speckle(48, 48, seed=24)
    und = spk.image(quantize=True)
    und[30:48, 0:20] = 128.0
    pts = _grid(10, 10, 20, 20)
    flat = _grid(4, 34, 14, 44)
    guesses = np.array(
        [[0.0, 0.0], [300.0, 0.0], [26.5, 0.0], [28.0, 0.0], [0.0, 0.0]],
        np.float32,
    )
    ref, got, _, _ = _solve_both(
        FittingModel.UV, Interpolation.BICUBIC, 0, und, und,
        [pts, pts, pts, pts, flat], guesses,
    )
    _assert_same_solve(ref, got)
    assert got.error.tolist() == [
        ErrorCode.NONE, ErrorCode.MODEL_OUT_OF_IMAGE,
        ErrorCode.INTERPOLATION_OUT_OF_IMAGE, ErrorCode.MODEL_OUT_OF_IMAGE,
        ErrorCode.SOLVER,
    ]
    np.testing.assert_array_equal(got.params.numpy()[1], [300.0, 0.0])
    assert float(got.chi[1]) == float(np.finfo(np.float32).max)


def test_interior_subsets_match_jax_xla_sep():
    """JAX's CPU default backend (xla_sep) on a grid of interior subsets:
    AFFINE/BICUBIC over levels 2-1-0, the slice's configuration."""
    spk = Speckle(128, 128, seed=31)
    und = spk.image(quantize=True)
    dfm = spk.warped_image(u=1.3, v=-0.6, quantize=True)
    subsets = [
        _grid(cx - 8, cy - 8, cx + 8, cy + 8)
        for cx in range(32, 100, 16) for cy in range(32, 100, 16)
    ]
    guesses = np.zeros((len(subsets), 6), np.float32)
    jax_cfg = JSolver(pyramid=JPyramid(0, 1, 2))
    port_cfg = SolverConfig(pyramid=PyramidConfig(0, 1, 2))
    und_pyr = jax_pyramid(jnp.asarray(und[..., None]), 2)
    def_pyr = jax_pyramid(jnp.asarray(dfm[..., None]), 2)
    ref = jax_correlate(jax_cfg, und_pyr, def_pyr,
                        jax_make_batch(subsets, None, 2), guesses)
    got = engine.correlate(
        port_cfg, [np.asarray(a) for a in und_pyr],
        [np.asarray(a) for a in def_pyr], make_batch(subsets, None, 2),
        guesses, device="cpu",
    )
    assert len(subsets) == 25
    _assert_same_solve(ref, got)
    np.testing.assert_allclose(got.params.numpy()[:, :2],
                               np.tile([1.3, -0.6], (25, 1)), atol=0.05)


def test_backend_option():
    spk = Speckle(64, 64, seed=5)
    und = spk.image(quantize=True)[..., None]
    dfm = spk.warped_image(u=0.4, v=0.2, quantize=True)[..., None]
    batch = make_batch([_grid(20, 20, 40, 40)], None, 0)
    cfg = SolverConfig(model=FittingModel.UV, pyramid=PyramidConfig(0, 1, 0))
    auto = engine.correlate(cfg, [und], [dfm], batch, np.zeros((1, 2)),
                            device="cpu")
    plain = engine.correlate(
        SolverConfig(model=FittingModel.UV, pyramid=PyramidConfig(0, 1, 0),
                     backend="torch"),
        [und], [dfm], batch, np.zeros((1, 2)),
    )
    # On CPU tensors "auto" and "torch" both run the plain version, and
    # "torch" solves on the CPU without being told.
    assert auto.params.device.type == plain.params.device.type == "cpu"
    assert torch.equal(auto.params, plain.params)
    assert torch.equal(auto.iterations, plain.iterations)
    with pytest.raises(ValueError):
        engine.correlate(
            SolverConfig(model=FittingModel.UV, pyramid=PyramidConfig(0, 1, 0),
                         backend="cuda"),
            [und], [dfm], batch, np.zeros((1, 2)), device="cpu",
        )
    # A JAX configuration, as it is, solves as its port backend does.
    for jax_name, port_name in (("pallas", "auto"), ("xla_sep", "sep"),
                                ("xla", "field")):
        got, want = (engine.correlate(
            SolverConfig(model=FittingModel.UV,
                         pyramid=PyramidConfig(0, 1, 0), backend=name,
                         compact_stages=0),
            [und], [dfm], batch, np.zeros((1, 2)), device="cpu",
        ) for name in (jax_name, port_name))
        assert torch.equal(got.params, want.params), jax_name
        assert torch.equal(got.iterations, want.iterations), jax_name
    with pytest.raises(ValueError):
        SolverConfig(backend="tpu")


def _one_subset_problem():
    spk = Speckle(64, 64, seed=5)
    und = spk.image(quantize=True)[..., None]
    dfm = spk.warped_image(u=0.4, v=0.2, quantize=True)[..., None]
    return und, dfm, make_batch([_grid(20, 20, 40, 40)], None, 0)


@pytest.mark.parametrize("backend", ["auto", "cuda"])
@pytest.mark.parametrize("entry", ["correlate", "correlate_frames"])
def test_default_device_is_the_card(monkeypatch, entry, backend):
    """Numpy input and no device: backends "auto" and "cuda" solve on the
    card, so without one they raise and name it; nothing falls back to the
    CPU, and "cuda" refuses the CPU when it is named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    und, dfm, batch = _one_subset_problem()
    cfg = SolverConfig(model=FittingModel.UV, pyramid=PyramidConfig(0, 1, 0),
                       backend=backend)
    with pytest.raises(RuntimeError, match="CUDA device"):
        if entry == "correlate":
            engine.correlate(cfg, [und], [dfm], batch, np.zeros((1, 2)))
        else:
            engine.correlate_frames(cfg, np.stack([und, dfm]), batch,
                                    np.zeros((1, 2)))
    if backend == "cuda":
        with pytest.raises(ValueError, match="'cuda' solves on a cuda"):
            engine.resolve_device(cfg, "cpu")
    else:
        assert engine.resolve_device(cfg, "cpu") == torch.device("cpu")


def test_resolve_device_rule(monkeypatch):
    """A named device wins, then the device of a tensor input, then the
    backend: "torch" -> the CPU, "auto" / "cuda" -> the card.  Backend
    "cuda" off a CUDA device and "torch" off the CPU raise ValueError,
    whichever rule chose the device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    auto, plain = SolverConfig(), SolverConfig(backend="torch")
    kernel = SolverConfig(backend="cuda")
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert engine.resolve_device(auto) == cuda
    assert engine.resolve_device(kernel) == cuda
    assert engine.resolve_device(plain) == cpu
    assert engine.resolve_device(auto, like=torch.zeros(1)) == cpu
    assert engine.resolve_device(auto, "cuda:0") == torch.device("cuda:0")
    assert engine.resolve_device(kernel, "cuda:0") == torch.device("cuda:0")
    assert engine.resolve_device(auto, like=np.zeros(1)) == cuda
    for cfg, kwargs in ((plain, {"device": "cuda:0"}),
                        (plain, {"like": torch.zeros(1, device="meta")}),
                        (kernel, {"device": "cpu"}),
                        (kernel, {"like": torch.zeros(1)})):
        with pytest.raises(ValueError, match=f"{cfg.backend!r} solves on"):
            engine.resolve_device(cfg, **kwargs)


@pytest.mark.parametrize("entry", ["correlate", "correlate_many",
                                   "correlate_frames", "run_sequence",
                                   "run_sequence_from_files"])
def test_backend_device_mismatch_raises_before_any_work(monkeypatch,
                                                         tmp_path, entry):
    """Backend "cuda" with device="cpu", and "torch" with a CUDA device,
    raise the ValueError before an image is read, cast or pyramided."""
    from correlation_tpu_torch import io, sequence

    def no_work(*args, **kwargs):
        raise AssertionError("work before the backend/device check")

    und, dfm, batch = _one_subset_problem()
    paths = [str(tmp_path / "f0.png"), str(tmp_path / "f1.png")]
    for m in (engine, sequence):
        monkeypatch.setattr(m, "build_pyramid", no_work)
    monkeypatch.setattr(engine, "_as_f32", no_work)
    monkeypatch.setattr(io, "load_image", no_work)

    def run(backend, device):
        cfg = SolverConfig(model=FittingModel.UV,
                           pyramid=PyramidConfig(0, 1, 0), backend=backend)
        if entry == "correlate":
            engine.correlate(cfg, [und], [dfm], batch, np.zeros((1, 2)),
                             device=device)
        elif entry == "correlate_many":
            engine.correlate_many(cfg, [und], [dfm], [batch],
                                  [np.zeros((1, 2))], device=device)
        elif entry == "correlate_frames":
            engine.correlate_frames(cfg, np.stack([und, dfm]), batch,
                                    np.zeros((1, 2)), device=device)
        elif entry == "run_sequence":
            sequence.run_sequence([und, dfm], [_grid(20, 20, 40, 40)],
                                  sequence.SequenceConfig(solver=cfg),
                                  device=device)
        else:
            sequence.run_sequence_from_files(
                paths, [_grid(20, 20, 40, 40)],
                sequence.SequenceConfig(solver=cfg), device=device)

    with pytest.raises(ValueError, match="'cuda' solves on a cuda device, "
                                         "not on cpu"):
        run("cuda", "cpu")
    with pytest.raises(ValueError, match="'torch' solves on a cpu device, "
                                         "not on cuda"):
        run("torch", "cuda")


@pytest.mark.parametrize(
    "entry", ["correlate_many", "correlate_frames", "run_sequence"])
def test_more_than_three_channels_raise_before_device_work(monkeypatch,
                                                           entry):
    """Four channels under the tiled assembly's backends ("cuda", "torch")
    raise a ValueError that names the 3-channel limit before a device is
    even chosen; "auto" and "sep" solve them on the separable-tile
    assembly, "field" on the coefficient-field one, and recover the
    motion."""
    from correlation_tpu_torch import sequence

    def no_device(*args, **kwargs):
        raise AssertionError("device work before the channel check")

    und, dfm, batch = _one_subset_problem()
    und4, dfm4 = np.repeat(und, 4, axis=-1), np.repeat(dfm, 4, axis=-1)

    def run(backend):
        cfg = SolverConfig(model=FittingModel.UV,
                           pyramid=PyramidConfig(0, 1, 0), backend=backend)
        if entry == "correlate_many":
            return engine.correlate_many(cfg, [und4], [dfm4], [batch],
                                         [np.zeros((1, 2))],
                                         device="cpu")[0].params.numpy()[0]
        if entry == "correlate_frames":
            return engine.correlate_frames(
                cfg, np.stack([und4, dfm4]), batch, np.zeros((1, 2)),
                device="cpu")["params"].numpy()[0, 0]
        return sequence.run_sequence(
            [und4, dfm4], [_grid(20, 20, 40, 40)],
            sequence.SequenceConfig(solver=cfg), device="cpu")[0].params[0]

    with monkeypatch.context() as m:
        m.setattr(engine, "resolve_device", no_device)
        m.setattr(sequence, "resolve_device", no_device)
        for backend in ("cuda", "torch"):
            with pytest.raises(ValueError, match="4 channels.*at most 3"):
                run(backend)
    for backend in ("auto", "sep", "field"):
        np.testing.assert_allclose(run(backend), [0.4, 0.2], atol=0.02)


def test_torch_backend_frames_on_the_cpu_by_default():
    """Backend "torch" with numpy input and no device equals the explicit
    device="cpu" run of "auto"."""
    und, dfm, batch = _one_subset_problem()
    stack = np.stack([und, dfm, dfm])
    kw = dict(model=FittingModel.UV, pyramid=PyramidConfig(0, 1, 0))
    plain = engine.correlate_frames(SolverConfig(backend="torch", **kw),
                                    stack, batch, np.zeros((1, 2)))
    auto = engine.correlate_frames(SolverConfig(**kw), stack, batch,
                                   np.zeros((1, 2)), device="cpu")
    assert plain["params"].device.type == "cpu"
    for key in ("params", "iterations", "error"):
        assert torch.equal(plain[key], auto[key])
