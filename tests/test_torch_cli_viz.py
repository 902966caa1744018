"""The port's user surface against the JAX package's: the command line
(correlation_tpu_torch.cli with --cpu against correlation_tpu.cli.main on
the same PNG frames), the overlays and outlines (viz), the rotation helpers
(models.warp) and the tracing hooks (utils.profiling).

CSV reports are compared column by column: names and counts equal,
parameters, guesses, centers and angles within 5e-4, chi within 1e-3
relative (JAX's CPU "auto" is its separable tiles, the port's the plain
fused assembly: the same interpolation, summed in other orders),
iterations and error columns identical.
"""

import csv
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from correlation_tpu import viz as jviz
from correlation_tpu.cli import main as jax_main
from correlation_tpu.config import FittingModel as JModel
from correlation_tpu.models import warp as jwarp
from correlation_tpu_torch import cli, viz
from correlation_tpu_torch.config import (
    DeformationDescription,
    FittingModel,
    PyramidConfig,
    ReferenceImage,
    SolverConfig,
)
from correlation_tpu_torch.models import warp
from correlation_tpu_torch.sequence import SequenceConfig, run_sequence
from correlation_tpu_torch.utils import profiling
from synthetic import Speckle

torch.set_num_threads(2)

RECT = ["--domain", "rect", "--rect", "30", "30", "62", "62",
        "--subdivisions", "2", "2", "--model", "uv", "--pyramid", "0", "1",
        "1"]
DOT = np.array([64, 128, 255])


def _write_frames(tmp_path, n, du, dv, hw=96, seed=7, shift=None):
    spk = Speckle(hw, hw, seed=seed)
    paths = []
    for t in range(n):
        if shift is not None and t:
            img = spk.warped_image(u=shift[0], v=shift[1], quantize=True)
        else:
            img = spk.warped_image(u=du * t, v=dv * t, quantize=True)
        p = str(tmp_path / f"f{t}.png")
        Image.fromarray(img.astype(np.uint8)).save(p)
        paths.append(p)
    return paths


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _assert_reports_match(got_path, ref_path):
    got, ref = _rows(got_path), _rows(ref_path)
    assert len(got) == len(ref) > 0
    assert list(got[0]) == list(ref[0])
    for g, r in zip(got, ref):
        for col in r:
            if col in ("Frame#", "und_file_string", "def_file_string",
                       "number_of_points", "iterations", "error_status",
                       "error_code"):
                assert g[col] == r[col], col
            elif col == "chi":
                np.testing.assert_allclose(float(g[col]), float(r[col]),
                                           rtol=1e-3, atol=1e-6)
            else:
                np.testing.assert_allclose(float(g[col]), float(r[col]),
                                           atol=5e-4, err_msg=col)


@pytest.mark.parametrize("mode", ["rect", "auto-guess", "sep"])
def test_cli_report_matches_jax(tmp_path, mode):
    """The 4-frame rectangle run (under "auto", and under one JAX command
    line, --backend xla_sep --compact-stages 0, given to both CLIs) and a
    seeded pair."""
    if mode in ("rect", "sep"):
        paths = _write_frames(tmp_path, 4, 0.6, -0.4)
        extra = []
        if mode == "sep":
            extra = ["--backend", "xla_sep", "--compact-stages", "0"]
    else:
        # The second frame is 11 px away: beyond the 2-level pyramid's
        # reach from a zero guess, seeded per sector.
        paths = _write_frames(tmp_path, 2, 0.0, 0.0, hw=128,
                              shift=(11.0, -6.0))
        extra = ["--rect", "40", "40", "88", "88", "--auto-guess",
                 "--auto-guess-win", "64"]
    ref, got = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    assert jax_main(paths + RECT + extra + ["--report", ref]) == 0
    assert cli.main(paths + RECT + extra + ["--cpu", "--report", got]) == 0
    _assert_reports_match(got, ref)
    if mode == "auto-guess":
        for row in _rows(got):
            np.testing.assert_allclose(
                [float(row["parameter_0"]), float(row["parameter_1"])],
                [11.0, -6.0], atol=0.05)
            assert row["error_code"] == "0"


@pytest.mark.parametrize(
    "args,message",
    [(["--domain", "rect"], "--rect required for rectangular domains"),
     (["--domain", "annular"], "--annulus required"),
     (["--domain", "blob"], "--blob required"),
     (RECT + ["--guess", "1.0"], "--guess needs 2 values for uv"),
     (RECT + ["--guess", "1", "2", "--auto-guess"],
      "--auto-guess cannot be combined with --guess (pick one "
      "initial-guess source)")],
    ids=["rect", "annulus", "blob", "guess-length", "two-guesses"])
def test_argument_errors_exit_2_with_jax_messages(tmp_path, capsys, args,
                                                  message):
    paths = _write_frames(tmp_path, 2, 0.0, 0.0)
    assert jax_main(paths + args) == 2
    ref = capsys.readouterr().err
    assert cli.main(paths + args + ["--cpu"]) == 2
    got = capsys.readouterr().err
    assert got == ref == message + "\n"
    assert cli.main(paths[:1] + RECT + ["--auto-guess", "--cpu"]) == 2
    assert capsys.readouterr().err == "--auto-guess needs at least two images\n"


def test_without_a_card_the_cli_exits_nonzero(tmp_path, capsys, monkeypatch):
    paths = _write_frames(tmp_path, 2, 0.0, 0.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    report = str(tmp_path / "out.csv")
    assert cli.main(paths + RECT + ["--report", report]) == 1
    assert "CUDA device" in capsys.readouterr().err
    assert not os.path.exists(report)
    # A JAX backend name solves on the card too, as the default does.
    assert cli.main(paths + RECT + ["--backend", "xla", "--report",
                                    report]) == 1
    assert "CUDA device" in capsys.readouterr().err
    assert not os.path.exists(report)


def test_jax_backend_names_give_the_port_names_reports(tmp_path):
    """On the port, each JAX backend name (with --compact-stages, which
    nothing reads) writes the report of the port's name byte for byte."""
    from correlation_tpu_torch.config import JAX_BACKENDS

    paths = _write_frames(tmp_path, 4, 0.6, -0.4)

    def report(*extra):
        out = tmp_path / f"{'_'.join(extra)}.csv"
        assert cli.main(paths + RECT + ["--cpu", "--report", str(out),
                                        *extra]) == 0
        return out.read_bytes()

    ports = {name: report("--backend", name)
             for name in set(JAX_BACKENDS.values())}
    for jax_name, port_name in JAX_BACKENDS.items():
        assert report("--backend", jax_name, "--compact-stages",
                      "0") == ports[port_name], jax_name


def test_backend_device_mismatch_exits_2_before_decoding(tmp_path, capsys,
                                                         monkeypatch):
    """--cpu --backend cuda is an argument error: one line on stderr and
    exit 2, before any image is decoded."""
    from correlation_tpu_torch import io as tio

    def no_decode(*args, **kwargs):
        raise AssertionError("an image was decoded")

    paths = _write_frames(tmp_path, 2, 0.0, 0.0)
    monkeypatch.setattr(tio, "load_image", no_decode)
    report = str(tmp_path / "out.csv")
    for extra in ([], ["--auto-guess"]):
        assert cli.main(paths + RECT + extra + [
            "--cpu", "--backend", "cuda", "--report", report]) == 2
        err = capsys.readouterr().err
        assert err == ("backend 'cuda' solves on a cuda device, not on cpu; "
                       "backends 'auto', 'sep' and 'field' solve on "
                       "either\n")
    assert not os.path.exists(report)


def test_plot_dir_writes_jax_file_names(tmp_path):
    paths = _write_frames(tmp_path, 3, 0.6, -0.4)
    names = {}
    for name, run in (("jax", jax_main), ("port", cli.main)):
        out = tmp_path / f"plots_{name}"
        extra = ["--cpu"] if name == "port" else []
        assert run(paths + RECT + extra + [
            "--plot-dir", str(out), "--plot-points",
            "--report", str(tmp_path / f"{name}.csv")]) == 0
        names[name] = sorted(os.listdir(out))
    assert names["port"] == names["jax"] == [
        "overlay_00001.png", "overlay_00002.png", "overlay_und.png"]
    img = np.asarray(Image.open(tmp_path / "plots_port" / "overlay_00001.png"))
    assert (img == DOT).all(axis=-1).sum() > 200


def test_outlines_preview_and_rotation_equal_jax():
    np.testing.assert_array_equal(viz.rect_outline(10, 20, 50, 60, 8),
                                  jviz.rect_outline(10, 20, 50, 60, 8))
    for a, b in zip(viz.annulus_outlines(64, 64, 10, 30, 2, 4),
                    jviz.annulus_outlines(64, 64, 10, 30, 2, 4)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        viz.annular_sector_outline(5, 6, 3, 9, 0.1, 1.2),
        jviz.annular_sector_outline(5, 6, 3, 9, 0.1, 1.2))
    outline = viz.rect_outline(10, 20, 50, 60)
    center = np.array([30.0, 40.0], np.float32)
    rng = np.random.default_rng(3)
    for model in FittingModel:
        n = SolverConfig(model=model).num_params
        params = rng.normal(0, 0.1, n).astype(np.float32)
        np.testing.assert_allclose(
            viz.preview_warp(model, params, outline, center),
            jviz.preview_warp(JModel(int(model)), params, outline, center),
            rtol=0, atol=1e-5)
        batch = rng.normal(0, 0.2, (7, n)).astype(np.float32)
        np.testing.assert_allclose(
            warp.rotation_angle(model, torch.from_numpy(batch)).numpy(),
            np.asarray(jwarp.rotation_angle(JModel(int(model)),
                                            jnp.asarray(batch))),
            rtol=1e-6, atol=1e-7)
    affine = rng.normal(0, 0.2, (9, 6)).astype(np.float32)
    np.testing.assert_allclose(
        warp.best_rotation_affine(torch.from_numpy(affine)).numpy(),
        np.asarray(jwarp.best_rotation_affine(jnp.asarray(affine))),
        rtol=1e-6, atol=1e-7)


def test_trace_region_and_trace_file(tmp_path):
    logdir = str(tmp_path / "trace")
    profiling.start_trace(logdir)
    with pytest.raises(RuntimeError):
        profiling.start_trace(logdir)
    with profiling.trace_region("field-assembly"):
        torch.arange(10.0).sum()
    path = profiling.stop_trace()
    assert os.path.dirname(path) == logdir
    with open(path) as f:
        assert "field-assembly" in f.read()
    with pytest.raises(RuntimeError):
        profiling.stop_trace()
    with profiling.trace_region("outside a trace"):
        pass


def _drifting(n, du, dv):
    spk = Speckle(96, 96, seed=7)
    return [spk.warped_image(u=du * t, v=dv * t, quantize=True)[..., None]
            for t in range(n)]


def _solver():
    return SolverConfig(model=FittingModel.UV, pyramid=PyramidConfig(0, 1, 1))


def _pts():
    gx, gy = np.meshgrid(np.arange(34, 63), np.arange(34, 63), indexing="ij")
    return [np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)]


def _dots(image):
    return int((np.asarray(image) == DOT).all(axis=-1).sum())


def test_und_overlay_dots_are_gated_like_the_pair_overlays(tmp_path):
    """Records that carry their own point lists (record_points) but no
    request for points (no model): no overlay draws dots, frame 0's
    included."""
    frames = _drifting(3, 1.3, -0.8)
    cfg = SequenceConfig(solver=_solver(),
                         deformation=DeformationDescription.LAGRANGIAN,
                         reference=ReferenceImage.PREVIOUS,
                         record_points=True)
    recs = run_sequence(frames, _pts(), cfg, device="cpu")
    assert recs[0].und_points is not None
    paths = viz.save_sequence_overlays(frames, recs, str(tmp_path / "a"),
                                       eulerian=False)
    assert [_dots(Image.open(p)) for p in paths] == [0, 0, 0]
    paths = viz.save_sequence_overlays(frames, recs, str(tmp_path / "b"),
                                       point_lists=_pts(),
                                       model=FittingModel.UV, eulerian=False)
    assert all(_dots(Image.open(p)) > 200 for p in paths)


def test_moving_domain_without_point_lists_draws_no_stale_dots(tmp_path,
                                                                 capsys):
    """A Lagrangian run whose records carry no point lists (run without
    record_points, or restored from such a checkpoint): the pair overlays
    get no dots, and stderr says so, where warping the frame-0 lists would
    draw the wrong pixels.  Frame 0's overlay still shows its own points."""
    frames = _drifting(3, 1.3, -0.8)
    cfg = SequenceConfig(solver=_solver(),
                         deformation=DeformationDescription.LAGRANGIAN,
                         reference=ReferenceImage.PREVIOUS)
    recs = run_sequence(frames, _pts(), cfg, device="cpu")
    assert recs[0].und_points is None
    capsys.readouterr()
    paths = viz.save_sequence_overlays(frames, recs, str(tmp_path / "ov"),
                                       point_lists=_pts(),
                                       model=FittingModel.UV, eulerian=False)
    assert [os.path.basename(p) for p in paths] == [
        "overlay_und.png", "overlay_00001.png", "overlay_00002.png"]
    assert _dots(Image.open(paths[0])) > 200
    assert [_dots(Image.open(p)) for p in paths[1:]] == [0, 0]
    err = capsys.readouterr().err
    assert "warning: 2 overlay(s) drawn without subset points" in err
    # An Eulerian run's points stay put: the frame-0 lists apply.
    paths = viz.save_sequence_overlays(frames, recs, str(tmp_path / "eu"),
                                       point_lists=_pts(),
                                       model=FittingModel.UV)
    assert all(_dots(Image.open(p)) > 200 for p in paths)
    assert capsys.readouterr().err == ""


def test_render_overlay_draws_lines_crosses_and_dots():
    frame = np.full((40, 50, 1), 100.0, np.float32)
    img = np.asarray(viz.render_overlay(
        frame, [viz.rect_outline(5, 5, 30, 30)], np.array([[20.0, 20.0]]),
        dots=np.array([[40.0, 10.0], [-3.0, 5.0]])))
    ref = np.asarray(jviz.render_overlay(
        frame, [jviz.rect_outline(5, 5, 30, 30)], np.array([[20.0, 20.0]]),
        dots=np.array([[40.0, 10.0], [-3.0, 5.0]])))
    np.testing.assert_array_equal(img, ref)
    assert img.shape == (40, 50, 3)
    assert (img[10, 40] == DOT).all()
    assert (img[5, 10] == [0, 255, 0]).all()


def test_report_to_stdout(tmp_path, capsys):
    paths = _write_frames(tmp_path, 2, 0.6, -0.4)
    assert cli.main(paths + RECT + ["--cpu"]) == 0
    rows = list(csv.DictReader(io.StringIO(capsys.readouterr().out)))
    assert len(rows) == 4
    assert {r["error_code"] for r in rows} == {"0"}
