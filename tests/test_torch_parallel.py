"""The port's subset-sharded solves and pixel-sharded assembly
(correlation_tpu_torch.parallel) on two gloo ranks on the CPU.

One module-scoped fixture starts two worker processes of this file (run
as a script, under a timeout, so a hang fails instead of stalling the
suite), which join a gloo group, solve every case sharded over the two
ranks and, on rank 0, unsharded, and save their results; the tests read
them.  The workers import no JAX (this file imports JAX only inside its
tests).

Tolerances: a shard keeps the whole batch's padded point counts, extents
and tiles and the LM step is row-wise, so sharded equals unsharded bit
for bit (torch.equal) in every solve.  Against JAX: the tiled path within
test_torch_engine.py's PARAM_ATOL / CHI_RTOL of JAX's Pallas solve, the
field path within test_torch_field.py's tolerances of JAX's "xla" solve on
its 8-device mesh, and the pixel-sharded assembly within JAX's own test's
rtol (1e-5 on A and b, 1e-6 on chi) of the unsharded assembly and of
JAX's, but b against JAX within test_torch_field.py's tolerance, err equal.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for _path in (REPO, HERE):
    if _path not in sys.path:
        sys.path.insert(0, _path)

from correlation_tpu_torch import engine  # noqa: E402
from correlation_tpu_torch.config import (  # noqa: E402
    DeformationDescription,
    ErrorCode,
    FittingModel,
    Interpolation,
    PyramidConfig,
    ReferenceImage,
    SolverConfig,
)
from correlation_tpu_torch.domains import make_batch  # noqa: E402
from correlation_tpu_torch.ops.pyramid import build_pyramid  # noqa: E402
from correlation_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from correlation_tpu_torch.sequence import (  # noqa: E402
    SequenceConfig,
    run_sequence,
)

WORKER_TIMEOUT_S = 120
GROUP_TIMEOUT_S = 60
PARAM_ATOL, CHI_RTOL = 5e-5, 5e-5  # test_torch_engine.py's
FIELD_PARAM_ATOL, FIELD_CHI_RTOL = 5e-4, 1e-3  # test_torch_field.py's


# ---- the problems: tests/test_parallel.py's ---------------------------------

def _grid(x0, y0, x1, y1):
    gx, gy = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1),
                         indexing="ij")
    return np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)


def _speckle(h, w, seed):
    from synthetic import Speckle

    return Speckle(h, w, seed=seed)


def _solver(backend="auto", **kw):
    return SolverConfig(model=FittingModel.UV,
                        interpolation=Interpolation.BICUBIC,
                        pyramid=PyramidConfig(0, 1, 1), precision=1e-5,
                        backend=backend, **kw)


def correlate_problem():
    """Five subsets (not divisible by the mesh) on an 80x80 pair."""
    spk = _speckle(80, 80, 13)
    und = spk.image(quantize=True)[..., None]
    dfm = spk.warped_image(u=0.7, v=0.3, quantize=True)[..., None]
    pts = [_grid(14 + 7 * i, 14 + 5 * (i % 3), 14 + 7 * i + 12,
                 14 + 5 * (i % 3) + 12) for i in range(5)]
    return und, dfm, pts


def euler_sequence_problem():
    spk = _speckle(80, 80, 5)
    frames = [spk.warped_image(u=0.5 * t, v=-0.3 * t, quantize=True)[..., None]
              for t in range(3)]
    return frames, [_grid(20, 20, 44, 44), _grid(40, 40, 64, 64)]


def lagrangian_sequence_problem():
    spk = _speckle(112, 112, 6)
    frames = [spk.warped_image(u=1.2 * t, v=-0.9 * t, quantize=True)[..., None]
              for t in range(5)]
    return frames, [_grid(28, 28, 52, 52), _grid(56, 56, 84, 84)]


def frames_problem():
    """The Lagrangian problem's frames under five subsets."""
    frames, _ = lagrangian_sequence_problem()
    pts = [_grid(24 + 12 * i, 24 + 9 * (i % 3), 24 + 12 * i + 14,
                 24 + 9 * (i % 3) + 14) for i in range(5)]
    return np.stack(frames), pts


def pixel_problem(side=40):
    """tests/test_parallel.py's pixel-sharded case: one AFFINE subset of
    side x side pixels (1600 by default, divisible by 2 and 8)."""
    spk = _speckle(64, 64, 42)
    und = spk.image(quantize=True)[..., None]
    dfm = spk.warped_image(u=0.5, v=0.25, quantize=True)[..., None]
    pts = _grid(12, 12, 11 + side, 11 + side)
    params = np.array([[0.5, 0.25, 0.001, 0, 0, -0.001]], np.float32)
    return und, dfm, pts, params


def _pixel_inputs(und, dfm, pts, params):
    from correlation_tpu_torch.ops.interp import (
        precompute_field,
        sample_integer,
    )

    xy = torch.from_numpy(pts[None])
    field = precompute_field(torch.from_numpy(dfm), Interpolation.BICUBIC)
    und_w = sample_integer(torch.from_numpy(und), xy)
    return (field, und_w, xy, torch.ones(xy.shape[:2], dtype=torch.bool),
            xy.mean(dim=1), torch.from_numpy(params))


def _pyramids(und, dfm, stop=1):
    pair = torch.from_numpy(np.stack([und, dfm]))
    pyr = build_pyramid(pair, stop)
    return [a[0] for a in pyr], [a[1] for a in pyr]


_RECORD_ARRAYS = ("params", "initial_guess", "chi", "iterations", "error",
                  "n_points", "und_center", "def_center", "und_angle",
                  "def_angle", "und_global_center", "def_global_center")


def _records(recs):
    """The numbers of a run's FrameRecords, stacked per field."""
    out = {k: torch.from_numpy(np.stack([getattr(r, k) for r in recs]))
           for k in _RECORD_ARRAYS}
    out["frame"] = torch.tensor([r.frame for r in recs])
    out["und_global_angle"] = torch.tensor(
        [r.und_global_angle for r in recs], dtype=torch.float64)
    out["def_global_angle"] = torch.tensor(
        [r.def_global_angle for r in recs], dtype=torch.float64)
    return out


def _frames_out(out):
    flat = {k: v for k, v in out.items() if k != "carry"}
    flat.update({f"carry{i}": t for i, t in enumerate(out["carry"])})
    return flat


def _sequence_cfgs():
    lagr = SequenceConfig(
        solver=_solver(), deformation=DeformationDescription.LAGRANGIAN,
        reference=ReferenceImage.PREVIOUS, frame_chunk=3)
    return {
        "seq_euler": (euler_sequence_problem, SequenceConfig(solver=_solver())),
        "seq_euler_field": (euler_sequence_problem,
                            SequenceConfig(solver=_solver("field"))),
        "seq_lagr": (lagrangian_sequence_problem, lagr),
        "seq_strict": (lagrangian_sequence_problem, dataclasses.replace(
            lagr, deformation=DeformationDescription.STRICT_LAGRANGIAN)),
    }


def _stop_at_second_poll(mesh):
    """A should_stop that ends the run at its second poll; off rank 0 it
    raises, since run_sequence must poll rank 0 alone."""
    polls = []

    def stop():
        if mesh is not None and mesh.rank != 0:
            raise AssertionError("should_stop polled off rank 0")
        polls.append(1)
        return len(polls) >= 2

    return stop


def solve_cases(mesh, workdir):
    """{case: {name: tensor}}: every case solved over `mesh` (None for
    the unsharded solve); the same calls on every rank.  Checkpoints go
    to workdir."""
    out = {}
    und, dfm, pts = correlate_problem()
    und_pyr, def_pyr = _pyramids(und, dfm)
    batch = make_batch(pts, None, 1)
    guess = np.zeros((5, 2), np.float32)
    for name, backend in (("correlate", "auto"), ("correlate_field", "field")):
        res = engine.correlate(_solver(backend), und_pyr, def_pyr, batch,
                               guess, device="cpu", mesh=mesh)
        out[name] = res._asdict()

    stack, fpts = frames_problem()
    fbatch = make_batch(fpts, None, 1)
    fguess = np.zeros((5, 2), np.float32)
    for name, kw in (("frames_euler", {}),
                     ("frames_lagr", dict(reference_first=False,
                                          lagrangian=True))):
        res = engine.correlate_frames(_solver(), stack, fbatch, fguess,
                                      device="cpu", mesh=mesh, **kw)
        out[name] = _frames_out(res)

    for name, (problem, cfg) in _sequence_cfgs().items():
        frames, spts = problem()
        out[name] = _records(run_sequence(frames, spts, cfg, device="cpu",
                                          mesh=mesh))

    # Stopped at the second poll, with a checkpoint every pair.
    frames, spts = lagrangian_sequence_problem()
    path = os.path.join(workdir, f"stop_{mesh is None}.npz")
    out["seq_lagr_stop"] = _records(run_sequence(
        frames, spts, dataclasses.replace(_sequence_cfgs()["seq_lagr"][1],
                                          frame_chunk=2),
        device="cpu", mesh=mesh, should_stop=_stop_at_second_poll(mesh),
        checkpoint_path=path))
    out["seq_lagr_stop"]["checkpoint_written"] = torch.tensor(
        os.path.exists(path))
    return out


def pixel_cases(mesh):
    """The pixel-sharded assembly over `mesh`, twice."""
    from correlation_tpu_torch.parallel.collectives import (
        assemble_pixel_sharded,
    )

    und, dfm, pts, params = pixel_problem()
    args = _pixel_inputs(und, dfm, pts, params)
    out = {}
    for call in ("first", "second"):
        a, b, chi, err = assemble_pixel_sharded(
            mesh, FittingModel.AFFINE, Interpolation.BICUBIC, *args)
        out[call] = {"a": a, "b": b, "chi": chi, "err": err}
    return out


def _raises(fn) -> str:
    try:
        fn()
    except ValueError as err:
        return f"ValueError: {err}"
    return "no error"


def worker(rank: int, size: int, port: int, outdir: str) -> None:
    """One rank: join the gloo group, solve every case sharded (and, on
    rank 0, unsharded), save the results to outdir/rank{rank}.pt."""
    torch.set_num_threads(2)
    from correlation_tpu_torch.parallel.collectives import (
        assemble_pixel_sharded,
    )

    joined = pmesh.init_distributed(
        coordinator_address=f"127.0.0.1:{port}", num_processes=size,
        process_id=rank, backend="gloo", timeout=GROUP_TIMEOUT_S)
    mesh = pmesh.make_mesh("cpu")
    result = {"joined": joined, "rank": mesh.rank, "size": mesh.size}

    # Both raise before any collective, alike on every rank: the run
    # goes on to the cases below instead of hanging.
    und, dfm, pts = correlate_problem()
    four = np.repeat(und, 4, axis=-1)
    result["four_channels"] = _raises(lambda: engine.correlate(
        _solver("cuda"), [four], [four], make_batch(pts, None, 0),
        np.zeros((5, 2), np.float32), device="cpu", mesh=mesh))
    und, dfm, odd, params = pixel_problem(side=39)  # 1521 px
    result["odd_pixels"] = _raises(lambda: assemble_pixel_sharded(
        mesh, FittingModel.AFFINE, Interpolation.BICUBIC,
        *_pixel_inputs(und, dfm, odd, params)))

    result["sharded"] = solve_cases(mesh, outdir)
    result["pixel"] = pixel_cases(mesh)
    torch.distributed.destroy_process_group()
    if rank == 0:
        result["unsharded"] = solve_cases(None, outdir)
    torch.save(result, os.path.join(outdir, f"rank{rank}.pt"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two workers' saved results, [rank 0's, rank 1's]."""
    outdir = str(tmp_path_factory.mktemp("ranks"))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), "2",
         str(port), outdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=REPO) for rank in range(2)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {rank} failed:\n{log}"
    return [torch.load(os.path.join(outdir, f"rank{r}.pt")) for r in range(2)]


def _assert_equal(got: dict, want: dict, what: str):
    assert got.keys() == want.keys(), what
    for key in want:
        assert torch.equal(got[key], want[key]), f"{what}: {key} differs"


# ---- sharded == unsharded, bit for bit -------------------------------------

SOLVE_CASES = ["correlate", "correlate_field", "frames_euler", "frames_lagr",
               "seq_euler", "seq_euler_field", "seq_lagr", "seq_strict",
               "seq_lagr_stop"]


@pytest.mark.parametrize("case", SOLVE_CASES)
def test_sharded_equals_unsharded(ranks, case):
    _assert_equal(ranks[0]["sharded"][case], ranks[0]["unsharded"][case],
                  case)


@pytest.mark.parametrize("case", SOLVE_CASES)
def test_both_ranks_hold_the_same_results(ranks, case):
    assert ranks[0]["joined"] and ranks[1]["joined"]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["size"] == 2 for r in ranks)
    _assert_equal(ranks[1]["sharded"][case], ranks[0]["sharded"][case], case)


def test_sharded_results_have_the_callers_subsets(ranks):
    got = ranks[0]["sharded"]
    assert got["correlate"]["params"].shape == (5, 2)
    assert got["frames_lagr"]["params"].shape == (4, 5, 2)
    assert all(t.shape[0] == 5 for k, t in got["frames_lagr"].items()
               if k.startswith("carry") or k in ("center0", "n_points0"))
    # five per-frame outputs, packed, center0, n_points0 and the six
    # tensors of the Lagrangian carry
    assert len(got["frames_lagr"]) == 8 + 6
    assert got["seq_lagr"]["params"].shape == (4, 2, 2)
    # Chunks of 2: the second poll, before the first chunk is emitted,
    # ends the run after that chunk, and the third, before its second
    # record, cuts the chunk to one record.
    assert got["seq_lagr_stop"]["params"].shape == (1, 2, 2)
    assert bool(got["seq_lagr_stop"]["checkpoint_written"])
    assert (got["correlate"]["error"] == int(ErrorCode.NONE)).all()


def test_rank_errors_raise_before_any_collective(ranks):
    for r in ranks:
        assert r["four_channels"].startswith("ValueError"), r["four_channels"]
        assert "4 channels" in r["four_channels"]
        assert r["odd_pixels"].startswith("ValueError"), r["odd_pixels"]


# ---- against JAX ------------------------------------------------------------

@pytest.fixture
def pallas_interpret(monkeypatch):
    from correlation_tpu.ops import assemble_v2 as jv2

    orig = jv2.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jv2.pl, "pallas_call", patched)
    jv2.fused_assemble.clear_cache()
    yield
    jv2.fused_assemble.clear_cache()


def _jax_solver(backend):
    from correlation_tpu.config import FittingModel as JModel
    from correlation_tpu.config import Interpolation as JInterp
    from correlation_tpu.config import PyramidConfig as JPyramid
    from correlation_tpu.config import SolverConfig as JSolver

    return JSolver(model=JModel.UV, interpolation=JInterp.BICUBIC,
                   pyramid=JPyramid(0, 1, 1), precision=1e-5,
                   backend=backend)


def _jax_correlate(backend, mesh):
    import jax.numpy as jnp

    from correlation_tpu.domains import make_batch as jax_make_batch
    from correlation_tpu.engine import correlate as jax_correlate
    from correlation_tpu.ops.pyramid import build_pyramid as jax_pyramid

    und, dfm, pts = correlate_problem()
    return jax_correlate(
        _jax_solver(backend), jax_pyramid(jnp.asarray(und), 1),
        jax_pyramid(jnp.asarray(dfm), 1), jax_make_batch(pts, None, 1),
        np.zeros((5, 2), np.float32), mesh=mesh)


def _assert_close_solve(got, ref, param_atol, chi_rtol):
    """Error codes equal, parameters and chi close.  Iteration counts are
    not compared: at these problems' precision of 1e-5 the delta-chi stop
    sits at the float32 noise of the chi sums, so the order of the sums
    moves a subset's last iteration either way (the unsharded port differs
    from JAX alike, since it equals the sharded one bit for bit)."""
    np.testing.assert_array_equal(got["error"].numpy(), np.asarray(ref.error))
    np.testing.assert_allclose(got["params"].numpy(), np.asarray(ref.params),
                               atol=param_atol)
    np.testing.assert_allclose(got["chi"].numpy(), np.asarray(ref.chi),
                               rtol=chi_rtol)


def test_sharded_tiled_solve_matches_jax_pallas(ranks, pallas_interpret):
    """JAX's unsharded Pallas solve (interpret mode) against the port's
    tiled plain path sharded over two ranks."""
    _assert_close_solve(ranks[0]["sharded"]["correlate"],
                        _jax_correlate("pallas", None), PARAM_ATOL, CHI_RTOL)


def test_sharded_field_solve_matches_jax_xla_on_its_mesh(ranks):
    """JAX "xla" sharded over its 8 virtual devices against the port's
    "field" over two ranks."""
    from correlation_tpu.parallel.mesh import make_mesh as jax_make_mesh

    ref = _jax_correlate("xla", jax_make_mesh())
    _assert_close_solve(ranks[0]["sharded"]["correlate_field"], ref,
                        FIELD_PARAM_ATOL, FIELD_CHI_RTOL)


def test_sharded_field_sequence_matches_jax_xla_on_its_mesh(ranks):
    from correlation_tpu.config import DeformationDescription as JDeform
    from correlation_tpu.config import ReferenceImage as JRef
    from correlation_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from correlation_tpu.sequence import SequenceConfig as JSeq
    from correlation_tpu.sequence import run_sequence as jax_run_sequence

    frames, pts = euler_sequence_problem()
    ref = jax_run_sequence(
        frames, pts, JSeq(solver=_jax_solver("xla"),
                          deformation=JDeform.EULERIAN,
                          reference=JRef.FIRST),
        mesh=jax_make_mesh())
    got = ranks[0]["sharded"]["seq_euler_field"]
    assert got["params"].shape[0] == len(ref)
    for t, rec in enumerate(ref):
        _assert_close_solve({k: v[t] for k, v in got.items()}, rec,
                            FIELD_PARAM_ATOL, FIELD_CHI_RTOL)


def test_pixel_sharded_assembly_matches_jax_and_unsharded(ranks):
    import jax.numpy as jnp

    from correlation_tpu.config import FittingModel as JModel
    from correlation_tpu.config import Interpolation as JInterp
    from correlation_tpu.ops.interp import precompute_field as jax_field
    from correlation_tpu.ops.interp import sample_integer as jax_sample
    from correlation_tpu.parallel.collectives import (
        assemble_pixel_sharded as jax_sharded,
    )
    from correlation_tpu.parallel.collectives import (
        make_pixel_mesh as jax_pixel_mesh,
    )
    from correlation_tpu_torch.ops.assemble import field_assemble
    from correlation_tpu_torch.ops import assemble_v2 as v2

    und, dfm, pts, params = pixel_problem()
    xy = jnp.asarray(pts[None])
    ja, jb, jchi, jerr = jax_sharded(
        jax_pixel_mesh(), JModel.AFFINE, JInterp.BICUBIC,
        jax_field(jnp.asarray(dfm), JInterp.BICUBIC),
        jax_sample(jnp.asarray(und), xy), xy,
        jnp.ones((1, len(pts)), bool), jnp.asarray(pts.mean(axis=0)[None]),
        jnp.asarray(params))
    field, und_w, txy, mask, center, tparams = _pixel_inputs(
        und, dfm, pts, params)
    whole = field_assemble(FittingModel.AFFINE, Interpolation.BICUBIC, field,
                           v2.pack_pixels(txy, mask, und_w, center), center,
                           tparams)
    for r in ranks:
        got = r["pixel"]["first"]
        _assert_equal(r["pixel"]["second"], got, "second call")
        _assert_equal(got, ranks[0]["pixel"]["first"], "rank 1 vs rank 0")
    got = {k: t.numpy() for k, t in ranks[0]["pixel"]["first"].items()}
    # Against the unsharded assembly: JAX's own test's tolerances (the
    # two differ in the order of the Gram sums alone).
    np.testing.assert_allclose(got["a"], whole[:, :6, :6], rtol=1e-5)
    np.testing.assert_allclose(got["b"], whole[:, :6, 6], rtol=1e-5)
    np.testing.assert_allclose(got["chi"], whole[:, 6, 6], rtol=1e-6)
    np.testing.assert_array_equal(got["err"], (whole[:, 7, 7] > 0).numpy())
    # Against JAX's: the same, but b within test_torch_field.py's assembly
    # tolerance: the port's bicubic polynomial rounds apart from JAX's
    # einsum, which moves one b entry (a sum with cancellation) by ~7e-5
    # relative in the unsharded assemblies too.
    np.testing.assert_allclose(got["a"], np.asarray(ja), rtol=1e-5)
    jb = np.asarray(jb)
    np.testing.assert_allclose(got["b"], jb, rtol=2e-4,
                               atol=np.abs(jb).max() * 2e-5)
    np.testing.assert_allclose(got["chi"], np.asarray(jchi), rtol=1e-6)
    np.testing.assert_array_equal(got["err"], np.asarray(jerr))


# ---- the command line -------------------------------------------------------

def test_cli_shard_writes_the_unsharded_report(tmp_path):
    """`torchrun --nproc_per_node=2 -m correlation_tpu_torch.cli ... --cpu
    --shard` (as python -m torch.distributed.run) writes the report of the
    unsharded --cpu run; rank 0 alone writes it and the checkpoint."""
    import csv

    from PIL import Image

    from correlation_tpu_torch import cli

    spk = _speckle(96, 96, 42)
    paths = []
    for t in range(4):
        path = str(tmp_path / f"frame_{t}.png")
        Image.fromarray(spk.warped_image(u=0.6 * t, v=-0.4 * t,
                                         quantize=True).astype(np.uint8)
                        ).save(path)
        paths.append(path)
    flags = ["--cpu", "--rect", "20", "20", "76", "76", "--subdivisions",
             "3", "3", "--model", "uv", "--pyramid", "0", "1", "1"]
    one, shard = str(tmp_path / "one.csv"), str(tmp_path / "shard.csv")
    assert cli.main(paths + flags + ["--report", one]) == 0
    ckpt = str(tmp_path / "run.npz")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "correlation_tpu_torch.cli", *paths,
         *flags, "--shard", "--report", shard, "--checkpoint", ckpt],
        capture_output=True, text=True, timeout=WORKER_TIMEOUT_S,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count(f"wrote {shard}") == 1, proc.stdout
    assert os.path.exists(ckpt)
    with open(one) as f:
        want = list(csv.DictReader(f))
    with open(shard) as f:
        got = list(csv.DictReader(f))
    assert len(got) == len(want) == 3 * 9
    for column in want[0]:
        assert [r[column] for r in got] == [r[column] for r in want], column


def test_cli_shard_without_a_card_or_cpu_exits_1(monkeypatch, capsys):
    from correlation_tpu_torch import cli

    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["a.png", "b.png", "--rect", "20", "20", "76", "76",
                     "--shard"]) == 1
    assert "pass device='cpu'" in capsys.readouterr().err


# ---- in one process ---------------------------------------------------------

def test_init_distributed_is_a_noop_without_a_launcher(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert pmesh.init_distributed() is False
    assert not torch.distributed.is_initialized()
    mesh = pmesh.make_mesh("cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)


def test_pad_and_shard_keep_point_counts_and_extents():
    _, _, pts = correlate_problem()
    batch = make_batch(pts, None, 1)
    for rank in range(2):
        mesh = pmesh.Mesh(None, rank, 2, torch.device("cpu"))
        padded = pmesh.pad_to_mesh(batch, mesh)
        assert padded.num_subsets == 6
        assert not np.asarray(padded.mask[0][5]).any()
        shard, guess = pmesh.shard_inputs(mesh, batch,
                                          np.ones((5, 2), np.float32))
        assert shard.num_subsets == 3 and guess.shape == (3, 2)
        assert shard.extents == batch.extents
        assert [a.shape[1] for a in shard.xy] == [a.shape[1]
                                                  for a in batch.xy]
        assert torch.equal(shard.xy[0],
                           torch.from_numpy(padded.xy[0][3 * rank:3 * rank + 3]))
        assert guess[:, 0].tolist() == ([1.0] * 3 if rank == 0
                                        else [1.0, 1.0, 0.0])


def test_padding_rows_resolve_to_bad_domain():
    """Rank 1's shard of the five subsets: two real, one padding row,
    which comes out BAD_DOMAIN before gather_rows strips it."""
    und, dfm, pts = correlate_problem()
    und_pyr, def_pyr = _pyramids(und, dfm)
    mesh = pmesh.Mesh(None, 1, 2, torch.device("cpu"))
    shard, guess = pmesh.shard_inputs(mesh, make_batch(pts, None, 1),
                                      np.zeros((5, 2), np.float32))
    res = engine.correlate(_solver(), und_pyr, def_pyr, shard, guess,
                           device="cpu")
    assert res.error.tolist()[:2] == [0, 0]
    assert res.error[2] == int(ErrorCode.BAD_DOMAIN)
    assert res.n_points[2] == 0


def test_mesh_of_one_equals_the_unsharded_solve():
    und, dfm, pts = correlate_problem()
    und_pyr, def_pyr = _pyramids(und, dfm)
    batch = make_batch(pts, None, 1)
    guess = np.zeros((5, 2), np.float32)
    mesh = pmesh.make_mesh("cpu")
    want = engine.correlate(_solver(), und_pyr, def_pyr, batch, guess,
                            device="cpu")._asdict()
    got = engine.correlate(_solver(), und_pyr, def_pyr, batch, guess,
                           mesh=mesh)._asdict()
    _assert_equal(got, want, "mesh of one")


def test_resolve_device_follows_the_mesh():
    cpu_mesh = pmesh.make_mesh("cpu")
    for backend in ("auto", "cuda", "field", "torch"):
        cfg = _solver(backend)
        assert engine.resolve_device(cfg, mesh=cpu_mesh) == torch.device("cpu")
        assert engine.resolve_device(cfg, "cpu", torch.zeros(1),
                                     cpu_mesh) == torch.device("cpu")
    with pytest.raises(ValueError, match="mesh's device"):
        engine.resolve_device(_solver(), "meta", mesh=cpu_mesh)
    und, dfm, pts = correlate_problem()
    und_pyr, def_pyr = _pyramids(und, dfm)
    batch = make_batch(pts, None, 1)
    guess = np.zeros((5, 2), np.float32)
    with pytest.raises(ValueError, match="mesh's device"):
        engine.correlate(_solver(), und_pyr, def_pyr, batch, guess,
                         device="meta", mesh=cpu_mesh)
    frames, spts = euler_sequence_problem()
    with pytest.raises(ValueError, match="mesh's device"):
        run_sequence(frames, spts, SequenceConfig(solver=_solver()),
                     device="meta", mesh=cpu_mesh)


def test_mesh_polls_and_checkpoints_alike_in_a_world_of_one(tmp_path):
    """With a mesh of one, should_stop and the checkpoint behave as
    without one."""
    frames, pts = lagrangian_sequence_problem()
    cfg = _sequence_cfgs()["seq_lagr"][1]
    calls = []

    def stop():
        calls.append(1)
        return len(calls) > 2

    runs = []
    for mesh in (None, pmesh.make_mesh("cpu")):
        calls.clear()
        path = str(tmp_path / f"{mesh is None}.npz")
        recs = run_sequence(frames, pts, cfg, device="cpu", mesh=mesh,
                            should_stop=stop, checkpoint_path=path)
        runs.append((_records(recs), len(calls), os.path.exists(path)))
    _assert_equal(runs[1][0], runs[0][0], "mesh of one")
    assert runs[0][1:] == runs[1][1:]
    assert runs[0][2]


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
