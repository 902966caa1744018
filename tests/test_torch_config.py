"""The port's configuration and interop layer against the JAX package, and
the rule that importing the port never imports JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import correlation_tpu.config as jcfg
from correlation_tpu.domains import make_batch as jax_make_batch
from correlation_tpu_torch import config as tcfg
from correlation_tpu_torch.interop import (
    JAX_ONLY_FIELDS,
    chain_seed_from_numpy,
    solver_config_from_dict,
    subset_batch_from_numpy,
)

ENUMS = ["FittingModel", "Interpolation", "DeformationDescription",
         "ErrorMode", "ReferenceImage", "DomainType", "ErrorCode"]


@pytest.mark.parametrize("name", ENUMS)
def test_enums_equal(name):
    ref = getattr(jcfg, name)
    got = getattr(tcfg, name)
    assert {m.name: int(m) for m in got} == {m.name: int(m) for m in ref}


def test_config_defaults_equal():
    ref = dataclasses.asdict(jcfg.SolverConfig())
    got = dataclasses.asdict(tcfg.SolverConfig())
    # The port keeps every field but the JAX loop's compaction schedule.
    assert set(ref) - set(got) == set(JAX_ONLY_FIELDS)
    assert got == {k: v for k, v in ref.items() if k not in JAX_ONLY_FIELDS}
    assert {int(k): v for k, v in tcfg.NUM_PARAMS.items()} == \
        {int(k): v for k, v in jcfg.NUM_PARAMS.items()}
    for p in ((0, 1, 2), (0, 2, 4), (1, 1, 3)):
        assert tcfg.PyramidConfig(*p).levels_coarse_to_fine() == \
            jcfg.PyramidConfig(*p).levels_coarse_to_fine()
    with pytest.raises(ValueError):
        tcfg.PyramidConfig(2, 1, 0)


def test_solver_config_from_jax_dict():
    ref = jcfg.SolverConfig(
        model=jcfg.FittingModel.UVQ, interpolation=jcfg.Interpolation.BILINEAR,
        pyramid=jcfg.PyramidConfig(0, 1, 3), max_iterations=17,
        precision=1e-5, lambda_up=7.0, tile_margin=6, backend="pallas",
        compact_stages=3,
    )
    d = dataclasses.asdict(ref)
    d["model"], d["interpolation"] = int(d["model"]), int(d["interpolation"])
    got = solver_config_from_dict(d)
    assert got.backend == "auto"
    want = {k: v for k, v in dataclasses.asdict(ref).items()
            if k not in JAX_ONLY_FIELDS}
    want["backend"] = "auto"
    assert dataclasses.asdict(got) == want
    assert got.num_params == ref.num_params == 3
    with pytest.raises(ValueError):
        solver_config_from_dict({"backend": "tpu"})


def test_subset_batch_from_jax_arrays():
    rng = np.random.default_rng(0)
    pts = [rng.integers(10, 60, (30, 2)).astype(np.float32) for _ in range(5)]
    ref = jax_make_batch(pts, None, 2).to_device()  # jax arrays
    got = subset_batch_from_numpy(
        [np.asarray(a) for a in ref.xy], [np.asarray(a) for a in ref.mask],
        np.asarray(ref.center0), ref.extents,
    )
    for a, b in zip(got.xy + got.mask, ref.xy + ref.mask):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got.extents == ref.extents
    recomputed = subset_batch_from_numpy(got.xy, got.mask, got.center0)
    assert recomputed.extents == ref.extents
    with pytest.raises(ValueError):
        subset_batch_from_numpy(got.xy, got.mask[:1] + got.mask[:2],
                                got.center0)


def test_chain_seed_from_numpy():
    p = np.arange(12, dtype=np.float32).reshape(2, 6)
    seed = chain_seed_from_numpy((p, p - 1, np.ones(2), np.array([3, 4])))
    assert [t.dtype for t in seed] == [torch.float32] * 3 + [torch.int32]
    np.testing.assert_array_equal(seed[1].numpy(), p - 1)
    assert seed[3].tolist() == [3, 4]
    lagr = chain_seed_from_numpy((p, p, np.ones(2), np.ones(2),
                                  np.ones((2, 2)), np.zeros((2, 2))))
    assert len(lagr) == 6 and lagr[4].dtype == torch.float32
    with pytest.raises(ValueError):
        chain_seed_from_numpy((p, p, np.ones(2)))
    with pytest.raises(ValueError):
        chain_seed_from_numpy((p, p[:1], np.ones(2), np.ones(2)))
    with pytest.raises(ValueError):
        chain_seed_from_numpy((p, p, np.ones(2), np.ones(2), np.ones((2, 3)),
                               np.ones((2, 2))))


def test_sequence_config_from_jax_dict():
    from correlation_tpu.sequence import SequenceConfig as JSequence
    from correlation_tpu_torch.interop import sequence_config_from_dict
    from correlation_tpu_torch.sequence import SequenceConfig

    ref = JSequence(
        solver=jcfg.SolverConfig(model=jcfg.FittingModel.UV,
                                 pyramid=jcfg.PyramidConfig(0, 1, 1)),
        deformation=jcfg.DeformationDescription.LAGRANGIAN,
        reference=jcfg.ReferenceImage.PREVIOUS,
        error_mode=jcfg.ErrorMode.STOP_FRAME, frame_chunk=7,
        record_points=True,
    )
    d = dataclasses.asdict(ref)
    got = sequence_config_from_dict(d)
    assert isinstance(got, SequenceConfig)
    assert got.deformation == tcfg.DeformationDescription.LAGRANGIAN
    assert got.reference == tcfg.ReferenceImage.PREVIOUS
    assert got.error_mode == tcfg.ErrorMode.STOP_FRAME
    assert (got.frame_chunk, got.record_points) == (7, True)
    assert got.solver.model == tcfg.FittingModel.UV
    assert got.solver.pyramid == tcfg.PyramidConfig(0, 1, 1)
    assert {f.name for f in dataclasses.fields(got)} == set(d)


def test_import_leaves_jax_out():
    code = (
        "import sys, correlation_tpu_torch, correlation_tpu_torch.interop, "
        "correlation_tpu_torch.problems, correlation_tpu_torch.ops._build, "
        "correlation_tpu_torch.sequence, correlation_tpu_torch.io, "
        "correlation_tpu_torch.report, correlation_tpu_torch.utils.checkpoint, "
        "correlation_tpu_torch.utils.profiling, "
        "correlation_tpu_torch.experiments.exp_gather, "
        "correlation_tpu_torch.experiments.exp_matmul_overhead, "
        "correlation_tpu_torch.cli, correlation_tpu_torch.viz, "
        "correlation_tpu_torch.ops.seed, correlation_tpu_torch.ops.assemble, "
        "correlation_tpu_torch.parallel, correlation_tpu_torch.parallel.mesh, "
        "correlation_tpu_torch.parallel.collectives; "
        "bad = [m for m in sys.modules if m == 'PIL' or m.startswith('PIL.')]; "
        "print(bad); assert not bad; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('correlation_tpu.') or m == 'correlation_tpu']; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
