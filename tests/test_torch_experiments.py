"""The experiment kernels' plain versions (K2: the per-column row gather;
K3: the fused assembly's stages) against the JAX package's Pallas bodies.

The JAX experiment scripts run as they are, with pallas_call patched to
interpret mode (as test_torch_engine.py does) and, for
exp_matmul_overhead, with G = 2 steps instead of 256 and its timer
replaced by one that keeps each kernel's inputs and output.  The port's
plain versions get those same inputs.  The gather moves bits and must be
exact; the stages sum in another order, and agree within 1e-5 of the sum
of the absolute values of each output's terms.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from correlation_tpu_torch.experiments import exp_gather as eg
from correlation_tpu_torch.experiments import exp_matmul_overhead as em

torch.set_num_threads(2)

EXPERIMENTS = Path(__file__).resolve().parent.parent / "experiments"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", EXPERIMENTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpret(monkeypatch, mod, calls=None):
    orig = mod.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        fn = orig(*args, **kwargs)
        if calls is None:
            return fn

        def call(*ins):
            out = fn(*ins)
            calls.append(([np.array(x) for x in ins], np.array(out)))
            return out

        return call

    monkeypatch.setattr(mod.pl, "pallas_call", patched)


@pytest.fixture(scope="module")
def stage_runs():
    """{variant: (inputs as float32 numpy, JAX output)} at G = 2."""
    mod = _load("exp_matmul_overhead")
    runs, current = {}, {}
    orig_run = mod.run

    def run(name, *args, **kwargs):
        current["name"] = name
        return orig_run(name, *args, **kwargs)

    def timeit(fn, *args, reps=20):
        runs[current["name"]] = (
            [np.array(x.astype(jnp.float32)) for x in args],
            np.array(fn(*args)),
        )
        return 1.0

    with pytest.MonkeyPatch.context() as mp:
        _interpret(mp, mod)
        mp.setattr(mod, "G", 2)
        mp.setattr(mod, "run", run)
        mp.setattr(mod, "timeit", timeit)
        mp.setattr("sys.argv", ["exp_matmul_overhead"])
        mod.main()
    return runs


def test_gather_matches_pallas_body(monkeypatch):
    mod = _load("exp_gather")
    calls = []
    _interpret(monkeypatch, mod, calls)
    mod.main()
    ((src, idx), out), = calls
    got_src, got_idx = eg.make_inputs("cpu")
    np.testing.assert_array_equal(got_src.numpy(), src)
    np.testing.assert_array_equal(got_idx.numpy(), idx)
    got = eg.gather_rows(got_src, got_idx)
    np.testing.assert_array_equal(got.numpy(), out)
    assert eg.LAUNCHES == 0  # CPU tensors never reach the kernel


def test_gather_rejects_out_of_range_index():
    src, idx = eg.make_inputs("cpu")
    bad = idx.clone()
    bad[3, 7] = eg.TH
    with pytest.raises(IndexError):
        eg.gather_rows(src, bad)
    bad[3, 7] = -1
    with pytest.raises(IndexError):
        eg.gather_rows(src, bad)


@pytest.mark.parametrize("name", em.NAMES)
def test_stage_matches_pallas_body(stage_runs, name):
    ins, out = stage_runs[name]
    _, dtype = em.input_shapes(name)
    inputs = [torch.from_numpy(x).to(dtype) for x in ins]
    got = em.KERNELS[name](*inputs)
    assert got.shape == out.shape and got.dtype == torch.float32
    ok, err = em.agreement(got, torch.from_numpy(out),
                           em.terms_scale(name, inputs))
    assert ok, f"{name}: max |port - JAX| {err}"
    # The port draws the script's inputs: float32 ones bit for bit; the
    # bfloat16 cast goes through float32 and may round a rare value
    # differently from a direct float64 -> bfloat16 cast.
    mine = [x.float().numpy() for x in em.make_inputs(name, "cpu", g=2)]
    for a, b in zip(mine, ins):
        if dtype == torch.float32:
            np.testing.assert_array_equal(a, b)
        else:
            assert np.mean(a != b) < 1e-4


def test_gram_variants_agree(stage_runs):
    (g,), _ = stage_runs["gram_loop"]
    g = torch.from_numpy(g)
    assert torch.equal(em.stage_gram_loop(g), em.stage_gram_big(g))
    with pytest.raises(ValueError):
        em.stage_gram_loop(g[:, :, :7].contiguous())
    with pytest.raises(TypeError):
        em.stage_loop(g, g)


def test_product_rejects_shapes_the_kernel_does_not_take():
    """The product kernel stages a subset's a [K, M] whole in shared memory,
    so K and M are at most 128 (P is free).  The wrappers raise for larger
    ones on any device, so that a caller finds out before the card."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16)

    assert em.stage_batched(zeros(1, 1, 128, 128),
                            zeros(1, 1, 128, 700)).shape == (1, 1, 128, 700)
    for k, m in ((em.MAX_K + 1, 8), (8, em.MAX_M + 1)):
        for fn in (em.stage_loop, em.stage_batched):
            with pytest.raises(ValueError, match="at most|<="):
                fn(zeros(1, 1, k, m), zeros(1, 1, k, 16))
