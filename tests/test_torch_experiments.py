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

from correlation_tpu_torch.experiments import design_sweep as ds
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


def test_gather_any_rows_on_the_cpu():
    """Any row count: more rows than the kernel stages in a block's shared
    memory (1816) gives take_along_axis's answer."""
    rng = np.random.default_rng(5)
    src = rng.standard_normal((2000, 40)).astype(np.float32)
    idx = rng.integers(0, 2000, (3, 40)).astype(np.int32)
    got = eg.gather_rows(torch.from_numpy(src), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(),
                                  np.take_along_axis(src, idx, axis=0))
    assert eg.LAUNCHES == 0


_I32 = {"dtype": torch.int32}


@pytest.mark.parametrize("src,idx,error", [
    (torch.zeros(4, 3, dtype=torch.float64), torch.zeros(2, 3, **_I32),
     TypeError),
    (torch.zeros(4, 3), torch.zeros(2, 3, dtype=torch.int64), TypeError),
    (torch.zeros(4, 3), torch.zeros(2, 5, **_I32), ValueError),
    (torch.zeros(4, 3), torch.zeros(3, **_I32), ValueError),
    (torch.zeros(3, 4).t(), torch.zeros(2, 3, **_I32), ValueError),
], ids=["float64-src", "int64-idx", "columns", "1d-idx", "strided-src"])
def test_gather_rejects_bad_inputs(src, idx, error):
    """The wrapper's checks, the same on every device."""
    with pytest.raises(error):
        eg.gather_rows(src, idx)


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


def _tf32(x: np.ndarray) -> np.ndarray:
    """float32 -> TF32 as cvt.rna.tf32.f32 rounds: to nearest, ties away
    from zero, keeping 10 mantissa bits (finite inputs)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _gram_tf32(x: np.ndarray, split: bool) -> np.ndarray:
    """[..., 8, P] -> [..., 8, 8] Grams from TF32 operands, each product
    exact and summed in float64: hi hi^T alone (plain TF32), or hi hi^T +
    (hi lo^T + lo hi^T) with lo = tf32(x - hi) (the 3xTF32 split of
    csrc/exp_stages.cu's gram_big)."""
    def gram(a, b):
        return np.einsum("...ip,...jp->...ij", a.astype(np.float64),
                         b.astype(np.float64))

    hi = _tf32(x)
    if not split:
        return gram(hi, hi)
    lo = _tf32(x - hi)
    return gram(hi, hi) + (gram(hi, lo) + gram(lo, hi))


def test_tf32_rounding():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's spacing at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - ulp / 8,
                  one + 3 * ulp / 4, 0.1], np.float32)
    got = _tf32(x)
    np.testing.assert_array_equal(got[:4], [one + ulp, -(one + ulp), one,
                                            one + ulp])
    assert abs(got[4] - 0.1) <= 0.1 * 2.0 ** -11
    assert (got.view(np.uint32) & 0x1FFF == 0).all()


def test_gram_big_needs_the_3xtf32_split():
    """At the JAX script's inputs the 3xTF32 Gram meets the stage kernels'
    tolerance (1e-5 of each output's sum of |terms|) against the plain
    version, and plain TF32 does not: why gram_big splits every value."""
    (g,) = em.make_inputs("gram_big", "cpu", g=4)
    x = g.numpy()
    ref = em.gram_reference(g)
    scale = em.terms_scale("gram_big", [g])
    ok, err = em.agreement(torch.from_numpy(_gram_tf32(x, True)), ref, scale)
    assert ok, f"3xTF32: max |diff| {err}"
    ok, err = em.agreement(torch.from_numpy(_gram_tf32(x, False)), ref, scale)
    assert not ok, f"plain TF32 passed, max |diff| {err}"
    assert err > 1e-5 * float(scale.max())


def test_design_sweep_reads_ptxas_usage():
    log = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121stage_"
        "gram_big_kernelILb0EEEvPKfiiPf' for 'sm_90a'\n"
        "ptxas info    : Used 76 registers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121stage_"
        "gram_big_kernelILb1EEEvPKfiiPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_121stage_"
        "gram_big_kernelILb1EEEvPKfiiPf\n"
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 60 registers, 2048 bytes smem\n"
    )
    assert ds.ptxas_usage(log, "stage_gram_big_kernelILb1E") == (60, 8)
    assert ds.ptxas_usage(log, "gather_rows_kernel") == (None, None)


def test_design_sweep_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ds.main() == 1
    assert ds.two_passes({}) == {}


def test_design_sweep_names_the_shipped_gram_big():
    source = (Path(ds.__file__).parent.parent / "csrc" / "exp_stages.cu")
    assert ds.shipped_gram_big(source.read_text()) == "w8_d1"
    name = ds.shipped_gram_big("#define GRAM_BIG_WARPS 2\n"
                               "#define GRAM_BIG_DEPTH 4\n")
    assert name == "w2_d4"


def test_design_sweep_rejects_unknown_sections(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert ds.main(["k1", "k2"]) == 2


def test_design_sweep_reads_every_kernel_of_a_build():
    log = (
        "ptxas info    : Compiling entry function '_ZN4_GN_19fused_assemble_"
        "warpILi3ELi2ELi1EEEvNS_4ArgsE' for 'sm_90a'\n"
        "ptxas info    : Function properties for x\n"
        "    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 105 registers, used 0 barriers\n"
        "ptxas info    : Compiling entry function '_ZN4_GN_20fused_assemble_"
        "blockILi3ELi2ELi1EEEvNS_4ArgsE' for 'sm_90a'\n"
        "    0 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 64 registers, used 1 barriers\n"
    )
    entries = ds.ptxas_entries(log)
    assert sorted(entries.values()) == [(64, 12), (105, 0)]
    assert ds.ptxas_usage(log, ds.K1_KERNELS["warp"]) == (105, 0)
    assert ds.ptxas_usage(log, ds.K1_KERNELS["block"]) == (64, 12)
    assert ds.ptxas_usage(log, ds.K1_KERNELS["first"]) == (None, None)
