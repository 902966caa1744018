"""The experiment kernels (csrc/exp_gather.cu, csrc/exp_stages.cu) against
their plain PyTorch versions, on the card.

The gather moves bits, so it must equal its plain version exactly.  The
stage kernels sum in another order than their plain versions (the products'
bf16 x bf16 terms are exact in float32), so they agree within 1e-5 of the
sum of the absolute values of each output's terms.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from correlation_tpu_torch.experiments import exp_gather as eg
from correlation_tpu_torch.experiments import exp_matmul_overhead as em

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def test_gather_equals_plain(dev):
    src, idx = eg.make_inputs(dev)
    before = eg.LAUNCHES
    got = eg.gather_rows(src, idx)
    assert eg.LAUNCHES == before + 1
    assert torch.equal(got, eg.gather_rows_reference(src, idx))
    # Another width: two blocks, the second one ragged.
    wide = torch.randn(40, 700, device=dev)
    wide_idx = torch.randint(0, 40, (9, 700), dtype=torch.int32, device=dev)
    assert torch.equal(eg.gather_rows(wide, wide_idx),
                       eg.gather_rows_reference(wide, wide_idx))


@pytest.mark.parametrize("rows,cols,n", [
    (64, 700, 16),   # a ragged last slab
    (64, 33, 16),    # one live lane in the last slab
    (64, 1, 16),     # one column
    (1, 512, 16),    # one row: every index 0
    (200, 512, 16),  # more rows than a block has warps
    (64, 512, 1),    # one gathered row
    (200, 33, 1),
    (64, 512, 40),   # more gathered rows than a block has warps
    # More rows than a block's shared memory holds (1816): the rows past
    # it are read straight from memory.
    (2000, 40, 3),
])
def test_gather_shapes_bit_for_bit(dev, rows, cols, n):
    rng = np.random.default_rng(rows * cols + n)
    src = torch.from_numpy(rng.standard_normal((rows, cols))).float().to(dev)
    idx = torch.from_numpy(rng.integers(0, rows, (n, cols))).int().to(dev)
    assert torch.equal(eg.gather_rows(src, idx),
                       eg.gather_rows_reference(src, idx))


def test_gather_misaligned_equals_plain(dev):
    """src and idx 4 bytes past a 16-byte boundary."""
    src, idx = eg.make_inputs(dev)
    bufs = [torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
            for t in (src, idx)]
    src2, idx2 = (b[1:].view(t.shape).copy_(t)
                  for b, t in zip(bufs, (src, idx)))
    assert src2.data_ptr() % 16 and idx2.data_ptr() % 16
    assert torch.equal(eg.gather_rows(src2, idx2),
                       eg.gather_rows_reference(src, idx))


def test_gather_index_out_of_range_stops_kernel(dev):
    # The kernel traps, which leaves the CUDA context unusable: run it in a
    # process of its own.
    code = (
        "import torch\n"
        "from correlation_tpu_torch.experiments import exp_gather as eg\n"
        "src, idx = eg.make_inputs(torch.device('cuda'))\n"
        "eg.gather_rows(src, idx); torch.cuda.synchronize()\n"
        "print('valid index ok', flush=True)\n"
        "idx[3, 7] = eg.TH\n"
        "eg.gather_rows(src, idx); torch.cuda.synchronize()\n"
        "print('out-of-range index passed', flush=True)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert "valid index ok" in proc.stdout, proc.stderr
    assert "out-of-range index passed" not in proc.stdout
    assert proc.returncode != 0


@pytest.mark.parametrize("name", em.NAMES)
def test_stage_kernel_agrees_with_plain(dev, name):
    inputs = em.make_inputs(name, dev, g=6)
    before = em.LAUNCHES[name]
    got = em.KERNELS[name](*inputs)
    again = em.KERNELS[name](*inputs)
    assert em.LAUNCHES[name] == before + 2
    ref = em.REFERENCES[name](*inputs)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # fixed summation order
    ok, err = em.agreement(got, ref, em.terms_scale(name, inputs))
    assert ok, f"{name}: max |kernel - plain| {err}"


def test_gram_loop_equals_gram_big(dev):
    (g,) = em.make_inputs("gram_loop", dev, g=6)
    ok, err = em.agreement(em.stage_gram_loop(g), em.stage_gram_big(g),
                           em.terms_scale("gram_loop", [g]))
    assert ok, err


def _gram_input(dev, g, b, p, misalign=False):
    rng = np.random.default_rng(g * b * p)
    x = torch.from_numpy(rng.standard_normal((g, b, 8, p)) * 0.1).float()
    x = x.to(dev)
    if misalign:  # 4 bytes past a 16-byte boundary: element-wise loads
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        x = buf[1:].view(x.shape).copy_(x)
    return x


@pytest.mark.parametrize("shape", [
    (1, 8, 512),   # G = 1
    (3, 7, 512),   # odd B and an odd subset count: a zero partner
    (2, 5, 300),   # P a multiple of 4, ragged last chunk
    (1, 3, 517),   # P not a multiple of 4: element-wise loads
    (1, 1, 20),    # one subset, fewer pixels than a chunk
])
@pytest.mark.parametrize("misalign", [False, True])
def test_gram_big_ragged_shapes(dev, shape, misalign):
    """gram_big against its plain version and gram_loop within 1e-5 of the
    sum of |terms|, and the 16-byte and element-wise loads bit for bit."""
    x = _gram_input(dev, *shape, misalign)
    assert bool(x.data_ptr() % 16) == misalign
    got = em.stage_gram_big(x)
    scale = em.terms_scale("gram_big", [x])
    for other in (em.gram_reference(x), em.stage_gram_loop(x)):
        ok, err = em.agreement(got, other, scale)
        assert ok, f"{shape}: max |diff| {err}"
    if misalign:
        assert torch.equal(got, em.stage_gram_big(_gram_input(dev, *shape)))


def _product_inputs(dev, g, b, k, m, p, misalign=False):
    """a [g, b, k, m], o [g, b, k, p] bfloat16 from a seed; with misalign,
    each starts 2 bytes past a 16-byte boundary (the kernel's element-wise
    path)."""
    rng = np.random.default_rng(k * m + p)
    out = []
    for shape in ((g, b, k, m), (g, b, k, p)):
        x = torch.from_numpy(rng.standard_normal(shape) * 0.1).float()
        x = x.to(dev).to(torch.bfloat16)
        if misalign:
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
            x = buf[1:].view(shape).copy_(x)
        out.append(x)
    return out


@pytest.mark.parametrize("shape", [
    (6, 8, 120, 128, 512),  # the experiment's widths
    (1, 1, 120, 100, 300),  # ragged: element-wise staging and stores
    (1, 1, 37, 100, 300),   # K not a multiple of 16
    (2, 3, 120, 64, 520),   # 16-byte path with a ragged last tile
])
def test_loop_equals_batched_bit_for_bit(dev, shape):
    """One product routine, one summation order: the two grids give the
    same bits, twice, within 1e-5 of the sum of |terms| of the plain
    version."""
    a, o = _product_inputs(dev, *shape)
    loop = em.stage_loop(a, o)
    batched = em.stage_batched(a, o)
    again = em.stage_loop(a, o)
    ref = em.product_reference(a, o)
    torch.cuda.synchronize()
    assert torch.equal(loop, batched)
    assert torch.equal(loop, again)
    ok, err = em.agreement(loop, ref, em.terms_scale("loop", [a, o]))
    assert ok, f"{shape}: max |kernel - plain| {err}"


def test_product_paths_agree_bit_for_bit(dev):
    """Inputs off 16-byte alignment take the element-wise path: the same
    products in the same order as the 16-byte path."""
    shape = (2, 2, 120, 128, 512)
    a, o = _product_inputs(dev, *shape)
    a2, o2 = _product_inputs(dev, *shape, misalign=True)
    assert a2.data_ptr() % 16 and torch.equal(a, a2) and torch.equal(o, o2)
    assert torch.equal(em.stage_batched(a, o), em.stage_batched(a2, o2))
