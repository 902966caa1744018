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
