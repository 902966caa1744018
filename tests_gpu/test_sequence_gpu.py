"""run_sequence on the card against the same run on the CPU."""

import numpy as np
import pytest
import torch

from correlation_tpu_torch import SequenceConfig, run_sequence
from correlation_tpu_torch.config import DeformationDescription, ReferenceImage
from correlation_tpu_torch.ops import assemble_v2 as v2
from correlation_tpu_torch.problems import sequence_problem

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("deformation", list(DeformationDescription),
                         ids=lambda d: d.name)
def test_sequence_on_card_equals_cpu(deformation):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    cfg, frames, pts, centers = sequence_problem(64, 4, img_hw=256)
    scfg = SequenceConfig(solver=cfg, deformation=deformation,
                          reference=ReferenceImage.PREVIOUS, frame_chunk=4)
    before = v2.LAUNCHES
    card = run_sequence(list(frames), pts, scfg, centers=centers,
                        device="cuda")
    assert v2.LAUNCHES > before
    cpu = run_sequence(list(frames), pts, scfg, centers=centers, device="cpu")
    assert len(card) == len(cpu) == 4
    for a, b in zip(card, cpu):
        np.testing.assert_array_equal(a.params, b.params)
        np.testing.assert_array_equal(a.iterations, b.iterations)
        np.testing.assert_array_equal(a.error, b.error)
        np.testing.assert_allclose(np.median(a.params[:, :2], axis=0),
                                   [0.0, 1.0], atol=0.02)
