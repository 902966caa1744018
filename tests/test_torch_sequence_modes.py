"""More sequence modes of the port's run_sequence against the JAX package's:
the chunked Lagrangian chain with explicit (float, chained) centers, the
per-frame strict-Lagrangian path, and frames whose width is not a
multiple of 128.  Set-up and tolerances as in test_torch_sequence.py.
"""

import numpy as np
import torch

from correlation_tpu_torch.config import DeformationDescription, ReferenceImage
from test_torch_sequence import (
    CENTERS,
    assert_same_records,
    drift_frames,
    run_both,
    sectors,
)

torch.set_num_threads(2)


def test_lagrangian_explicit_centers_matches_jax():
    frames = drift_frames(4, 1.3, -0.8)
    ref, got = run_both(
        frames, sectors(CENTERS), deformation=DeformationDescription.LAGRANGIAN,
        reference=ReferenceImage.PREVIOUS,
        centers=np.array(CENTERS, np.float32),
    )
    assert len(got) == 3
    assert_same_records(ref, got)
    # Explicit centers chain the float deformed centers.
    np.testing.assert_allclose(got[2].und_center, got[1].def_center,
                               atol=1e-6)


def test_strict_lagrangian_per_frame_matches_jax():
    frames = drift_frames(4, 1.3, -0.8)
    ref, got = run_both(
        frames, sectors(CENTERS),
        deformation=DeformationDescription.STRICT_LAGRANGIAN,
        reference=ReferenceImage.PREVIOUS,
    )
    assert len(got) == 3
    assert_same_records(ref, got)
    for rec in got:
        assert (rec.error == 0).all()
        np.testing.assert_allclose(rec.def_center - rec.und_center,
                                   rec.params[:, :2], atol=1e-5)


def test_frames_not_multiple_of_128_wide():
    """96 x 130 frames.  JAX's tile origin follows a path chosen by the
    TPU's memory budget: its DMA path clips against the image padded to 8
    rows and 128 columns, the port against the image padded to the tile.
    The two place tiles alike while a warped subset stays clear of the
    bottom and right edges, as all six subsets here do (the rightmost
    points lie 24 px from the right edge): every record equals JAX's."""
    frames = drift_frames(4, 1.3, -0.8, h=96, w=130, seed=7)
    centers = [(30, 30), (64, 30), (98, 30), (30, 64), (64, 64), (98, 64)]
    ref, got = run_both(frames, sectors(centers))
    assert len(got) == 3
    assert_same_records(ref, got)
    np.testing.assert_allclose(got[-1].params[:, :2],
                               np.tile([3.9, -2.4], (6, 1)), atol=0.02)
