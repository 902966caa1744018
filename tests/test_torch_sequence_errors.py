"""The port's run_sequence against the JAX package's under the three
error modes, with a sector forced to fail on the sequence's first frame
pair or on a later one.  Chunked Lagrangian, reference-Previous sequences:
the guess is the previous result, so a per-sector guess chains as in the
per-frame path, and the domain walks with the material.  Set-up and
tolerances as in test_torch_sequence.py.

  fail_at = 0: sector 0 starts from a guess 200 px off the image
    (MODEL_OUT_OF_IMAGE).  STOP_FRAME records zero parameters for it, not
    its guess, and it tracks again from there; CONTINUE chains the guess
    and fails again.
  fail_at = 2: sector 1's points end at x = 84.  The domain follows the
    motion (1.3 px a pair) by whole pixels; at pair 2 the level-2 point
    set steps one pixel right (floor(2 / 4 + 0.5)), and the guess takes its
    rightmost points to x = 22.3 of the 24-pixel level-2 image, past the
    bicubic window (INTERPOLATION_OUT_OF_IMAGE at the initial assembly).
"""

import numpy as np
import pytest
import torch

from correlation_tpu_torch.config import (
    DeformationDescription,
    ErrorCode,
    ErrorMode,
    ReferenceImage,
)
from test_torch_sequence import (
    assert_same_records,
    drift_frames,
    run_both,
    sectors,
)

torch.set_num_threads(2)


def _problem(fail_at):
    right = 76 if fail_at == 2 else 72
    pts = sectors([(20, 20), (right, 40), (20, 70), (50, 70)])
    guess = np.zeros((4, 2), np.float32)
    if fail_at == 0:
        guess[0] = (200.0, 0.0)
    return drift_frames(4, 1.3, -0.8), pts, guess


@pytest.mark.parametrize("fail_at", [0, 2])
@pytest.mark.parametrize("mode", list(ErrorMode), ids=lambda m: m.name)
def test_error_mode_matches_jax(mode, fail_at):
    frames, pts, guess = _problem(fail_at)
    ref, got = run_both(frames, pts,
                        deformation=DeformationDescription.LAGRANGIAN,
                        reference=ReferenceImage.PREVIOUS, error_mode=mode,
                        per_sector_guess=guess)
    assert_same_records(ref, got)
    bad = 0 if fail_at == 0 else 1
    code = (ErrorCode.MODEL_OUT_OF_IMAGE if fail_at == 0
            else ErrorCode.INTERPOLATION_OUT_OF_IMAGE)
    assert got[fail_at].error[bad] == code
    assert not np.delete(got[fail_at].error, bad).any()
    assert all(not r.error.any() for r in got[:fail_at])
    if mode == ErrorMode.STOP_ALL:
        assert len(got) == fail_at + 1  # the failing pair is recorded
        return
    assert len(got) == 3
    if mode == ErrorMode.STOP_FRAME:
        kept = (np.zeros(6, np.float32) if fail_at == 0
                else got[fail_at - 1].params[bad])
        np.testing.assert_array_equal(got[fail_at].params[bad], kept)
        assert got[fail_at].chi[bad] == (0.0 if fail_at == 0
                                         else got[fail_at - 1].chi[bad])
        if fail_at == 0:
            # Restarted from zero, the sector tracks again.
            assert got[1].error[bad] == 0
            np.testing.assert_allclose(got[1].params[bad, :2], [1.3, -0.8],
                                       atol=0.02)
    else:
        # An initial failure returns the guess, and CONTINUE chains it.
        np.testing.assert_array_equal(got[fail_at].params[bad],
                                      got[fail_at].initial_guess[bad])
        if fail_at == 0:
            assert got[1].error[bad] == ErrorCode.MODEL_OUT_OF_IMAGE
