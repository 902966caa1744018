"""Automatic initial guesses by phase correlation (port of
correlation_tpu/ops/seed.py).

LM correlation converges only from a guess inside the pyramid's capture
range (a few pixels at the coarsest level), so large rigid displacements
need a seed.  Phase correlation of a window around each sector center
gives its whole-pixel translation:

    R = F(und) * conj(F(def)) / |...|   (cross-power spectrum)
    r = F^-1(R); (du, dv) = -argmax r   (signed, unwrapped)

The windows are Hann-tapered after their mean is removed, as in the JAX
package; the FFTs run on `device` (by default the card).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _resolve(device) -> torch.device:
    """`device` when named, else the card, raising where there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "phase correlation runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run it on the CPU")
    return torch.device("cuda")


def _phase_correlate(und_w: torch.Tensor, def_w: torch.Tensor) -> torch.Tensor:
    """[S, 2] float32 integer (du, dv) of [S, win, win] window pairs."""
    win = und_w.shape[-1]
    n = torch.arange(win, dtype=torch.float32, device=und_w.device)
    hann = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win)
    taper = hann[:, None] * hann[None, :]

    def prep(w):
        return (w - w.mean(dim=(-2, -1), keepdim=True)) * taper

    cross = torch.fft.rfft2(prep(und_w)) * torch.conj(torch.fft.rfft2(
        prep(def_w)))
    cross = cross / torch.clamp(torch.abs(cross), min=1e-9)
    corr = torch.fft.irfft2(cross, s=(win, win))
    idx = corr.reshape(corr.shape[0], -1).argmax(dim=-1)
    py = idx // win
    px = idx % win
    # F(und) conj(F(def)) peaks at the cyclic shift taking def back to und;
    # the und -> def displacement is its negation, unwrapped to the
    # smallest signed magnitude.
    du = -torch.where(px > win // 2, px - win, px)
    dv = -torch.where(py > win // 2, py - win, py)
    return torch.stack([du, dv], dim=-1).to(torch.float32)


def _windows(img: np.ndarray, centers: np.ndarray, win: int) -> np.ndarray:
    h, w = img.shape[:2]
    half = win // 2
    out = np.zeros((len(centers), win, win), np.float32)
    for i, (cx, cy) in enumerate(centers):
        x0 = int(np.clip(round(cx) - half, 0, max(w - win, 0)))
        y0 = int(np.clip(round(cy) - half, 0, max(h - win, 0)))
        out[i] = img[y0 : y0 + win, x0 : x0 + win, 0]
    return out


def phase_correlation_guess(
    und: np.ndarray,
    dfm: np.ndarray,
    centers: np.ndarray,
    win: int = 64,
    device=None,
) -> np.ndarray:
    """Per-sector whole-pixel (u, v) seeds from windows around `centers`.

    und, dfm: [H, W, C] images (channel 0 is used); centers: [S, 2] sector
    centers (x, y); win: window size (clipped to the image); device: where
    the FFTs run (default: the card, raising RuntimeError without one).
    Returns [S, 2] float32 integer-valued (u, v).
    """
    device = _resolve(device)
    und = np.asarray(und)
    dfm = np.asarray(dfm)
    centers = np.asarray(centers, np.float32).reshape(-1, 2)
    win = int(min(win, und.shape[0], und.shape[1]))
    uw = torch.from_numpy(_windows(und, centers, win)).to(device)
    dw = torch.from_numpy(_windows(dfm, centers, win)).to(device)
    return _phase_correlate(uw, dw).cpu().numpy()


def global_guess_from_pair(
    und: np.ndarray,
    dfm: np.ndarray,
    center: np.ndarray,
    num_params: int,
    win: int = 128,
    device=None,
) -> np.ndarray:
    """One global [NP] guess for the frame-0 solve: (u, v) from the window
    around `center`, the higher-order terms zero.  device: as
    phase_correlation_guess."""
    uv = phase_correlation_guess(und, dfm, np.asarray(center).reshape(1, 2),
                                 win=win, device=device)[0]
    guess = np.zeros(num_params, np.float32)
    guess[0] = uv[0]
    if num_params > 1:
        guess[1] = uv[1]
    return guess
