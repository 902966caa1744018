"""Subpixel interpolation: the coefficient field and integer sampling.

Port of correlation_tpu/ops/interp.py.  Per integer pixel the
interpolation's polynomial coefficients are a fixed linear map of the
pixel's W x W neighbourhood, so the whole coefficient cache of an image is
built at once as a "coefficient field":

    field[y, x, c, k] = sum_ij filt[i, j, k] * image[y + i, x + j, c]

and each solver iteration reads one contiguous C x K row per pixel and
evaluates the polynomial there (sample_field).  The bicubic basis, its
finite-difference constraints, the +1 local offset and the validity
windows are the JAX module's.

The field is a fixed-order sum of W x W shifted image slices times the
filter weights, never a convolution call: cuDNN would run a float32
convolution in TF32 unless told not to.  Every filter weight is a multiple
of 1/4 and a bicubic coefficient's weights sum to at most 576 in absolute
value, so for integer pixels up to 255 (every pyramid level is floored to
integers) each product and partial sum is exact in float32: the field is
the same on the CPU, on the card and in the JAX package.  sample_field
sums the polynomial's terms in a fixed order too, with elementwise
operations only, so the card and the CPU agree bit for bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from correlation_tpu_torch.config import Interpolation

# Polynomial coefficients per interpolation model.
NUM_COEFFS = {
    Interpolation.NEAREST: 3,
    Interpolation.BILINEAR: 4,
    Interpolation.BICUBIC: 16,
}

# Edge length of the neighbourhood window per model.
WINDOW = {
    Interpolation.NEAREST: 2,
    Interpolation.BILINEAR: 2,
    Interpolation.BICUBIC: 4,
}

# Offset of the window's top-left corner from the anchor pixel (bicubic
# anchors at (ix - 1, iy - 1)).
WINDOW_OFFSET = {
    Interpolation.NEAREST: 0,
    Interpolation.BILINEAR: 0,
    Interpolation.BICUBIC: 1,
}


@functools.cache
def _bicubic_inverse_matrix() -> np.ndarray:
    """The inverse of the bicubic constraint system (float64, integral).

    Coefficient k = 4 j + i multiplies y^j x^i; the constraints are the
    value, d/dx, d/dy and d2/dxdy at the four points (x, y) in {1, 2}^2.
    """
    pts = [(1.0, 1.0), (2.0, 1.0), (1.0, 2.0), (2.0, 2.0)]
    rows = []
    for x, y in pts:  # values
        rows.append([y**j * x**i for j in range(4) for i in range(4)])
    for x, y in pts:  # d/dx
        rows.append(
            [i * y**j * x ** max(i - 1, 0) for j in range(4) for i in range(4)]
        )
    for x, y in pts:  # d/dy
        rows.append(
            [j * y ** max(j - 1, 0) * x**i for j in range(4) for i in range(4)]
        )
    for x, y in pts:  # d2/dxdy
        rows.append(
            [
                i * j * y ** max(j - 1, 0) * x ** max(i - 1, 0)
                for j in range(4)
                for i in range(4)
            ]
        )
    inv = np.linalg.inv(np.array(rows, np.float64))
    rounded = np.round(inv)
    if np.abs(inv - rounded).max() >= 1e-9:
        raise ArithmeticError("the bicubic inverse is not integral")
    return rounded


@functools.cache
def _coeff_filters(interp: Interpolation) -> np.ndarray:
    """The K filters of size W x W that map a neighbourhood to the
    coefficients: [W, W, K] float64, window rows are image rows (y),
    columns image columns (x)."""
    interp = Interpolation(interp)
    if interp == Interpolation.BICUBIC:
        # Constraint vector from the 4 x 4 window (c[r, j, i]: j = y row,
        # i = x column).
        c = np.zeros((16, 4, 4), np.float64)
        corners = [(1, 1), (2, 1), (1, 2), (2, 2)]
        for r, (x, y) in enumerate(corners):  # values
            c[r, y, x] += 1.0
        for r, (x, y) in enumerate(corners):  # (w[x+1] - w[x-1]) / 2
            c[4 + r, y, x + 1] += 0.5
            c[4 + r, y, x - 1] -= 0.5
        for r, (x, y) in enumerate(corners):  # (w[y+1] - w[y-1]) / 2
            c[8 + r, y + 1, x] += 0.5
            c[8 + r, y - 1, x] -= 0.5
        for r, (x, y) in enumerate(corners):  # the cross difference / 4
            c[12 + r, y + 1, x + 1] += 0.25
            c[12 + r, y - 1, x - 1] += 0.25
            c[12 + r, y + 1, x - 1] -= 0.25
            c[12 + r, y - 1, x + 1] -= 0.25
        m16 = _bicubic_inverse_matrix() @ c.reshape(16, 16)  # coeff <- window
        return m16.reshape(16, 4, 4).transpose(1, 2, 0)
    filt = np.zeros((2, 2, NUM_COEFFS[interp]), np.float64)
    # [w00, w10 - w00, w01 - w00] (+ [w11 - w10 - w01 + w00] for bilinear);
    # w<X><Y>: X = x column, Y = y row.
    filt[0, 0, 0] = 1.0
    filt[0, 1, 1] = 1.0
    filt[0, 0, 1] = -1.0
    filt[1, 0, 2] = 1.0
    filt[0, 0, 2] = -1.0
    if interp == Interpolation.BILINEAR:
        filt[1, 1, 3] = 1.0
        filt[0, 1, 3] = -1.0
        filt[1, 0, 3] = -1.0
        filt[0, 0, 3] = 1.0
    return filt


class InterpField(NamedTuple):
    """The coefficient field of one image.

    field: [Hf, Wf, C, K] with Hf = H - W + 1, Wf = Wimg - W + 1 for window
    size W; field[y, x] holds the coefficients anchored at image pixel
    (x + off, y + off), off = WINDOW_OFFSET.
    """

    field: torch.Tensor

    def image_shape(self, interp: Interpolation) -> tuple[int, int]:
        win = WINDOW[interp]
        return self.field.shape[0] + win - 1, self.field.shape[1] + win - 1


def precompute_field(image: torch.Tensor, interp: Interpolation) -> InterpField:
    """The coefficient field of a [H, W, C] float32 image with integer
    values, on the image's device: for each coefficient, the sum of the
    window's shifted slices times their nonzero weights, in window order."""
    filt = _coeff_filters(interp)
    win, _, k = filt.shape
    h, w = image.shape[0], image.shape[1]
    hf, wf = h - win + 1, w - win + 1
    if hf < 1 or wf < 1:
        raise ValueError(
            f"a {h}x{w} image is smaller than the {win}x{win} window")
    image = image.to(torch.float32)
    coeffs = []
    for kk in range(k):
        acc = torch.zeros((hf, wf, image.shape[2]), dtype=torch.float32,
                          device=image.device)
        for i in range(win):
            for j in range(win):
                weight = float(filt[i, j, kk])
                if weight:
                    acc = acc + weight * image[i : i + hf, j : j + wf]
        coeffs.append(acc)
    return InterpField(torch.stack(coeffs, dim=-1))


def _poly_sum(cf, terms):
    """sum_k cf[..., k] * terms[k] over C, in k order: [..., C]."""
    out = cf[..., 0] * terms[0][..., None]
    for kk in range(1, len(terms)):
        out = out + cf[..., kk] * terms[kk][..., None]
    return out


def sample_field(coeffs: InterpField, interp: Interpolation,
                 def_xy: torch.Tensor):
    """Intensity and gradients at subpixel deformed positions.

    def_xy: [..., 2].  Returns w, dw/dx, dw/dy [..., C] and valid [...]
    bool: truncation to the anchor pixel (rounding for nearest), the +1
    local offset for bicubic, the polynomial and its derivatives, and the
    validity window; samples outside it are zero and not valid.
    """
    h, w_img = coeffs.image_shape(interp)
    hf, wf, c, k = coeffs.field.shape
    field = coeffs.field.reshape(hf * wf, c * k)
    xdef = def_xy[..., 0]
    ydef = def_xy[..., 1]

    def gather(ix, iy, off):
        # The anchor is clipped to the field; a NaN position (not valid
        # either) reads the first row.
        fx = torch.clamp(torch.nan_to_num(ix - off), 0, wf - 1).long()
        fy = torch.clamp(torch.nan_to_num(iy - off), 0, hf - 1).long()
        cf = field[fy * wf + fx]
        return cf.reshape(cf.shape[:-1] + (c, k))

    if interp == Interpolation.BICUBIC:
        valid = ((xdef > 1.0) & (ydef > 1.0) & (xdef < w_img - 2.0)
                 & (ydef < h - 2.0))
        ix = torch.floor(xdef)
        iy = torch.floor(ydef)
        # Local coordinates in [1, 2).
        dx = xdef - ix + 1.0
        dy = ydef - iy + 1.0
        cf = gather(ix, iy, 1)
        one = torch.ones_like(dx)
        zero = torch.zeros_like(dx)
        px = [one, dx, dx * dx, dx * dx * dx]
        py = [one, dy, dy * dy, dy * dy * dy]
        dpx = [zero, one, 2.0 * dx, 3.0 * dx * dx]
        dpy = [zero, one, 2.0 * dy, 3.0 * dy * dy]
        # Coefficient 4 j + i multiplies y^j x^i.
        w_out = _poly_sum(cf, [py[j] * px[i] for j in range(4) for i in range(4)])
        dwdx = _poly_sum(cf, [py[j] * dpx[i] for j in range(4) for i in range(4)])
        dwdy = _poly_sum(cf, [dpy[j] * px[i] for j in range(4) for i in range(4)])
    elif interp in (Interpolation.BILINEAR, Interpolation.NEAREST):
        valid = ((xdef > 0.0) & (ydef > 0.0) & (xdef < w_img - 1.0)
                 & (ydef < h - 1.0))
        if interp == Interpolation.BILINEAR:
            ix = torch.floor(xdef)
            iy = torch.floor(ydef)
            dxe = (xdef - ix)[..., None]
            dye = (ydef - iy)[..., None]
            a0, a1, a2, a3 = gather(ix, iy, 0).unbind(-1)
            w_out = a0 + a1 * dxe + a2 * dye + a3 * dxe * dye
            dwdx = a1 + a3 * dye
            dwdy = a2 + a3 * dxe
        else:
            cf = gather(torch.floor(xdef + 0.5), torch.floor(ydef + 0.5), 0)
            w_out, dwdx, dwdy = cf.unbind(-1)
    else:
        raise ValueError(f"unknown interpolation {interp}")

    vmask = valid[..., None]
    zero = torch.zeros((), dtype=torch.float32, device=def_xy.device)
    return (torch.where(vmask, w_out, zero), torch.where(vmask, dwdx, zero),
            torch.where(vmask, dwdy, zero), valid)


def sample_integer(image: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensities at rounded integer positions int(x + 0.5), clipped to the
    image: image [H, W, C], xy [..., 2] -> [..., C]."""
    h, w, c = image.shape
    ix = torch.clamp(torch.floor(xy[..., 0] + 0.5), 0, w - 1).long()
    iy = torch.clamp(torch.floor(xy[..., 1] + 0.5), 0, h - 1).long()
    return image.reshape(h * w, c)[iy * w + ix]
