"""Gauss-Newton assembly without the fused kernel: from a coefficient
field (JAX backend "xla") and from separable tiles (JAX backend
"xla_sep").

Ports of correlation_tpu/ops/assemble.py: field_assemble of
assemble_normal_equations, sep_assemble of
assemble_normal_equations_tiles, both with _reduce_gram.  Per subset at
its current warp parameters: warp every pixel, read w, dw/dx and dw/dy
from the deformed image, form the residual V = und - w and the
steepest-descent rows H on live pixels, and sum the 8 x 8 Gram of
G = [H | V | bad], in the layout of the fused kernel
(assemble_v2.fused_assemble): A at [i, j], b at [i, NP], chi at [NP, NP],
and at [NP + 1, NP + 1] the count of masked pixels that are not live (the
err flag when > 0).

The two differ only in where w and its gradients come from.
field_assemble samples the level's coefficient field: there is no tile,
so a warp of any size samples the image.  sep_assemble reads the
Catmull-Rom / bilinear / nearest taps of each pixel from the subset's
tile of the deformed image (padded only up to the tile), placed by
JAX's rule: the masked minimum of the warped pixels minus halo + 1
(0 for a subset without a finite masked pixel), clipped to the padded
image; a pixel whose stencil leaves the tile is flagged like one outside
the interpolation window.  It differs from the fused kernel's plain
version (fused_assemble_reference) in that rule alone: the kernel places
its tiles from the warped bounding-box corners, which for a domain whose
corners are not pixels of its mask (annular sectors, blobs) is another
tile.  Neither limits the channels.  Both take a subset list as the fused
kernel does: idx alone, or idx with its length `count`, which they read
on the host.

The pixel rows are assemble_v2.pack_pixels', H is
models.warp.steepest_descent and the Gram sums run in the fused kernel's
order for the padded length (kernel_order_sum with subset_threads and
subset_span).  Everything is elementwise arithmetic, gathers and fixed
orders (never einsum, matmul or a convolution, which run TF32 or
cuBLAS's order on the card), so the card and the CPU give identical
results; the same code runs on both and launches no kernel of its own.
"""

from __future__ import annotations

import torch

from correlation_tpu_torch.config import FittingModel, Interpolation
from correlation_tpu_torch.models.warp import steepest_descent, warp_points
from correlation_tpu_torch.ops import assemble_v2 as v2
from correlation_tpu_torch.ops.interp import InterpField, sample_field


def _gram(model, pix, xy, center, w, dwdx, dwdy, ok) -> torch.Tensor:
    """[n, 8, 8] Gram of [H | V | bad] from w, dw/dx, dw/dy [n, P, C] and
    ok [n, P] float32 (1 where the pixel sampled the image)."""
    maskf = pix[:, v2.ROW_MASK]
    live = maskf * ok
    bad = maskf * (1.0 - ok)
    zrow = torch.zeros_like(bad)
    gs = []
    for c in range(w.shape[-1]):
        v = (pix[:, v2.ROW_UND + c] - w[..., c]) * live
        h = steepest_descent(model, xy, center, dwdx[..., c] * live,
                             dwdy[..., c] * live)  # [n, P, NP]
        rows = list(h.unbind(-1)) + [v, bad if c == 0 else zrow]
        gs.append(torch.stack(rows, dim=1))  # [n, R, P]
    g = torch.stack(gs, dim=-1)  # [n, R, P, C], R = NP + 2
    r = g.shape[1]
    iu, ju = torch.triu_indices(r, r, device=g.device)
    p_len = pix.shape[2]
    sums = v2.kernel_order_sum(g[:, iu] * g[:, ju], v2.subset_threads(p_len),
                               v2.subset_span(p_len))  # upper triangle
    out = torch.zeros((g.shape[0], 8, 8), dtype=torch.float32, device=g.device)
    out[:, iu, ju] = sums
    out[:, ju, iu] = sums
    return out


def _listed(part, idx, count) -> torch.Tensor:
    """[len(idx), 8, 8]: part(idx[:count]) in the first count rows and zero
    rows past them, as assemble_v2.fused_assemble_reference returns a list
    with a length; count (int32 [1], on any device) is read on the host."""
    whole = torch.zeros((idx.shape[0], 8, 8), dtype=torch.float32,
                        device=idx.device)
    live = int(count)
    if live:
        whole[:live] = part(idx[:live])
    return whole


def _check_rows(pix, channels):
    if pix.shape[1] < v2.ROW_UND + channels:
        raise ValueError(
            f"pix has {pix.shape[1]} rows, the image {channels} channels")


def field_assemble(
    model: FittingModel,
    interp: Interpolation,
    def_field: InterpField,
    pix: torch.Tensor,
    center: torch.Tensor,
    params: torch.Tensor,
    idx: torch.Tensor | None = None,
    count: torch.Tensor | None = None,
) -> torch.Tensor:
    """Assembly of the subsets `idx` (all when None) -> [n, 8, 8] float32.

    def_field: the deformed image's field at this level
    (interp.precompute_field, [Hf, Wf, C, K]); pix: [S, 5 + max(C, 3), P]
    (pack_pixels); center [S, 2]; params [S, NP]; idx: int [n] subset
    indices; count: optional int32 [1], the list's length: only
    idx[:count] are assembled, the rows past it zero.  All on one device
    but count, which may be on the host.
    """
    if count is not None:
        return _listed(
            lambda rows: field_assemble(model, interp, def_field, pix, center,
                                        params, rows),
            idx, count)
    if idx is not None:
        sel = idx.long()
        pix, center, params = pix[sel], center[sel], params[sel]
    _check_rows(pix, def_field.field.shape[2])
    xy = pix[:, v2.ROW_X : v2.ROW_Y + 1].transpose(1, 2)  # [n, P, 2]
    w, dwdx, dwdy, valid = sample_field(
        def_field, interp, warp_points(model, params, xy, center))
    return _gram(model, pix, xy, center, w, dwdx, dwdy,
                 valid.to(torch.float32))


def sep_origins(mask: torch.Tensor, xd: torch.Tensor, yd: torch.Tensor,
                halo: int, padded_h: int, padded_w: int, tile_h: int,
                tile_w: int) -> torch.Tensor:
    """[n, 2] float32 tile origins (y0, x0), JAX's xla_sep rule: the floor
    of the masked minimum of the warped pixels (xd, yd [n, P]) minus
    halo + 1, 0 where that minimum is not finite or the subset has no
    masked pixel, clipped to [0, max(padded - tile, 0)]."""
    # A Python scalar, not a tensor: no host-to-card copy, so the assembly
    # can be captured in a CUDA graph.  It rounds to float32 alike in the
    # where and in the comparison.
    big = 3.0e38
    min_x = torch.where(mask, xd, big).amin(dim=1)
    min_y = torch.where(mask, yd, big).amin(dim=1)
    finite = torch.isfinite(min_x) & torch.isfinite(min_y) & (min_x < big)
    zero = torch.zeros_like(min_x)
    x0 = torch.where(finite, torch.floor(min_x) - (halo + 1), zero)
    y0 = torch.where(finite, torch.floor(min_y) - (halo + 1), zero)
    # Clipped as floats: the same as JAX's clip of the saturated int32.
    x0 = x0.clamp(0, max(padded_w - tile_w, 0))
    y0 = y0.clamp(0, max(padded_h - tile_h, 0))
    return torch.stack([y0, x0], dim=-1)


def sep_assemble(
    model: FittingModel,
    interp: Interpolation,
    tile_h: int,
    tile_w: int,
    img_h: int,
    img_w: int,
    img: torch.Tensor,
    pix: torch.Tensor,
    center: torch.Tensor,
    params: torch.Tensor,
    idx: torch.Tensor | None = None,
    count: torch.Tensor | None = None,
) -> torch.Tensor:
    """Separable-tile assembly of the subsets `idx` (all when None) ->
    [n, 8, 8] float32.

    img: [Hp, Wp, C] float32 deformed image, zero-padded to at least
    (tile_h, tile_w) (assemble_v2.prepare_image); img_h, img_w: its true
    dims (validity windows); pix: [S, 5 + max(C, 3), P] (pack_pixels);
    center [S, 2]; params [S, NP]; idx: int [n] subset indices; count:
    optional int32 [1], the list's length: only idx[:count] are
    assembled, the rows past it zero.  All on one device but count, which
    may be on the host.
    """
    if count is not None:
        return _listed(
            lambda rows: sep_assemble(model, interp, tile_h, tile_w, img_h,
                                      img_w, img, pix, center, params, rows),
            idx, count)
    if idx is not None:
        sel = idx.long()
        pix, center, params = pix[sel], center[sel], params[sel]
    hp, wp, channels = img.shape
    _check_rows(pix, channels)
    if hp < tile_h or wp < tile_w:
        raise ValueError(f"image {(hp, wp)} smaller than tile "
                         f"({tile_h}, {tile_w}); pad it with prepare_image")
    taps, halo = v2._taps_halo(interp)
    xy = pix[:, v2.ROW_X : v2.ROW_Y + 1].transpose(1, 2)  # [n, P, 2]
    xd, yd = warp_points(model, params, xy, center).unbind(-1)
    ax = torch.floor(xd)
    ay = torch.floor(yd)
    valid, kx, dkx, ky, dky = v2._interp_taps(interp, xd - ax, yd - ay, xd,
                                              yd, img_h, img_w)
    if interp == Interpolation.NEAREST:
        ax = torch.floor(xd + 0.5)
        ay = torch.floor(yd + 0.5)
    org = sep_origins(pix[:, v2.ROW_MASK] > 0, xd, yd, halo, hp, wp, tile_h,
                      tile_w)
    rxf = ax - halo - org[:, 1:2]
    ryf = ay - halo - org[:, 0:1]
    in_tile = ((rxf >= 0) & (rxf <= tile_w - taps) & (ryf >= 0)
               & (ryf <= tile_h - taps))
    ok = valid & in_tile
    # Clipped after in_tile is taken: a pixel out of its tile reads a tile
    # value, zeroed below.
    zero = torch.zeros_like(rxf)
    rx = torch.where(torch.isfinite(rxf), rxf, zero).clamp(0, tile_w - taps)
    ry = torch.where(torch.isfinite(ryf), ryf, zero).clamp(0, tile_h - taps)
    # Flat image index of each pixel's stencil corner (tile origin + offset).
    base = ((org[:, 0:1] + ry).long() * wp
            + (org[:, 1:2] + rx).long())  # [n, P]
    flat = img.reshape(hp * wp, channels)
    okc = ok[..., None]
    outs = []
    for c in range(channels):
        plane = flat[:, c]
        # Column i's row sums, the row taps j ascending, then the column
        # taps i ascending.
        tmp, tmp_d = [], []
        for i in range(taps):
            t = td = None
            for j in range(taps):
                val = plane[base + (j * wp + i)]
                t = ky[j] * val if t is None else t + ky[j] * val
                td = dky[j] * val if td is None else td + dky[j] * val
            tmp.append(t)
            tmp_d.append(td)
        w_v = kx[0] * tmp[0]
        dwdx = dkx[0] * tmp[0]
        dwdy = kx[0] * tmp_d[0]
        for i in range(1, taps):
            w_v = w_v + kx[i] * tmp[i]
            dwdx = dwdx + dkx[i] * tmp[i]
            dwdy = dwdy + kx[i] * tmp_d[i]
        outs.append((w_v, dwdx, dwdy))
    w_v, dwdx, dwdy = (torch.where(okc, torch.stack(a, dim=-1), 0.0)
                       for a in zip(*outs))
    return _gram(model, pix, xy, center, w_v, dwdx, dwdy, ok.to(torch.float32))
