"""Gauss-Newton assembly from a coefficient field (JAX backend "xla").

Port of correlation_tpu/ops/assemble.py::assemble_normal_equations and
_reduce_gram.  Per subset at its current warp parameters: warp every
pixel, read w, dw/dx and dw/dy from the deformed image's coefficient field
(ops/interp.py: sample_field), form the residual V = und - w and the
steepest-descent rows H on live pixels, and sum the 8 x 8 Gram of
G = [H | V | bad], in the layout of the fused kernel
(assemble_v2.fused_assemble): A at [i, j], b at [i, NP], chi at [NP, NP],
and at [NP + 1, NP + 1] the count of masked pixels outside the
interpolation window (the err flag when > 0).

It differs from the tiled plain version (fused_assemble_reference) only in
where w and its gradients come from: the pixel rows are
assemble_v2.pack_pixels', H is models.warp.steepest_descent and the Gram
sums run in the fused kernel's order for the padded length
(kernel_order_sum with subset_threads and subset_span).  There is no tile,
so a warp of any size samples the image, and there is no limit on the
channels.  Everything is elementwise arithmetic, gathers and that fixed
order, so the card and the CPU give identical results; the same code runs
on both and launches no kernel of its own.
"""

from __future__ import annotations

import torch

from correlation_tpu_torch.config import FittingModel, Interpolation
from correlation_tpu_torch.models.warp import steepest_descent, warp_points
from correlation_tpu_torch.ops import assemble_v2 as v2
from correlation_tpu_torch.ops.interp import InterpField, sample_field


def field_assemble(
    model: FittingModel,
    interp: Interpolation,
    def_field: InterpField,
    pix: torch.Tensor,
    center: torch.Tensor,
    params: torch.Tensor,
    idx: torch.Tensor | None = None,
) -> torch.Tensor:
    """Assembly of the subsets `idx` (all when None) -> [n, 8, 8] float32.

    def_field: the deformed image's field at this level
    (interp.precompute_field, [Hf, Wf, C, K]); pix: [S, 5 + max(C, 3), P]
    (pack_pixels); center [S, 2]; params [S, NP]; idx: int [n] subset
    indices.  All on one device.
    """
    if idx is not None:
        sel = idx.long()
        pix, center, params = pix[sel], center[sel], params[sel]
    channels = def_field.field.shape[2]
    if pix.shape[1] < v2.ROW_UND + channels:
        raise ValueError(
            f"pix has {pix.shape[1]} rows, the field {channels} channels")
    xy = pix[:, v2.ROW_X : v2.ROW_Y + 1].transpose(1, 2)  # [n, P, 2]
    maskf = pix[:, v2.ROW_MASK]
    w, dwdx, dwdy, valid = sample_field(
        def_field, interp, warp_points(model, params, xy, center))
    ok = valid.to(torch.float32)
    live = maskf * ok
    bad = maskf * (1.0 - ok)
    zrow = torch.zeros_like(bad)
    gs = []
    for c in range(channels):
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
