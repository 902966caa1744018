"""Pixel-sharded assembly with a collective reduction of the Gram.

Port of correlation_tpu/parallel/collectives.py (BASELINE config 5's
"collective H/b reduction"): for very large subsets the pixel axis itself
shards over the ranks, each rank assembles its contiguous pixel slice on
the coefficient field (ops/assemble.field_assemble, the counterpart of
JAX's assemble_normal_equations) and the partial A / b / chi / error
counts reduce across ranks.

The reduction is an all_gather of the partial Grams followed by a sum in
rank order, not an all_reduce: NCCL does not promise the order of its
all_reduce, and this way the result is the same on gloo and NCCL and from
run to run.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from correlation_tpu_torch.config import FittingModel, Interpolation
from correlation_tpu_torch.ops import assemble_v2 as v2
from correlation_tpu_torch.ops.assemble import field_assemble
from correlation_tpu_torch.ops.interp import InterpField
from correlation_tpu_torch.parallel.mesh import Mesh, make_mesh

PIXEL_AXIS = "pixels"


def make_pixel_mesh(device=None) -> Mesh:
    """The mesh the pixel axis shards over: make_mesh's (the default
    process group, or a world of one)."""
    return make_mesh(device)


def assemble_pixel_sharded(
    mesh: Mesh,
    model: FittingModel,
    interp: Interpolation,
    def_field: InterpField,
    und_w: torch.Tensor,
    xy: torch.Tensor,
    mask: torch.Tensor,
    center: torch.Tensor,
    params: torch.Tensor,
):
    """Assembly with the PIXEL axis sharded across the mesh.

    def_field: the deformed image's coefficient field (precompute_field);
    und_w [S, P, C] undeformed intensities; xy [S, P, 2]; mask [S, P];
    center [S, 2]; params [S, NP]; all on the rank's device and the same
    on every rank.  P must be divisible by the mesh size (pad with masked
    pixels).

    Returns (A [S, NP, NP], b [S, NP], chi [S], err [S] bool), the sums
    over every rank's pixels (chi unscaled), on every rank.
    """
    p_len = xy.shape[1]
    if p_len % mesh.size:
        raise ValueError(
            f"{p_len} pixels do not split over {mesh.size} ranks; pad the "
            "pixel axis with masked pixels to a multiple of the mesh size")
    per = p_len // mesh.size
    cut = slice(mesh.rank * per, (mesh.rank + 1) * per)
    pix = v2.pack_pixels(xy[:, cut], mask[:, cut], und_w[:, cut], center)
    gram = field_assemble(model, interp, def_field, pix, center, params)
    if mesh.group is not None:
        parts = [torch.empty_like(gram) for _ in range(mesh.size)]
        dist.all_gather(parts, gram, group=mesh.group)
        gram = parts[0]
        for part in parts[1:]:
            gram = gram + part
    num_p = params.shape[1]
    return (gram[:, :num_p, :num_p], gram[:, :num_p, num_p],
            gram[:, num_p, num_p], gram[:, num_p + 1, num_p + 1] > 0.0)
