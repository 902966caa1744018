"""The yardstick of the kernels' roofline shares: one H100's published
peaks, the least time a function's bytes and operations need there, the
bytes and operations of an assembly and of an LM step as the method needs
them (counted from the data, never from the program's padded layout),
and kernel timing from a CUDA graph with the inputs coming from HBM (a
frozen copy of correlation_tpu_torch.utils.profiling.graph_ms_cold).
"""

from __future__ import annotations

import math

import torch

# One H100 SXM, NVIDIA's data sheet, dense rates, at its 700 W limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
L2_BYTES = 50 * 1024 * 1024

# Adds and multiplies of one pixel of an AFFINE / BICUBIC / one-channel
# assembly, the Gram's 36 products with their adds: warp 10, tap
# fractions 2, two sets of Catmull-Rom taps 66, stencil offsets 4, the
# live and bad flags 3, the 4 x 4 tap sums 56 + 21, gradients and
# residual 4, the Jacobian's products 4, the Gram 72.
ASSEMBLY_OPS_PER_PIXEL = {("AFFINE", "BICUBIC", 1): 242}


def bound_ms(moved: float, ops: float = 0.0, kind: str = "fp32") -> float:
    """The least milliseconds one H100 takes to move `moved` bytes and do
    `ops` operations of `kind`: the larger of the two at the peaks."""
    return max(moved / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind]) * 1e3


def assembly_work(model: str, interp: str, channels: int, real_pixels: int,
                  image_pixels: int, subsets: int, num_params: int):
    """(bytes, operations) of one assembly of `subsets` subsets holding
    `real_pixels` pixels in all, whose stencils touch `image_pixels`
    distinct pixels of the deformed image: each pixel's position and
    undeformed intensities, each touched image pixel, each subset's
    center, parameters and bounding box read once, its 8 x 8 Gram
    written once."""
    moved = (real_pixels * (2 + channels) * 4 + image_pixels * channels * 4
             + subsets * (2 + num_params + 8 + 64) * 4)
    ops = ASSEMBLY_OPS_PER_PIXEL.get((model, interp, channels), 0)
    return moved, real_pixels * ops


def lm_step_bytes(listed: int, num_params: int, err_rows: int,
                  stepped: int, gram_rows: int, kept: int) -> int:
    """Bytes one LM step over `listed` subsets moves, each once: per
    listed subset its list entry, its 64-float assembly, its scale, and
    its parameters, last-good parameters, lambda, last-good chi,
    iteration and error code read and written, its active flag written;
    the bounding box and center of each subset with an interpolation
    error; the completed-iterations count of each that steps; the cached
    Gram of each that reads (a diverging step) or writes it (an accepted
    one); the list's length read, the next list's entries and length
    written."""
    every = 4 + 64 * 4 + 4 + 2 * (2 * num_params * 4 + 4 * 4) + 1
    return (listed * every + err_rows * (8 + 2) * 4 + stepped * 4
            + gram_rows * 64 * 4 + 4 + kept * 4 + 4)


def _replay_ms(calls) -> float:
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(calls)


def graph_ms_cold(fn, inputs, reps: int = 20) -> float:
    """Device milliseconds per call of fn(*inputs), replayed from one CUDA
    graph over copies of the inputs that together exceed the L2, so that
    every call reads its inputs from HBM."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    copies = math.ceil(L2_BYTES / nbytes) + 1
    sets = [list(inputs)] + [[t.clone() for t in inputs]
                             for _ in range(copies - 1)]
    n = max(reps, copies)
    return _replay_ms([lambda c=sets[i % copies]: fn(*c) for i in range(n)])
