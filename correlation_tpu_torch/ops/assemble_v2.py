"""Fused Gauss-Newton assembly: the port of the Pallas kernel
correlation_tpu/ops/assemble_v2.py::fused_assemble.

For each subset at its current warp parameters:
  1. warp every subset pixel (forward-additive, per fitting model);
  2. Catmull-Rom / bilinear / nearest taps and the validity window;
  3. read the deformed intensity w and dw/dx, dw/dy from the subset's
     image tile;
  4. the residual V = und - w on live pixels and the steepest-descent
     rows H;
  5. one 8x8 Gram of G = [H | V | bad].

The output is [n, 8, 8] float32 in the TPU kernel's layout: A at [i, j],
b at [i, NP], chi at [NP, NP], and at [NP+1, NP+1] the count of masked
pixels that are outside the interpolation window or the tile (the err
flag when > 0).

Tile contract (the Pallas kernel's non-DMA path): the deformed image is
zero-padded to at least (tile_h, tile_w); a subset's tile origin is the
floor of the minimum of its warped bounding-box corners, minus halo + 1,
clipped to the padded image, and 0 when a corner is not finite; a pixel
is valid when it lies inside the interpolation window AND its whole
stencil lies inside the tile.

`fused_assemble` launches the hand-written CUDA kernel
(csrc/fused_assemble.cu) for CUDA tensors and runs
`fused_assemble_reference`, the plain PyTorch version, for CPU tensors.
Both take an optional int32 index list of the subsets to assemble, so an
LM loop over the still-active subsets gathers nothing, and optionally the
list's length as an int32 tensor on the device (`count`): the kernel's
grid covers the whole list and the positions past the length return at
once, so the loop never reads the length on the host.  The kernel has
three paths, a group of lanes per subset for small subsets, a block per
subset for large ones, and for very large ones (a blob) several blocks a
subset whose partial sums a second pass adds in a fixed order;
`subset_threads` and `subset_chunks` pick one from the padded pixel
count, and the plain version sums the Gram in that path's order
(`kernel_order_sum`), so the two agree bit for bit.  A tile too big for
shared memory (`tile_in_shared`) is read from the image in memory, with
the same sums.
"""

from __future__ import annotations

import ctypes

import torch

from correlation_tpu_torch.config import FittingModel, Interpolation
from correlation_tpu_torch.models.warp import steepest_descent, warp_points
from correlation_tpu_torch.ops import solve

# Rows of the per-subset pixel array [S, 8, P].
ROW_X = 0
ROW_Y = 1
ROW_MASK = 2
ROW_DXC = 3  # x - center_x
ROW_DYC = 4  # y - center_y
ROW_UND = 5  # undeformed intensities, rows 5 .. 5 + C (C <= 3)

# Kernel launches by fused_assemble (CUDA tensors only), in all, and by
# shape: {(p_len, tile_h, tile_w): [launches, list positions launched]}.
# The second counter is the list's capacity, not its work: where the
# list's length stays on the device (`count`) the launch covers every
# position and those past the length exit at once.  The steps that
# ops/solve.lm_level's graphs ran are added by ops/solve.resolve_launches.
# Callers reset them with reset_launches().
LAUNCHES = 0
LAUNCHES_BY_SHAPE: dict[tuple[int, int, int], list[int]] = {}

# The kernel's paths (csrc/fused_assemble.cu): subsets of at most
# WARP_MAX_PIXELS padded pixels take WARP_LANES lanes of a warp each (the
# warp path; kWarpLanes there), larger ones a block of BLOCK_THREADS
# threads (kBlockThreads; the block path).  The path fixes the order of
# the Gram sums, so the plain version follows the same rule.
WARP_MAX_PIXELS = 128
WARP_LANES = 16
BLOCK_THREADS = 64
# The split path (kChunkMin, kChunkPixels): a subset of more than
# CHUNK_MIN_PIXELS padded pixels is cut into spans of CHUNK_PIXELS (the
# last ragged), a block of BLOCK_THREADS each, and the spans' sums are
# added in span order.  The rule reads the padded length alone, so a
# subset's sums never depend on which other subsets are assembled.
CHUNK_MIN_PIXELS = 2048
CHUNK_PIXELS = 512


def subset_threads(p_len: int) -> int:
    """Threads that assemble one subset of `p_len` padded pixels:
    WARP_LANES (the warp path) or BLOCK_THREADS (the block and split
    paths)."""
    return WARP_LANES if p_len <= WARP_MAX_PIXELS else BLOCK_THREADS


def subset_chunks(p_len: int) -> int:
    """Spans a subset of `p_len` padded pixels is cut into: 1 up to
    CHUNK_MIN_PIXELS, else ceil(p_len / CHUNK_PIXELS) (the split path)."""
    return 1 if p_len <= CHUNK_MIN_PIXELS else -(-p_len // CHUNK_PIXELS)


def subset_span(p_len: int, chunk: int | None = None) -> int:
    """Pixels a block sums: `chunk`, by default the rule's, at most p_len."""
    if chunk is None:
        chunk = CHUNK_PIXELS if subset_chunks(p_len) > 1 else p_len
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return min(chunk, p_len)


def span_workspace(n: int, num_params: int, spans: int,
                   device) -> torch.Tensor | None:
    """The split path's float32 workspace for n subsets of `spans` spans
    (a row of the model's Gram products a span), or None for one block a
    subset."""
    if spans == 1:
        return None
    rows = num_params + 2
    return torch.empty(n * spans * rows * (rows + 1) // 2,
                       dtype=torch.float32, device=device)


def tile_in_shared(tile_h: int, tile_w: int, channels: int, threads: int,
                   chunks: int = 1) -> bool:
    """Whether the kernel's launcher stages a subset's tile in shared
    memory on the path of `threads` threads a subset (subset_threads) and
    `chunks` spans (subset_chunks; the split path never does).  Otherwise
    the kernel reads the tile from the padded image in memory, with the
    same sums.  Asks the built kernel library, so it needs the CUDA
    toolkit."""
    from correlation_tpu_torch.ops._build import load_library

    rc = load_library().fused_assemble_tile_in_shared(
        int(channels), int(threads), int(chunks), int(tile_h), int(tile_w))
    if rc < 0:
        raise ValueError(f"no kernel path for {channels} channels, "
                         f"{threads} threads a subset and {chunks} spans")
    return bool(rc)


def reset_launches() -> None:
    """Zero LAUNCHES and LAUNCHES_BY_SHAPE, after
    ops/solve.resolve_launches() has added the steps that graphs launched
    before ran."""
    global LAUNCHES
    solve.resolve_launches()
    LAUNCHES = 0
    LAUNCHES_BY_SHAPE.clear()


def _taps_halo(interp: Interpolation) -> tuple[int, int]:
    return (4, 1) if interp == Interpolation.BICUBIC else (2, 0)


def subset_bbox(xy: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[S, 4, 2] axis-aligned bounding-box corners of each subset."""
    big = 1e9
    m = mask[..., None]
    mins = torch.where(m, xy, torch.full_like(xy, big)).amin(dim=1)
    maxs = torch.where(m, xy, torch.full_like(xy, -big)).amax(dim=1)
    return torch.stack(
        [
            mins,
            torch.stack([mins[..., 0], maxs[..., 1]], -1),
            torch.stack([maxs[..., 0], mins[..., 1]], -1),
            maxs,
        ],
        dim=1,
    )


def pack_pixels(xy, mask, und_w, center) -> torch.Tensor:
    """[S, 5 + max(C, 3), P] float32 rows x, y, mask, x - cx, y - cy, und
    per channel (zero rows for missing channels).  und_w: [S, P, C].  The
    kernel takes C <= 3, so 8 rows; the coefficient-field assembly
    (ops/assemble.py) takes any C."""
    channels = und_w.shape[-1]
    maskf = mask.to(torch.float32)
    und_rows = [und_w[..., c] for c in range(channels)]
    und_rows += [torch.zeros_like(maskf)] * (3 - channels)
    return torch.stack(
        [
            xy[..., 0],
            xy[..., 1],
            maskf,
            xy[..., 0] - center[:, 0:1],
            xy[..., 1] - center[:, 1:2],
        ]
        + und_rows,
        dim=1,
    ).contiguous()


def compute_origins(
    model: FittingModel,
    interp: Interpolation,
    bbox: torch.Tensor,
    center: torch.Tensor,
    params: torch.Tensor,
    padded_h: int,
    padded_w: int,
    tile_h: int,
    tile_w: int,
) -> torch.Tensor:
    """[S, 2] int64 tile origins (y0, x0) from the warped bounding box."""
    corners = warp_points(model, params, bbox, center)  # [S, 4, 2]
    _, halo = _taps_halo(interp)
    min_xy = torch.floor(corners.amin(dim=1)) - (halo + 1)
    finite = torch.isfinite(corners).all(dim=2).all(dim=1)
    zero = torch.zeros_like(min_xy[:, 0])
    x0 = torch.where(finite, min_xy[:, 0], zero)
    y0 = torch.where(finite, min_xy[:, 1], zero)
    x0 = x0.clamp(0, max(padded_w - tile_w, 0))
    y0 = y0.clamp(0, max(padded_h - tile_h, 0))
    return torch.stack([y0, x0], dim=-1).long()


def choose_tile(
    extent_y: int,
    extent_x: int,
    padded_h: int,
    padded_w: int,
    margin: int = 8,
) -> tuple[int, int]:
    """Tile dims covering the subset extent + spline halo + warp margin,
    rounded up to multiples of 8 and capped at the padded image."""
    need_h = extent_y + 4 + margin
    need_w = extent_x + 4 + margin
    th = min(-(-need_h // 8) * 8, padded_h)
    tw = min(-(-need_w // 8) * 8, padded_w)
    return int(th), int(tw)


def prepare_image(img: torch.Tensor, tile_h: int, tile_w: int) -> torch.Tensor:
    """Zero-pad [..., H, W, C] to at least (tile_h, tile_w); contiguous f32."""
    pad_h = max(tile_h - img.shape[-3], 0)
    pad_w = max(tile_w - img.shape[-2], 0)
    img = img.to(torch.float32)
    if pad_h or pad_w:
        img = torch.nn.functional.pad(img, (0, 0, 0, pad_w, 0, pad_h))
    return img.contiguous()


def _cubic_taps(t):
    """Catmull-Rom value and derivative taps at offsets -1..2 (Horner)."""
    k = (
        ((-0.5 * t + 1.0) * t - 0.5) * t,
        (1.5 * t - 2.5) * t * t + 1.0,
        ((-1.5 * t + 2.0) * t + 0.5) * t,
        (0.5 * t - 0.5) * t * t,
    )
    dk = (
        (-1.5 * t + 2.0) * t - 0.5,
        (4.5 * t - 5.0) * t,
        (-4.5 * t + 4.0) * t + 0.5,
        (1.5 * t - 1.0) * t,
    )
    return k, dk


def _interp_taps(interp, tx, ty, xd, yd, img_h, img_w):
    """(valid, kx, dkx, ky, dky) per interpolation model."""
    if interp == Interpolation.BICUBIC:
        valid = (xd > 1.0) & (yd > 1.0) & (xd < img_w - 2.0) & (yd < img_h - 2.0)
        kx, dkx = _cubic_taps(tx)
        ky, dky = _cubic_taps(ty)
        return valid, kx, dkx, ky, dky
    one = torch.ones_like(tx)
    zero = torch.zeros_like(tx)
    valid = (xd > 0.0) & (yd > 0.0) & (xd < img_w - 1.0) & (yd < img_h - 1.0)
    if interp == Interpolation.BILINEAR:
        kx = (1.0 - tx, tx)
        ky = (1.0 - ty, ty)
    else:  # NEAREST: value at the rounded pixel, forward differences
        kx = (one, zero)
        ky = (one, zero)
    return valid, kx, (-one, one), ky, (-one, one)


def fused_assemble_reference(
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
    bbox: torch.Tensor,
    idx: torch.Tensor | None = None,
    threads: int | None = None,
    chunk: int | None = None,
    count: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch fused assembly; same arguments as fused_assemble.
    The Gram sums follow the order of `threads` threads a subset over
    spans of `chunk` pixels, by default the kernel's path for this p_len
    (subset_threads, subset_chunks); chunk=p_len sums each subset whole.
    With `count` it assembles idx[:count] and returns all of idx's rows,
    zero past the length."""
    if count is not None:
        whole = torch.zeros((idx.shape[0], 8, 8), dtype=torch.float32,
                            device=img.device)
        live = int(count)
        whole[:live] = fused_assemble_reference(
            model, interp, tile_h, tile_w, img_h, img_w, img, pix, center,
            params, bbox, idx[:live], threads, chunk)
        return whole
    if idx is not None:
        sel = idx.long()
        pix, center, params, bbox = pix[sel], center[sel], params[sel], bbox[sel]
    if pix.shape[0] == 0:
        return torch.zeros((0, 8, 8), dtype=torch.float32, device=img.device)
    hp, wp, channels = img.shape
    taps, halo = _taps_halo(interp)

    # dx, dy inside warp_points round exactly as the ROW_DXC / ROW_DYC rows
    # the kernel reads (the same float32 subtraction).
    xy = pix[:, ROW_X : ROW_Y + 1].transpose(1, 2)  # [n, P, 2]
    maskf = pix[:, ROW_MASK]
    xd, yd = warp_points(model, params, xy, center).unbind(-1)
    ax = torch.floor(xd)
    ay = torch.floor(yd)
    tx = xd - ax
    ty = yd - ay
    valid, kx, dkx, ky, dky = _interp_taps(interp, tx, ty, xd, yd, img_h, img_w)
    if interp == Interpolation.NEAREST:
        ax = torch.floor(xd + 0.5)
        ay = torch.floor(yd + 0.5)
    org = compute_origins(
        model, interp, bbox, center, params, hp, wp, tile_h, tile_w
    ).to(torch.float32)
    rxf = ax - halo - org[:, 1:2]
    ryf = ay - halo - org[:, 0:1]
    in_tile = (
        (rxf >= 0) & (rxf <= tile_w - taps) & (ryf >= 0) & (ryf <= tile_h - taps)
    )
    ok = (valid & in_tile).to(torch.float32)
    zero = torch.zeros_like(rxf)
    rx = torch.where(torch.isfinite(rxf), rxf, zero).clamp(0, tile_w - taps).long()
    ry = torch.where(torch.isfinite(ryf), ryf, zero).clamp(0, tile_h - taps).long()
    # Flat image index of each pixel's stencil corner (tile origin + offset).
    base = (org[:, 0:1].long() + ry) * wp + org[:, 1:2].long() + rx  # [n, P]
    flat = img.reshape(hp * wp, channels)

    live = maskf * ok
    bad = maskf * (1.0 - ok)
    zrow = torch.zeros_like(bad)
    gs = []
    for c in range(channels):
        tmp, tmp_d = [], []
        for k in range(taps):
            t = td = None
            for j in range(taps):
                val = flat[base + (j * wp + k), c]
                t = ky[j] * val if t is None else t + ky[j] * val
                td = dky[j] * val if td is None else td + dky[j] * val
            tmp.append(t)
            tmp_d.append(td)
        w_v = kx[0] * tmp[0]
        dwdx = dkx[0] * tmp[0]
        dwdy = kx[0] * tmp_d[0]
        for k in range(1, taps):
            w_v = w_v + kx[k] * tmp[k]
            dwdx = dwdx + dkx[k] * tmp[k]
            dwdy = dwdy + kx[k] * tmp_d[k]
        dwdx = dwdx * live
        dwdy = dwdy * live
        v = (pix[:, ROW_UND + c] - w_v) * live
        h = steepest_descent(model, xy, center, dwdx, dwdy)  # [n, P, NP]
        rows = list(h.unbind(-1)) + [v, bad if c == 0 else zrow]
        gs.append(torch.stack(rows, dim=1))  # [n, R, P]
    g = torch.stack(gs, dim=-1)  # [n, R, P, C], R = NP + 2
    r = g.shape[1]
    iu, ju = torch.triu_indices(r, r, device=g.device)
    p_len = pix.shape[2]
    threads = subset_threads(p_len) if threads is None else threads
    sums = kernel_order_sum(g[:, iu] * g[:, ju], threads,
                            subset_span(p_len, chunk))  # upper triangle
    out = torch.zeros((g.shape[0], 8, 8), dtype=torch.float32, device=g.device)
    out[:, iu, ju] = sums
    out[:, ju, iu] = sums
    return out


def kernel_order_sum(prod: torch.Tensor, threads: int,
                     chunk: int | None = None) -> torch.Tensor:
    """Sum [n, K, P, C] over pixels and channels in the CUDA kernel's order
    for `threads` threads a subset (16, or a multiple of 32), so the plain
    version and the kernel agree bit for bit: thread t accumulates pixels
    t, t + threads, ... (channels inner), each warp (or group of 16 lanes)
    folds its lanes by a butterfly (lanes 16 apart first, then 8, ..., the
    tree of a __shfl_down reduction), and the warps' sums add in warp
    order.  With `chunk` below P (the split path), each span of `chunk`
    pixels is summed so, from its own first pixel, and the spans' sums
    add in span order."""
    n, k, p, c = prod.shape
    if chunk is not None and chunk < p:
        spans = -(-p // chunk)
        prod = torch.nn.functional.pad(prod, (0, 0, 0, spans * chunk - p))
        parts = kernel_order_sum(prod.reshape(n, k * spans, chunk, c),
                                 threads).reshape(n, k, spans)
        total = parts[..., 0]
        for j in range(1, spans):
            total = total + parts[..., j]
        return total
    pad = -p % threads
    if pad:
        prod = torch.nn.functional.pad(prod, (0, 0, 0, pad))
    x = prod.reshape(n, k, -1, threads, c)
    acc = torch.zeros((n, k, threads), dtype=prod.dtype, device=prod.device)
    for j in range(x.shape[2]):
        for ch in range(c):
            acc = acc + x[:, :, j, :, ch]
    group = min(threads, 32)
    lanes = acc.reshape(n, k, threads // group, group)
    off = group // 2
    while off:
        lanes = lanes[..., :off] + lanes[..., off : 2 * off]
        off //= 2
    warps = lanes[..., 0]
    total = warps[..., 0]
    for w in range(1, warps.shape[-1]):
        total = total + warps[..., w]
    return total


def _check_inputs(img, pix, center, params, bbox, idx, tile_h, tile_w,
                  count=None):
    dev = img.device
    named = {"img": img, "pix": pix, "center": center, "params": params,
             "bbox": bbox}
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, img on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if img.dim() != 3 or not 1 <= img.shape[2] <= 3:
        raise ValueError(f"img must be [H, W, C<=3], got {tuple(img.shape)}")
    if img.shape[0] < tile_h or img.shape[1] < tile_w:
        raise ValueError(
            f"image {tuple(img.shape[:2])} smaller than tile "
            f"({tile_h}, {tile_w}); pad it with prepare_image"
        )
    s = params.shape[0]
    if params.dim() != 2 or params.shape[1] not in (1, 2, 3, 6):
        raise ValueError(f"params must be [S, NP], got {tuple(params.shape)}")
    if pix.dim() != 3 or pix.shape[0] != s or pix.shape[1] != 8:
        raise ValueError(f"pix must be [S, 8, P], got {tuple(pix.shape)}")
    if tuple(center.shape) != (s, 2):
        raise ValueError(f"center must be [S, 2], got {tuple(center.shape)}")
    if tuple(bbox.shape) != (s, 4, 2):
        raise ValueError(f"bbox must be [S, 4, 2], got {tuple(bbox.shape)}")
    if idx is not None:
        if idx.dtype != torch.int32 or idx.dim() != 1:
            raise TypeError("idx must be a 1-D int32 tensor")
        if idx.device != dev or not idx.is_contiguous():
            raise ValueError("idx must be contiguous and on the image device")
    if count is not None:
        if idx is None:
            raise ValueError("count needs an index list")
        if count.dtype != torch.int32 or tuple(count.shape) != (1,):
            raise TypeError("count must be an int32 tensor of shape [1]")
        if count.device != dev:
            raise ValueError("count must be on the image device")
        # On the card the kernel checks every index itself (a host check
        # would cost a sync per assembly); on the CPU a negative index
        # would wrap silently, so check here.
        if dev.type == "cpu" and idx.numel():
            lo, hi = (int(v) for v in torch.aminmax(idx))
            if lo < 0 or hi >= s:
                raise IndexError(f"idx spans [{lo}, {hi}], outside [0, {s})")


def fused_assemble(
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
    bbox: torch.Tensor,
    idx: torch.Tensor | None = None,
    count: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused assembly of the subsets `idx` (all when None) -> [n, 8, 8].

    img: [Hp, Wp, C] float32 deformed image, padded by prepare_image;
    img_h, img_w: its true dims (validity windows).  pix: [S, 8, P]
    (pack_pixels); center [S, 2]; params [S, NP]; bbox [S, 4, 2]
    (subset_bbox); idx: int32 [n] subset indices; count: optional int32
    [1] on the device, the list's length: only idx[:count] are assembled
    (the kernel's rows past it are left unwritten, the plain version's
    zero), with no host read of the length.

    CUDA tensors launch the CUDA kernel; CPU tensors run
    fused_assemble_reference.  Anything else raises.  An index outside
    [0, S) raises IndexError on the CPU; on the card it stops the kernel
    like a device-side assert, and the next synchronising call raises.
    """
    _check_inputs(img, pix, center, params, bbox, idx, tile_h, tile_w,
                  count)
    if img.device.type == "cpu":
        return fused_assemble_reference(
            model, interp, tile_h, tile_w, img_h, img_w, img, pix, center,
            params, bbox, idx, count=count,
        )
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    from correlation_tpu_torch.ops._build import check_launch, load_library

    lib = load_library()
    n = params.shape[0] if idx is None else idx.shape[0]
    out = torch.empty((n, 8, 8), dtype=torch.float32, device=img.device)
    if n == 0:
        return out
    args, work = launch_args(model, interp, tile_h, tile_w, img_h, img_w,
                             img, pix, center, params, bbox, idx, count, out)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    rc = lib.fused_assemble_launch(*args, ctypes.c_void_p(stream))
    check_launch(rc, "fused_assemble")
    count_launches(pix.shape[2], tile_h, tile_w, n)
    return out


def launch_args(model, interp, tile_h, tile_w, img_h, img_w, img, pix,
                center, params, bbox, idx, count, out):
    """(the kernel library's fused_assemble_launch arguments but the
    stream, the split path's workspace or None): K1 over the list idx
    (all subsets when None) of length count into `out` [n, 8, 8], n > 0,
    on the inputs fused_assemble has checked.  The arguments point into
    the workspace: hold it until the launch is enqueued."""
    n = out.shape[0]
    hp, wp, channels = img.shape
    p_len = pix.shape[2]
    work = span_workspace(n, params.shape[1], subset_chunks(p_len),
                          img.device)
    ptr = ctypes.c_void_p
    return (
        int(model), int(interp), channels, subset_threads(p_len),
        0,  # the launcher's split rule (kChunkMin, kChunkPixels)
        ptr(img.data_ptr()), hp, wp, int(img_h), int(img_w),
        ptr(pix.data_ptr()), p_len,
        ptr(center.data_ptr()), ptr(params.data_ptr()), ptr(bbox.data_ptr()),
        ptr(idx.data_ptr() if idx is not None else None),
        ptr(count.data_ptr() if count is not None else None), n,
        params.shape[0],
        int(tile_h), int(tile_w),
        ptr(work.data_ptr() if work is not None else None),
        0 if work is None else work.numel(), ptr(out.data_ptr()),
    ), work


def count_launches(p_len: int, tile_h: int, tile_w: int, n: int,
                   launches: int = 1) -> None:
    """Add `launches` launches over n list positions of subsets of p_len
    padded pixels and (tile_h, tile_w) tiles to LAUNCHES and
    LAUNCHES_BY_SHAPE."""
    global LAUNCHES
    LAUNCHES += launches
    counts = LAUNCHES_BY_SHAPE.setdefault((p_len, int(tile_h), int(tile_w)),
                                          [0, 0])
    counts[0] += launches
    counts[1] += launches * n
