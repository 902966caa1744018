"""The CUDA fused assembly against its plain PyTorch version, on the card.

The plain version sums the Gram in the kernel's order and both round every
per-pixel operation alike, so the kernel must equal it bit for bit, on
the warp path (at most assemble_v2.WARP_MAX_PIXELS padded pixels a
subset), on the block path (more) and on the split path (more than
assemble_v2.CHUNK_MIN_PIXELS: several blocks a subset, their partial
sums added in span order).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from correlation_tpu_torch import correlate, make_batch
from correlation_tpu_torch.config import (
    NUM_PARAMS,
    FittingModel,
    Interpolation,
    PyramidConfig,
    SolverConfig,
)
from correlation_tpu_torch.ops import assemble_v2 as v2
from correlation_tpu_torch.ops import solve
from correlation_tpu_torch.ops.pyramid import build_pyramid
from correlation_tpu_torch.problems import speckle

pytestmark = pytest.mark.cuda

GRID = [
    (FittingModel.AFFINE, Interpolation.BICUBIC),
    (FittingModel.UV, Interpolation.BILINEAR),
    (FittingModel.UVQ, Interpolation.BICUBIC),
    (FittingModel.U, Interpolation.NEAREST),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


# Padded pixels a subset: 169 (block path) and 81 (warp path).
SIDES = {"block": 13, "warp": 9}


def _args(model, interp, channels, dev, s=40, side=13, p_len=None,
          tile=None, hw=(120, 150)):
    """Subsets of the first p_len (default side^2) points of a side x side
    grid, one reaching past the left edge; tile (th, tw) by default from
    the extent."""
    h, w = hw
    p_len = side * side if p_len is None else p_len
    rng = np.random.default_rng(int(model) * 10 + channels + p_len)
    img = np.stack([speckle(h, w, 1) * f
                    for f in (1.0, 0.8, 0.6)[:channels]], -1)
    half = side // 2
    xy = np.zeros((s, p_len, 2), np.float32)
    for i in range(s):
        cx = rng.integers(half + 2, w - half - 2)
        cy = rng.integers(half + 2, h - half - 2)
        if i == 0:
            cx, cy = half - 2, h // 2  # reaches past the left edge
        gx, gy = np.meshgrid(np.arange(cx - half, cx - half + side),
                             np.arange(cy - half, cy - half + side),
                             indexing="ij")
        xy[i] = np.stack([gx.ravel(), gy.ravel()], -1)[:p_len]
    mask = rng.random((s, p_len)) > 0.1
    center = xy.mean(axis=1).astype(np.float32)
    und = img[np.clip(xy[..., 1], 0, h - 1).astype(int),
              np.clip(xy[..., 0], 0, w - 1).astype(int)]
    num_p = NUM_PARAMS[model]
    params = rng.normal(0, 0.05, (s, num_p)).astype(np.float32)
    params[:, :2] += rng.normal(0, 2.0, (s, min(2, num_p)))
    params[0, 0] = -2.0  # subset 0 reaches further past the left edge

    def t(a):
        return torch.as_tensor(a, device=dev)

    th, tw = tile or v2.choose_tile(side - 1, side - 1, h, -(-w // 8) * 8)
    xy_t, mask_t, center_t = t(xy), t(mask), t(center)
    return (model, interp, th, tw, h, w, v2.prepare_image(t(img), th, tw),
            v2.pack_pixels(xy_t, mask_t, t(und), center_t), center_t,
            t(params), v2.subset_bbox(xy_t, mask_t))


def _assert_equal_plain(args, idx=None):
    got = v2.fused_assemble(*args, idx)
    ref = v2.fused_assemble_reference(*args, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), (got - ref).abs().max()
    return got


@pytest.mark.parametrize("path", sorted(SIDES))
@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("model,interp", GRID)
def test_kernel_equals_plain(dev, model, interp, channels, path):
    args = _args(model, interp, channels, dev, side=SIDES[path])
    block = v2.subset_threads(args[7].shape[2]) == v2.BLOCK_THREADS
    assert block == (path == "block")
    got = v2.fused_assemble(*args)
    again = v2.fused_assemble(*args)
    ref = v2.fused_assemble_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # repeatable run to run
    assert torch.equal(got, ref)
    assert got[0, NUM_PARAMS[model] + 1, NUM_PARAMS[model] + 1] > 0


@pytest.mark.parametrize("path", sorted(SIDES))
def test_index_list_on_card(dev, path):
    args = _args(FittingModel.AFFINE, Interpolation.BICUBIC, 1, dev,
                 side=SIDES[path])
    full = v2.fused_assemble(*args)
    for rows in ([5, 0, 39, 5], [17], [3, 3, 3, 3, 3, 3, 3]):
        idx = torch.tensor(rows, dtype=torch.int32, device=dev)
        part = _assert_equal_plain(args, idx)
        assert torch.equal(part, full[idx.long()])
    empty = v2.fused_assemble(*args, idx[:0])
    assert empty.shape == (0, 8, 8)


@pytest.mark.parametrize("p_len", [1, 33, 129, 448, 600])
def test_ragged_pixel_counts(dev, p_len):
    """Pixel counts on both sides of the path threshold, none a multiple
    of the threads; 600 is more pixels than the bench's level 0."""
    side = int(np.ceil(np.sqrt(p_len)))
    for model, interp in GRID[:2]:
        args = _args(model, interp, 1, dev, s=9, side=side, p_len=p_len)
        _assert_equal_plain(args)


@pytest.mark.parametrize("s", [1, 3, 5, 7, 9])
@pytest.mark.parametrize("path", sorted(SIDES))
def test_subset_counts(dev, path, s):
    """Subset counts that are no multiple of the subsets a block."""
    args = _args(FittingModel.UVQ, Interpolation.BICUBIC, 2, dev, s=s,
                 side=SIDES[path])
    _assert_equal_plain(args)


@pytest.mark.parametrize("path", sorted(SIDES))
def test_tile_near_shared_memory_limit(dev, path):
    """A 224 x 224 tile (196 KB) with its pixel rows: one subset a block
    on the warp path."""
    args = _args(FittingModel.AFFINE, Interpolation.BICUBIC, 1, dev, s=6,
                 side=SIDES[path], tile=(224, 224), hw=(240, 240))
    got = _assert_equal_plain(args)
    assert got[0, 7, 7] > 0


# Shared memory a block may give its subsets (csrc/fused_assemble.cu:
# kMaxSmem less the reduction's AFFINE slots, 36 floats for each of the
# block path's 2 warps or the warp path's 8 lane groups).
SMEM_BUDGET = {"block": 227 * 1024 - 4 * 36 * 2,
               "warp": 227 * 1024 - 4 * 36 * 8}
# Tiles that fit in that budget alone but not with the subset's pixel
# rows beside them, so the kernel reads the rows from memory.
ROWLESS_TILES = {"block": (240, 240), "warp": (240, 239)}


def _tile_and_rows_bytes(tile, p_len, c=1):
    """Shared-memory bytes of a tile and of a subset's pixel rows, as the
    kernel lays them out (tile rows an odd pitch apart, each region a
    multiple of 4 floats)."""
    th, tw = tile
    return (-(-th * ((tw * c) | 1) // 4) * 16,
            -(-(5 + c) * p_len // 4) * 16)


@pytest.mark.parametrize("path", sorted(SIDES))
def test_rows_read_from_memory_beside_a_big_tile(dev, path):
    tile, rows = _tile_and_rows_bytes(ROWLESS_TILES[path], SIDES[path] ** 2)
    assert tile <= SMEM_BUDGET[path] < tile + rows
    args = _args(FittingModel.AFFINE, Interpolation.BICUBIC, 1, dev, s=6,
                 side=SIDES[path], tile=ROWLESS_TILES[path], hw=(256, 256))
    got = _assert_equal_plain(args)
    assert got[0, 7, 7] > 0


# The global-tile path: tiles that do not fit in shared memory even alone
# (the kernel reads them from the padded image in memory).
GLOBAL_TILES = [248, 320, 1024]
GLOBAL_CASES = [(m, i, 1) for m, i in GRID] + [
    (FittingModel.AFFINE, Interpolation.BICUBIC, 3)]


def test_tile_in_shared_is_the_launchers_rule(dev):
    """The launcher's placement: at C = 1 a 240 x 240 tile still fits on
    the block path and 248 x 248 does not; on each path and channel count
    a widening tile leaves shared memory once; an unsupported path
    raises."""
    block, warp = v2.BLOCK_THREADS, v2.WARP_LANES
    assert v2.tile_in_shared(240, 240, 1, block)
    assert not v2.tile_in_shared(248, 248, 1, block)
    assert v2.tile_in_shared(32, 32, 3, warp)
    assert not v2.tile_in_shared(320, 320, 3, warp)
    for c in (1, 2, 3):
        for threads in (block, warp):
            fits = [v2.tile_in_shared(240, w, c, threads)
                    for w in range(8, 1030, 8)]
            assert fits[0] and not fits[-1]
            assert fits == sorted(fits, reverse=True)  # one switch
    with pytest.raises(ValueError):
        v2.tile_in_shared(64, 64, 1, 32)
    with pytest.raises(ValueError):
        v2.tile_in_shared(64, 64, 4, block)
    # The split path reads every tile from memory, on the block's threads.
    assert not v2.tile_in_shared(32, 32, 1, block, 2)
    with pytest.raises(ValueError):
        v2.tile_in_shared(32, 32, 1, warp, 2)
    with pytest.raises(ValueError):
        v2.tile_in_shared(32, 32, 1, block, 0)


@pytest.mark.parametrize("tile", GLOBAL_TILES)
@pytest.mark.parametrize("path", sorted(SIDES))
@pytest.mark.parametrize("case", range(len(GLOBAL_CASES)))
def test_global_tile_equals_plain(dev, case, path, tile):
    """Every model and interpolation at C = 1, and C = 3 at one, on both
    paths: the whole list, 1-9 subsets of it and an index list with
    repeats, bit for bit with the plain version, run to run."""
    model, interp, channels = GLOBAL_CASES[case]
    args = _args(model, interp, channels, dev, s=9, side=SIDES[path],
                 tile=(tile, tile), hw=(tile + 8, tile + 8))
    threads = v2.subset_threads(args[7].shape[2])
    assert (threads == v2.BLOCK_THREADS) == (path == "block")
    assert not v2.tile_in_shared(tile, tile, channels, threads)
    v2.reset_launches()
    got = _assert_equal_plain(args)
    assert torch.equal(got, v2.fused_assemble(*args))
    assert v2.LAUNCHES == 2
    num_p = NUM_PARAMS[model]
    assert got[0, num_p + 1, num_p + 1] > 0
    for k in range(1, 10):
        _assert_equal_plain(args, torch.arange(k, dtype=torch.int32,
                                               device=dev))
    idx = torch.tensor([5, 0, 8, 5, 5, 2], dtype=torch.int32, device=dev)
    assert torch.equal(_assert_equal_plain(args, idx), got[idx.long()])


# The split path: 2049 padded pixels (5 spans, the last of one pixel,
# 4-byte copies) and 2304 (the last of 256, 16-byte copies), with tiles
# that fit in shared memory (from the extent) and that do not.
SPLIT_PIXELS = [2049, 2304]
SPLIT_TILES = {"fits": None, "too big": 320}


@pytest.mark.parametrize("tile", sorted(SPLIT_TILES))
@pytest.mark.parametrize("p_len", SPLIT_PIXELS)
@pytest.mark.parametrize("case", range(len(GLOBAL_CASES)))
def test_split_equals_plain(dev, case, p_len, tile):
    """Every model and interpolation at C = 1, and C = 3 at one: the whole
    list, 1-9 subsets of it and an index list with repeats, bit for bit
    with the plain version, run to run; and in one block a subset."""
    model, interp, channels = GLOBAL_CASES[case]
    size = SPLIT_TILES[tile]
    args = _args(model, interp, channels, dev, s=9, side=48, p_len=p_len,
                 tile=size and (size, size),
                 hw=(size + 8, size + 8) if size else (120, 150))
    spans = v2.subset_chunks(p_len)
    assert spans == -(-p_len // v2.CHUNK_PIXELS) > 1
    th, tw = args[2:4]
    assert v2.tile_in_shared(th, tw, channels, v2.BLOCK_THREADS) == (
        size is None)
    assert not v2.tile_in_shared(th, tw, channels, v2.BLOCK_THREADS, spans)
    v2.reset_launches()
    got = _assert_equal_plain(args)
    assert torch.equal(got, v2.fused_assemble(*args))
    assert v2.LAUNCHES == 2
    num_p = NUM_PARAMS[model]
    assert got[0, num_p + 1, num_p + 1] > 0
    for k in range(1, 10):
        _assert_equal_plain(args, torch.arange(k, dtype=torch.int32,
                                               device=dev))
    idx = torch.tensor([5, 0, 8, 5, 5, 2], dtype=torch.int32, device=dev)
    assert torch.equal(_assert_equal_plain(args, idx), got[idx.long()])
    one = _span_design(p_len)(*args)
    assert torch.equal(one, v2.fused_assemble_reference(*args, chunk=p_len))


def _span_design(chunk):
    """The kernel library's launcher at spans of `chunk` pixels (at p_len
    or more: one block a subset), as the design sweep runs it."""
    from correlation_tpu_torch.experiments.design_sweep import k1_design
    from correlation_tpu_torch.ops._build import load_library

    return k1_design(load_library(), f"K1 chunk {chunk}", v2.BLOCK_THREADS,
                     chunk)


@pytest.mark.parametrize("chunk", [64, 100, 512, 2048, 2304, 4096])
def test_any_span_length_equals_plain(dev, chunk):
    """The launcher's span length (100: not whole rounds of the threads,
    4-byte copies; 2048: a 48 KB staging request); at p_len or more, one
    block a subset."""
    args = _args(FittingModel.AFFINE, Interpolation.BICUBIC, 1, dev, s=5,
                 side=48, p_len=2304)
    got = _span_design(chunk)(*args)
    ref = v2.fused_assemble_reference(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_split_path_replays_from_a_cuda_graph(dev):
    """The workspace comes from the caching allocator and the second pass
    is a kernel of its own, so a captured assembly replays exactly."""
    args = _args(FittingModel.AFFINE, Interpolation.BICUBIC, 1, dev, s=4,
                 side=48, p_len=2304)
    ref = v2.fused_assemble_reference(*args)
    v2.fused_assemble(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = v2.fused_assemble(*args)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


def _trap_code(side, tile=None, hw=(120, 150)):
    """A script that assembles a valid index and then one outside [0, S)."""
    return (
        "import torch, tests_gpu.test_kernels_gpu as t\n"
        "from correlation_tpu_torch.ops import assemble_v2 as v2\n"
        "dev = torch.device('cuda')\n"
        "args = t._args(t.FittingModel.AFFINE, t.Interpolation.BICUBIC, 1,"
        f" dev, side={side}, tile={tile}, hw={hw})\n"
        "ok = torch.tensor([39], dtype=torch.int32, device=dev)\n"
        "v2.fused_assemble(*args, ok); torch.cuda.synchronize()\n"
        "print('valid index ok', flush=True)\n"
        "bad = torch.tensor([0, 40], dtype=torch.int32, device=dev)\n"
        "v2.fused_assemble(*args, bad); torch.cuda.synchronize()\n"
        "print('out-of-range index passed', flush=True)\n"
    )


def _assert_traps(code):
    # The kernel checks each index against S and traps, which leaves the
    # CUDA context unusable: run it in a process of its own.
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert "valid index ok" in proc.stdout, proc.stderr
    assert "out-of-range index passed" not in proc.stdout
    assert proc.returncode != 0


@pytest.mark.parametrize("path", sorted(SIDES))
def test_index_out_of_range_stops_kernel(dev, path):
    _assert_traps(_trap_code(SIDES[path]))


@pytest.mark.parametrize("path", sorted(SIDES))
def test_index_out_of_range_stops_kernel_on_global_tile(dev, path):
    assert not v2.tile_in_shared(320, 320, 1, v2.WARP_LANES)
    _assert_traps(_trap_code(SIDES[path], (320, 320), (328, 328)))


def test_index_out_of_range_stops_kernel_on_split_path(dev):
    assert v2.subset_chunks(48 * 48) > 1
    _assert_traps(_trap_code(48))


def test_backend_must_match_device(dev):
    img = speckle(64, 64, 3)
    pyr = [a.to(dev) for a in build_pyramid(torch.as_tensor(img[..., None]),
                                            0)]
    pts = [np.stack(np.meshgrid(np.arange(22, 43), np.arange(22, 43),
                                indexing="ij"), -1).reshape(-1, 2)]
    cfg = SolverConfig(pyramid=PyramidConfig(0, 1, 0), backend="torch")
    with pytest.raises(ValueError):
        correlate(cfg, pyr, pyr, make_batch(pts, None, 0),
                  np.zeros((1, 6), np.float32))


def test_correlate_on_card_equals_cpu(dev):
    img = speckle(96, 96, 5)
    dfm = np.roll(img, 1, axis=0)
    und_pyr = build_pyramid(torch.as_tensor(img[..., None]), 2)
    def_pyr = build_pyramid(torch.as_tensor(dfm[..., None]), 2)
    pts = [
        np.stack(np.meshgrid(np.arange(cx - 8, cx + 9),
                             np.arange(cy - 8, cy + 9), indexing="ij"),
                 -1).reshape(-1, 2)
        for cx in (30, 48, 66) for cy in (30, 48, 66)
    ]
    batch = make_batch(pts, None, 2)
    cfg = SolverConfig(pyramid=PyramidConfig(0, 1, 2))
    p0 = np.zeros((9, 6), np.float32)
    cpu = correlate(cfg, und_pyr, def_pyr, batch, p0)
    v2.reset_launches()
    gpu = correlate(cfg, [a.to(dev) for a in und_pyr],
                    [a.to(dev) for a in def_pyr], batch, p0)
    solve.resolve_launches()
    assert v2.LAUNCHES > 0
    np.testing.assert_allclose(gpu.params.cpu().numpy(), cpu.params.numpy(),
                               atol=1e-4)
    np.testing.assert_array_equal(gpu.error.cpu().numpy(), cpu.error.numpy())


def test_large_rectangle_on_card_equals_cpu(dev):
    """One 299 x 299 sector: its level-0 tile (320 x 320) exceeds shared
    memory, so the kernel reads it from memory, and at 89,408 and 22,208
    padded pixels levels 0 and 1 take the split path; the solve equals
    the CPU's, bit for bit."""
    from correlation_tpu_torch.domains import (
        RectangularDomain,
        rectangular_batch,
    )

    img = speckle(384, 384, 7)
    dfm = speckle(384, 384, 7, row_shift=1)
    und_pyr = build_pyramid(torch.as_tensor(img[..., None]), 1)
    def_pyr = build_pyramid(torch.as_tensor(dfm[..., None]), 1)
    batch = rectangular_batch(RectangularDomain(40, 40, 340, 340), 1)
    cfg = SolverConfig(pyramid=PyramidConfig(0, 1, 1))
    th, tw = v2.choose_tile(*batch.extents[0], 384, 384)
    p_len = batch.xy[0].shape[1]
    assert not v2.tile_in_shared(th, tw, 1, v2.subset_threads(p_len))
    assert v2.subset_chunks(p_len) > 1
    p0 = np.zeros((1, 6), np.float32)
    cpu = correlate(cfg, und_pyr, def_pyr, batch, p0, device="cpu")
    v2.reset_launches()
    gpu = correlate(cfg, und_pyr, def_pyr, batch, p0, device=dev)
    solve.resolve_launches()
    assert v2.LAUNCHES_BY_SHAPE[(p_len, th, tw)][0] > 0
    for name in ("params", "chi", "iterations", "error"):
        np.testing.assert_array_equal(getattr(gpu, name).cpu().numpy(),
                                      getattr(cpu, name).numpy(), name)
    assert int(gpu.error[0]) == 0
    np.testing.assert_allclose(gpu.params[0, :2].cpu().numpy(), [0, 1],
                               atol=0.01)
