// Fused Gauss-Newton assembly for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel correlation_tpu/ops/assemble_v2.py::
// fused_assemble.  Same contract as its plain PyTorch version,
// correlation_tpu_torch/ops/assemble_v2.py::fused_assemble_reference:
// for each subset at its current warp parameters, warp every pixel, take
// Catmull-Rom / bilinear / nearest taps with the validity window, read the
// deformed intensity and its gradients from the subset's image tile, form
// H, V = und - w and `bad`, and write the 8x8 Gram of G = [H | V | bad]
// (A at [i][j], b at [i][NP], chi at [NP][NP], bad count at [NP+1][NP+1]).
//
// Three paths, chosen from the padded pixel count alone
// (assemble_v2.subset_threads and subset_chunks, which the plain version
// follows too, since the path fixes the order of the Gram sums):
//
//   warp path (threads == kWarpLanes, 16): a group of 16 lanes per
//       subset, two subsets a warp, kWarpSubsets (4) warps a block, each
//       subset with its own slice of shared memory and no block barrier.
//       For small subsets (pyramid levels 1-2: 121 and 36 live pixels),
//       where a 128-thread block left most threads idle; half a warp a
//       subset keeps all 4096 bench subsets in one wave.
//   block path (threads == kBlockThreads, 64): a block per subset, for
//       large subsets (level 0: 441 live pixels).
//   split path (more than kChunkMin, 2048, padded pixels: a blob, an
//       annulus of few sectors, one large rectangle, or a combined batch
//       padded to such a member): the subset is cut into spans of
//       kChunkPixels (512) pixels, a 64-thread block each, which sum their
//       span in the block path's order and write its partial sums to a
//       workspace; a second kernel adds each subset's spans in span order
//       (0, 1, 2, ...) and writes the Gram.  The rule never depends on the
//       subset count, so a subset's sums do not change as the LM loop's
//       active list shrinks.
//
// The counts are the design sweep's choice (experiments/design_sweep.py;
// the readings of the other counts are in PERF.md).
//
// Both paths stage a subset the same way.  The subset's pixel rows (x, y,
// mask, x - cx, y - cy, und) are one contiguous span of pix: its cp.async
// copies (16 bytes where aligned) are issued first, before the tile origin
// is known.  Every warp then computes the origin itself (lanes warp the 4
// bounding-box corners, a shuffle takes the minimum), so no thread waits
// on another's prologue, and issues 4-byte cp.async copies of the tile,
// column by column.  One wait and one barrier later both trips have
// landed.  The tile's rows lie an odd pitch apart in shared memory: a
// subset's pixels run down its columns, so neighbouring lanes read
// neighbouring rows, which at L0's 32-float rows all fell in one bank.
// Each thread keeps the upper triangle of the Gram products of its
// pixels t, t + threads, ... (channels inner) in registers.  A group
// folds its lanes with a reduce-scatter: at each butterfly step a lane
// keeps half of its sums and trades the other half with its partner, 37
// shuffles for the 36 AFFINE products over 32 lanes where a shuffle tree
// per product takes 180.  Each product is still summed over the lanes in
// the butterfly's tree, the tree of a __shfl_down reduction (a + b == b +
// a in IEEE arithmetic), and the block path adds its warps' sums in warp
// order.  Fixed order, no atomics: results repeat bit for bit from run to
// run, and the plain version reproduces them (LM iteration counts depend
// on delta-chi against the precision threshold).
//
// What bounds it: at the bench shapes a subset's bytes (a 2.3-4 KB tile,
// 1-10.7 KB of pixel rows, 256 bytes out) take 0.0016-0.0148 ms an
// assembly of 4096 subsets from HBM, and its 242 counted operations a
// pixel 0.0006-0.0066 ms at the fp32 peak: bytes bound it.  On an H100
// (80GB HBM3, 700 W) the kernel reaches about 20-42% of that bound
// (PERF.md).  Instruction issue does not explain the gap: the per-pixel
// loop is about 283 SASS instructions, which on 132 SMs of 4 schedulers
// near 1.98 GHz issue in about 0.0155 / 0.0044 / 0.0017 ms at levels 0 /
// 1 / 2, against 0.034 / 0.012 / 0.008 ms measured.  What takes the rest
// is not measured (no ncu).  Probably it is each subset's chain of memory
// trips (idx, then params, then tile and rows), with few blocks an SM to
// hide it: 10 on the block path and 5 on the warp path, by registers.
//
// Shared memory (place()): a subset's tile and pixel rows where both fit,
// else the tile alone (the rows read from pix in memory), and on the warp
// path as many subsets a block as then fit.  A tile that alone exceeds
// the budget (at C = 1 from about 248 x 248: one big blob or annulus
// sector, or a combined batch that carries such a member's extents) is
// read straight from the padded image in memory, through L1 and L2, at
// the image's row pitch (the global-tile path); the rows are staged if
// they fit alone.  Every path reads the same values in the same order,
// so the sums do not change, and the launch never fails for lack of
// shared memory.  The split path stages only its span's rows and always
// reads the tile from memory: staged by each span's block, an L1-sized
// tile would be copied once a span.
//
// Why the split path: one block a subset put a blob of 71,264 pixels on
// one of 132 SMs, 0.55 ms an L0 assembly at 0.12% of its bytes bound.
// Cut into 140 spans of 512 it takes 0.0146 ms (38x); the blob's 17,816
// and 4,456-pixel levels take 0.0107 and 0.0092 ms against 0.116 and
// 0.024 ms in one block (H100 80GB HBM3, 700 W; PERF.md).  A span of 512
// is the design sweep's choice over 128-2048: shorter spans repeat each
// block's prologue (index, parameters, corners, origin) more often,
// longer ones leave SMs idle and lengthen each thread's chain of
// dependent tile reads.  What remains is probably latency, not bytes
// (not measured; no ncu): one block an SM, two warps, each pixel's tile
// reads waiting on L2; at 4,456 pixels the two launches and the
// prologue are most of the time (spans of 128 take 0.0068 ms there).
//
// Not on the tensor cores: the Gram is 72 of the 242 operations a pixel,
// and no CPU order reproduces a tensor core's internal accumulation, so a
// tensor-core Gram could not equal the plain version bit for bit.
//
// Built with -fmad=false so each pixel's arithmetic rounds exactly as the
// plain PyTorch version's separate tensor operations do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include <algorithm>
#include <new>

namespace {

// The threads a subset on each path; assemble_v2.py's BLOCK_THREADS and
// WARP_LANES must equal them (the plain version sums in their order).
constexpr int kBlockThreads = 64;
constexpr int kWarpLanes = 16;
constexpr int kWarpSubsets = 4;  // warps a block on the warp path
// The split rule, on the padded pixel count alone: a subset of more than
// kChunkMin pixels is cut into spans of kChunkPixels (the last ragged), a
// block each.  assemble_v2.py's CHUNK_MIN_PIXELS and CHUNK_PIXELS must
// equal them (the plain version adds the spans in their order).
constexpr int kChunkMin = 2048;
constexpr int kChunkPixels = 512;
static_assert(kChunkPixels % kBlockThreads == 0 && kChunkMin >= kChunkPixels,
              "a span is whole rounds of the block's threads");
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 227 * 1024;
// Slots of the reduction's static shared memory a lane group or warp:
// the upper triangle of AFFINE's 8 x 8 Gram, the largest model's.
constexpr int kMaxProducts = 36;
// Dynamic shared memory a block may give its subsets on each path: what
// the reduction's slots leave of kMaxSmem.
constexpr size_t kWarpBudget =
    kMaxSmem - sizeof(float) * kWarpSubsets * (32 / kWarpLanes) * kMaxProducts;
constexpr size_t kBlockBudget =
    kMaxSmem - sizeof(float) * (kBlockThreads / 32) * kMaxProducts;
// The block path writes the 64 Gram entries one a thread.
static_assert(kBlockThreads % 32 == 0 && kBlockThreads >= 64,
              "the block path needs whole warps and at least 64 threads");
static_assert(kWarpLanes == 32 || kWarpLanes == 16,
              "a subset takes a warp or half a warp on the warp path");

__host__ __device__ constexpr int num_params(int model) {
  return model == 0 ? 1 : model == 1 ? 2 : model == 2 ? 3 : 6;
}

// Forward-additive warp; dxc, dyc = position minus subset center.
template <int MODEL>
__device__ __forceinline__ void warp(const float* p, float x, float y,
                                     float dxc, float dyc, float& xd,
                                     float& yd) {
  if constexpr (MODEL == 0) {
    xd = x + p[0];
    yd = y;
  } else if constexpr (MODEL == 1) {
    xd = x + p[0];
    yd = y + p[1];
  } else if constexpr (MODEL == 2) {
    xd = x + p[0] - p[2] * dyc;
    yd = y + p[1] + p[2] * dxc;
  } else {
    xd = x + p[0] + p[2] * dxc + p[3] * dyc;
    yd = y + p[1] + p[4] * dxc + p[5] * dyc;
  }
}

// Catmull-Rom value and derivative taps at offsets -1..2 (Horner).
__device__ __forceinline__ void cubic_taps(float t, float* k, float* dk) {
  k[0] = ((-0.5f * t + 1.0f) * t - 0.5f) * t;
  k[1] = (1.5f * t - 2.5f) * t * t + 1.0f;
  k[2] = ((-1.5f * t + 2.0f) * t + 0.5f) * t;
  k[3] = (0.5f * t - 0.5f) * t * t;
  dk[0] = (-1.5f * t + 2.0f) * t - 0.5f;
  dk[1] = (4.5f * t - 5.0f) * t;
  dk[2] = (-4.5f * t + 4.0f) * t + 0.5f;
  dk[3] = (1.5f * t - 1.0f) * t;
}

// Row pitch of a tile in shared memory: tile_w * C floats made odd.  A
// subset's pixels run down its columns (y fastest), so neighbouring lanes
// read neighbouring tile rows; at an even pitch they share banks (at a
// 32-float pitch, every lane of a column hits one bank).  An odd pitch
// puts 32 consecutive rows in 32 banks.
__host__ __device__ inline int tile_pitch(int tile_w, int c) {
  return (tile_w * c) | 1;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Per-subset parameters and tile origin, held by every thread.
struct Subset {
  int s;       // subset index
  int y0, x0;  // tile origin
  float p[6];
};

// The subset at list position `slot`, its parameters and tile origin.
// Every warp computes the origin itself: lane c & 3 warps corner c, and
// two butterfly steps take the minimum (fminf is exact, so the order is
// free).  An index outside [0, S) is a caller's bug: stop the kernel, as
// a device-side assert does, rather than read another subset's rows.
template <int MODEL, int INTERP>
__device__ __forceinline__ Subset load_subset(
    int slot, const int* __restrict__ idx, int num_subsets,
    const float* __restrict__ center, const float* __restrict__ params,
    const float* __restrict__ bbox, int hp, int wp, int tile_h, int tile_w,
    int t) {
  constexpr int NP = num_params(MODEL);
  constexpr int HALO = INTERP == 2 ? 1 : 0;
  Subset sub;
  sub.s = idx ? idx[slot] : slot;
  if ((unsigned)sub.s >= (unsigned)num_subsets) {
    if (t == 0)
      printf("fused_assemble: subset index %d outside [0, %d)\n", sub.s,
             num_subsets);
    __trap();
  }
  const int s = sub.s;
#pragma unroll
  for (int k = 0; k < 6; ++k)
    sub.p[k] = k < NP ? params[(size_t)s * NP + k] : 0.f;
  const int c = t & 3;
  const float cx = center[2 * s], cy = center[2 * s + 1];
  const float bx = bbox[(size_t)s * 8 + 2 * c];
  const float by = bbox[(size_t)s * 8 + 2 * c + 1];
  float mnx, mny;
  warp<MODEL>(sub.p, bx, by, bx - cx, by - cy, mnx, mny);
  int finite = isfinite(mnx) && isfinite(mny);
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mnx = fminf(mnx, __shfl_xor_sync(kFull, mnx, off));
    mny = fminf(mny, __shfl_xor_sync(kFull, mny, off));
    finite &= __shfl_xor_sync(kFull, finite, off);
  }
  const float ox = fminf(fmaxf(floorf(mnx) - (HALO + 1), 0.f),
                         (float)max(wp - tile_w, 0));
  const float oy = fminf(fmaxf(floorf(mny) - (HALO + 1), 0.f),
                         (float)max(hp - tile_h, 0));
  sub.y0 = finite ? (int)oy : 0;
  sub.x0 = finite ? (int)ox : 0;
  return sub;
}

// Issue the copies of the subset's pixel rows (rows 0 .. 5 + C of its
// [8, P] slab, one contiguous span) into `rows`.  16-byte copies when
// the span and both ends are 16-byte aligned (P % 4 == 0, pix aligned).
template <int C>
__device__ __forceinline__ void stage_rows(float* rows,
                                           const float* __restrict__ px,
                                           int p_len, bool vec, int t,
                                           int threads) {
  const int n = (5 + C) * p_len;
  if (vec) {
    for (int i = 4 * t; i < n; i += 4 * threads) cp_async16(rows + i, px + i);
  } else {
    for (int i = t; i < n; i += threads) cp_async4(rows + i, px + i);
  }
}

// The split path's stage_rows: rows 0 .. 5 + C of a span of `len` pixels
// (`px` points at the span's first pixel in row 0 of the subset's slab,
// rows p_len apart) into `rows`, rows `stride` floats apart.  16-byte
// copies when `vec` (p_len, the span's start, len and stride multiples of
// 4, pix aligned).
template <int C>
__device__ __forceinline__ void stage_span(float* rows,
                                           const float* __restrict__ px,
                                           int p_len, int len, int stride,
                                           bool vec, int t, int threads) {
  const int step = vec ? 4 : 1, per_row = len / step;
  for (int i = t; i < (5 + C) * per_row; i += threads) {
    const int r = i / per_row, q = (i - r * per_row) * step;
    if (vec)
      cp_async16(rows + r * stride + q, px + (size_t)r * p_len + q);
    else
      cp_async4(rows + r * stride + q, px + (size_t)r * p_len + q);
  }
}

// Stage the tile_h x tile_w x C tile at (y0, x0) into `tile`, rows
// tile_pitch apart, by 4-byte cp.async copies.  The threads split the
// row's columns, and its rows too when there are more threads than
// columns; each thread then walks down its column by pointer increments,
// a few instructions a copy.  The origin is clipped to the padded image
// and the launcher checks hp >= tile_h, wp >= tile_w, so every read is
// inside it.
template <int C>
__device__ __forceinline__ void stage_tile(float* tile,
                                           const float* __restrict__ img,
                                           int wp, int y0, int x0,
                                           int tile_h, int tile_w, int t,
                                           int threads) {
  const int row_len = tile_w * C, pitch = tile_pitch(tile_w, C);
  const int groups = max(threads / row_len, 1);  // threads down a column
  const float* src = img + ((size_t)y0 * wp + x0) * C;
  const size_t src_step = (size_t)wp * C * groups;
  const int dst_step = pitch * groups;
  for (int i = t; i < groups * row_len; i += threads) {
    const int g = i / row_len, col = i - g * row_len;
    const float* s = src + (size_t)g * wp * C + col;
    float* d = tile + g * pitch + col;
    for (int r = g; r < tile_h; r += groups, s += src_step, d += dst_step)
      cp_async4(d, s);
  }
}

// One thread's Gram partial sums over pixels t, t + threads, ... below
// `count`, channels inner.  `tile` points at the tile's origin, rows
// `pitch` floats apart (in shared memory, or in the padded image);
// `rows` holds the pixel rows, `stride` floats apart (in shared memory,
// or the subset's slab of pix).
template <int MODEL, int INTERP, int C>
__device__ __forceinline__ void accumulate(
    float* acc, const Subset& sub, const float* tile, int pitch,
    const float* rows, int stride, int count, int img_h, int img_w,
    int tile_h, int tile_w, int t, int threads) {
  constexpr int NP = num_params(MODEL);
  constexpr int R = NP + 2;  // G rows: H, V, bad
  constexpr int TAPS = INTERP == 2 ? 4 : 2;
  constexpr int HALO = INTERP == 2 ? 1 : 0;
  for (int q = t; q < count; q += threads) {
    const float x = rows[q], y = rows[stride + q], m = rows[2 * stride + q];
    const float dxc = rows[3 * stride + q], dyc = rows[4 * stride + q];
    float xd, yd;
    warp<MODEL>(sub.p, x, y, dxc, dyc, xd, yd);
    float ax = floorf(xd), ay = floorf(yd);
    const float tx = xd - ax, ty = yd - ay;
    float kx[TAPS], dkx[TAPS], ky[TAPS], dky[TAPS];
    bool valid;
    if constexpr (INTERP == 2) {
      valid = (xd > 1.0f) && (yd > 1.0f) && (xd < img_w - 2.0f) &&
              (yd < img_h - 2.0f);
      cubic_taps(tx, kx, dkx);
      cubic_taps(ty, ky, dky);
    } else {
      valid = (xd > 0.0f) && (yd > 0.0f) && (xd < img_w - 1.0f) &&
              (yd < img_h - 1.0f);
      if constexpr (INTERP == 1) {
        kx[0] = 1.0f - tx;
        kx[1] = tx;
        ky[0] = 1.0f - ty;
        ky[1] = ty;
      } else {  // NEAREST: value at the rounded pixel, forward differences
        kx[0] = 1.0f;
        kx[1] = 0.0f;
        ky[0] = 1.0f;
        ky[1] = 0.0f;
        ax = floorf(xd + 0.5f);
        ay = floorf(yd + 0.5f);
      }
      dkx[0] = -1.0f;
      dkx[1] = 1.0f;
      dky[0] = -1.0f;
      dky[1] = 1.0f;
    }
    const float rxf = ax - HALO - sub.x0, ryf = ay - HALO - sub.y0;
    const bool in_tile = rxf >= 0.f && rxf <= (float)(tile_w - TAPS) &&
                         ryf >= 0.f && ryf <= (float)(tile_h - TAPS);
    const float okf = (valid && in_tile) ? 1.0f : 0.0f;
    // fmaxf maps NaN to 0, so every read stays inside the tile.
    const int rx = (int)fminf(fmaxf(rxf, 0.f), (float)(tile_w - TAPS));
    const int ry = (int)fminf(fmaxf(ryf, 0.f), (float)(tile_h - TAPS));
    const float live = m * okf;
    const float bad = m * (1.0f - okf);

#pragma unroll
    for (int c = 0; c < C; ++c) {
      float tmp[TAPS], tmp_d[TAPS];
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        const float* col = tile + ry * pitch + (rx + k) * C + c;
        float v = col[0];
        float s = ky[0] * v, sd = dky[0] * v;
#pragma unroll
        for (int j = 1; j < TAPS; ++j) {
          v = col[j * pitch];
          s = s + ky[j] * v;
          sd = sd + dky[j] * v;
        }
        tmp[k] = s;
        tmp_d[k] = sd;
      }
      float w = kx[0] * tmp[0], wdx = dkx[0] * tmp[0], wdy = kx[0] * tmp_d[0];
#pragma unroll
      for (int k = 1; k < TAPS; ++k) {
        w = w + kx[k] * tmp[k];
        wdx = wdx + dkx[k] * tmp[k];
        wdy = wdy + kx[k] * tmp_d[k];
      }
      const float dwdx = wdx * live, dwdy = wdy * live;
      const float und = rows[(5 + c) * stride + q];
      float g[R];
      g[0] = dwdx;
      if constexpr (NP == 2) g[1] = dwdy;
      if constexpr (NP == 3) {
        g[1] = dwdy;
        g[2] = -dwdx * dyc + dwdy * dxc;
      }
      if constexpr (NP == 6) {
        g[1] = dwdy;
        g[2] = dwdx * dxc;
        g[3] = dwdx * dyc;
        g[4] = dwdy * dxc;
        g[5] = dwdy * dyc;
      }
      g[NP] = (und - w) * live;
      g[NP + 1] = c == 0 ? bad : 0.0f;
      int n = 0;
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = i; j < R; ++j) acc[n++] += g[i] * g[j];
      }
    }
  }
}

// Reduce-scatter of v[0 .. N) over the lanes of a group, at butterfly
// offset OFF and below (OFF = lanes / 2 first).  Lanes with bit OFF set
// keep the upper half of the slots, the others the lower half, and each
// adds its partner's copy of the slots it keeps (a dummy 0 slot pads an
// odd N).  On return v[0 .. F) of a lane are the group's sums of
// products first + 0 .. F - 1; those at or past `lim` are dummies.
template <int N, int OFF>
__device__ __forceinline__ void reduce_scatter(float* v, int lane, int& first,
                                               int& lim) {
  constexpr int H = (N + 1) / 2;
  const bool up = lane & OFF;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = v[i];
    const float hi = i + H < N ? v[i + H] : 0.f;
    const float keep = up ? hi : lo;
    v[i] = keep + __shfl_xor_sync(kFull, up ? lo : hi, OFF);
  }
  if (up)
    first += H;
  else
    lim = min(lim, first + H);
  if constexpr (OFF > 1) reduce_scatter<H, OFF / 2>(v, lane, first, lim);
}

// Final slots a lane holds after reduce_scatter<N, OFF>.
__host__ __device__ constexpr int scatter_slots(int n, int off) {
  return off == 0 ? n : scatter_slots((n + 1) / 2, off / 2);
}

// Reduce acc over a group of LANES lanes and store each product's sum at
// red[product].
template <int NPROD, int LANES = 32>
__device__ __forceinline__ void group_sums(float* acc, int lane, float* red) {
  int first = 0, lim = NPROD;
  reduce_scatter<NPROD, LANES / 2>(acc, lane, first, lim);
#pragma unroll
  for (int j = 0; j < scatter_slots(NPROD, LANES / 2); ++j)
    if (first + j < lim) red[first + j] = acc[j];
}

// out[e] of the 8x8 Gram from the upper-triangle sums `sum(k)`.
template <int R, typename Sum>
__device__ __forceinline__ float gram_entry(int e, Sum sum) {
  const int i = e >> 3, j = e & 7;
  if (i >= R || j >= R) return 0.f;
  const int lo = i < j ? i : j, hi = i < j ? j : i;
  // index of (lo, hi) in the row-major upper triangle
  return sum(lo * R - lo * (lo - 1) / 2 + (hi - lo));
}

// Shared memory of one subset: its pixel rows (when staged), then its
// tile (when staged), each region a multiple of 4 floats so 16-byte
// copies stay aligned.
__host__ __device__ inline int rows_floats(int p_len, int c, bool staged) {
  return staged ? ((5 + c) * p_len + 3) / 4 * 4 : 0;
}

__host__ __device__ inline int tile_floats(int tile_h, int tile_w, int c,
                                           bool staged) {
  return staged ? (tile_h * tile_pitch(tile_w, c) + 3) / 4 * 4 : 0;
}

struct Args {
  const float* img;
  int hp, wp, img_h, img_w;
  const float* pix;
  int p_len;
  const float* center;
  const float* params;
  const float* bbox;
  const int* idx;
  // The list's length on the device (at most n), or null for n.  The grid
  // covers n list positions; a block or lane group past the length
  // returns at once, so an LM loop can size the launch to the list's
  // capacity and leave the length on the device.
  const int* count;
  int n, num_subsets, tile_h, tile_w;
  bool stage_rows, stage_tile, vec;
  int groups;  // warp path: lane groups of a warp that hold a subset
  // Split path (chunks > 1): spans of `chunk` pixels, a block each, their
  // partial sums at partial[(slot * chunks + span) * NPROD + product].
  int chunk, chunks;
  float* partial;
  float* out;
};

// The list's length: *count where the caller keeps it on the device.
__device__ __forceinline__ int list_len(const int* count, int n) {
  return count ? min(*count, n) : n;
}

// Pixels a block stages the rows of: the subset's, or a span's.
__host__ __device__ inline int row_len(const Args& a) {
  return a.chunks > 1 ? a.chunk : a.p_len;
}

// Shared-memory floats of one block's subset or span under the
// launcher's choice.
__host__ __device__ inline int subset_floats(const Args& a, int c) {
  return rows_floats(row_len(a), c, a.stage_rows) +
         tile_floats(a.tile_h, a.tile_w, c, a.stage_tile);
}

// One thread's sums over its p_len pixels, with the tile and the rows
// each where the launcher put them: shared memory (the staged copies at
// smem_tile / smem_rows), or the padded image at its own row pitch and
// the subset's slab of pix.  Four instances of one loop, so that every
// load names its memory space.
template <int MODEL, int INTERP, int C>
__device__ __forceinline__ void accumulate_where(
    float* acc, const Subset& sub, const Args& a, const float* smem_rows,
    const float* smem_tile, int p_len, int t, int threads) {
  auto run = [&](const float* tile, int pitch, const float* rows) {
    accumulate<MODEL, INTERP, C>(acc, sub, tile, pitch, rows, p_len, p_len,
                                 a.img_h, a.img_w, a.tile_h, a.tile_w, t,
                                 threads);
  };
  const float* rows = a.pix + (size_t)sub.s * 8 * a.p_len;
  if (a.stage_tile) {
    const int pitch = tile_pitch(a.tile_w, C);
    if (a.stage_rows)
      run(smem_tile, pitch, smem_rows);
    else
      run(smem_tile, pitch, rows);
  } else {
    const float* tile = a.img + ((size_t)sub.y0 * a.wp + sub.x0) * C;
    if (a.stage_rows)
      run(tile, a.wp * C, smem_rows);
    else
      run(tile, a.wp * C, rows);
  }
}

// Warp path: kWarpLanes lanes per subset.  Lane group g of warp w of
// block b assembles list position (b * warps + w) * a.groups + g (warps =
// blockDim.x / 32; a.groups <= 32 / kWarpLanes).  A group past the list,
// or beyond a.groups, works on the last position and writes nothing: its
// lanes still take part in the warp's shuffles.
template <int MODEL, int INTERP, int C>
__global__ void __launch_bounds__(32 * kWarpSubsets)
    fused_assemble_warp(const Args a) {
  constexpr int NPROD = (num_params(MODEL) + 2) * (num_params(MODEL) + 3) / 2;
  constexpr int R = num_params(MODEL) + 2;
  static_assert(NPROD <= kMaxProducts, "the budgets assume kMaxProducts");
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_sum[kWarpSubsets * 32 / kWarpLanes][NPROD];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane / kWarpLanes, l = lane % kWarpLanes;
  const int region = w * a.groups + g;
  const int first = (blockIdx.x * (blockDim.x >> 5) + w) * a.groups;
  const int n = list_len(a.count, a.n);
  if (first >= n) return;  // no block barrier below
  const bool active = g < a.groups && first + g < n;
  const int slot = active ? first + g : n - 1;
  float* rows = smem + (size_t)(active ? region : 0) * subset_floats(a, C);
  float* tile = rows + rows_floats(a.p_len, C, a.stage_rows);

  // The rows need only the index: issue them before the origin's loads.
  const int s = a.idx ? a.idx[slot] : slot;
  if (active && a.stage_rows && (unsigned)s < (unsigned)a.num_subsets)
    stage_rows<C>(rows, a.pix + (size_t)s * 8 * a.p_len, a.p_len, a.vec, l,
                  kWarpLanes);
  const Subset sub = load_subset<MODEL, INTERP>(
      slot, a.idx, a.num_subsets, a.center, a.params, a.bbox, a.hp, a.wp,
      a.tile_h, a.tile_w, l);
  if (active && a.stage_tile)
    stage_tile<C>(tile, a.img, a.wp, sub.y0, sub.x0, a.tile_h, a.tile_w, l,
                  kWarpLanes);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();

  float acc[NPROD];
#pragma unroll
  for (int k = 0; k < NPROD; ++k) acc[k] = 0.f;
  accumulate_where<MODEL, INTERP, C>(acc, sub, a, rows, tile,
                                     active ? a.p_len : 0, l, kWarpLanes);
  float* sums = s_sum[w * (32 / kWarpLanes) + g];
  group_sums<NPROD, kWarpLanes>(acc, l, sums);
  __syncwarp();
  if (!active) return;
  float* o = a.out + (size_t)slot * 64;
#pragma unroll
  for (int e = l; e < 64; e += kWarpLanes)
    o[e] = gram_entry<R>(e, [&](int k) { return sums[k]; });
}

// Block path: one block per list position.
template <int MODEL, int INTERP, int C>
__global__ void __launch_bounds__(kBlockThreads)
    fused_assemble_block(const Args a) {
  constexpr int NPROD = (num_params(MODEL) + 2) * (num_params(MODEL) + 3) / 2;
  constexpr int kWarps = kBlockThreads / 32;
  constexpr int R = num_params(MODEL) + 2;
  static_assert(NPROD <= kMaxProducts, "the budgets assume kMaxProducts");
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_red[kWarps][NPROD];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int slot = blockIdx.x;
  if (slot >= list_len(a.count, a.n)) return;  // the whole block
  float* tile = smem + rows_floats(a.p_len, C, a.stage_rows);

  // The rows need only the index: issue them before the origin's loads.
  const int s = a.idx ? a.idx[slot] : slot;
  if (a.stage_rows && (unsigned)s < (unsigned)a.num_subsets)
    stage_rows<C>(smem, a.pix + (size_t)s * 8 * a.p_len, a.p_len, a.vec, tid,
                  kBlockThreads);
  const Subset sub = load_subset<MODEL, INTERP>(
      slot, a.idx, a.num_subsets, a.center, a.params, a.bbox, a.hp, a.wp,
      a.tile_h, a.tile_w, tid);
  if (a.stage_tile)
    stage_tile<C>(tile, a.img, a.wp, sub.y0, sub.x0, a.tile_h, a.tile_w, tid,
                  kBlockThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float acc[NPROD];
#pragma unroll
  for (int k = 0; k < NPROD; ++k) acc[k] = 0.f;
  accumulate_where<MODEL, INTERP, C>(acc, sub, a, smem, tile, a.p_len, tid,
                                     kBlockThreads);
  group_sums<NPROD>(acc, lane, s_red[w]);
  __syncthreads();
  if (tid < 64) {
    // The warps' sums in warp order.
    a.out[(size_t)slot * 64 + tid] = gram_entry<R>(tid, [&](int k) {
      float v = s_red[0][k];
#pragma unroll
      for (int u = 1; u < kWarps; ++u) v += s_red[u][k];
      return v;
    });
  }
}

// Split path, first pass: block b sums span b % chunks of list position
// b / chunks, pixels [span * chunk, + chunk) of its padded pixels, in the
// block path's order, and writes the span's partial sums.  Every span's
// block loads the subset and computes its origin itself; it stages only
// its span's rows and reads the tile from the padded image in memory.
template <int MODEL, int INTERP, int C>
__global__ void __launch_bounds__(kBlockThreads)
    fused_assemble_span(const Args a) {
  constexpr int NPROD = (num_params(MODEL) + 2) * (num_params(MODEL) + 3) / 2;
  constexpr int kWarps = kBlockThreads / 32;
  static_assert(NPROD <= kBlockThreads, "a thread writes each product");
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_red[kWarps][NPROD];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int slot = blockIdx.x / a.chunks;
  const int span = blockIdx.x - slot * a.chunks;
  if (slot >= list_len(a.count, a.n)) return;  // the whole block
  const int start = span * a.chunk;
  const int len = min(a.chunk, a.p_len - start);

  // The rows need only the index: issue them before the origin's loads.
  const int s = a.idx ? a.idx[slot] : slot;
  const bool ok = (unsigned)s < (unsigned)a.num_subsets;
  const float* px = a.pix + (size_t)(ok ? s : 0) * 8 * a.p_len + start;
  if (a.stage_rows && ok)
    stage_span<C>(smem, px, a.p_len, len, a.chunk, a.vec, tid,
                  kBlockThreads);
  const Subset sub = load_subset<MODEL, INTERP>(
      slot, a.idx, a.num_subsets, a.center, a.params, a.bbox, a.hp, a.wp,
      a.tile_h, a.tile_w, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float acc[NPROD];
#pragma unroll
  for (int k = 0; k < NPROD; ++k) acc[k] = 0.f;
  const float* tile = a.img + ((size_t)sub.y0 * a.wp + sub.x0) * C;
  if (a.stage_rows)
    accumulate<MODEL, INTERP, C>(acc, sub, tile, a.wp * C, smem, a.chunk,
                                 len, a.img_h, a.img_w, a.tile_h, a.tile_w,
                                 tid, kBlockThreads);
  else
    accumulate<MODEL, INTERP, C>(acc, sub, tile, a.wp * C, px, a.p_len, len,
                                 a.img_h, a.img_w, a.tile_h, a.tile_w, tid,
                                 kBlockThreads);
  group_sums<NPROD>(acc, lane, s_red[w]);
  __syncthreads();
  if (tid < NPROD) {
    // The warps' sums in warp order, as the block path adds them.
    float v = s_red[0][tid];
#pragma unroll
    for (int u = 1; u < kWarps; ++u) v += s_red[u][tid];
    a.partial[((size_t)slot * a.chunks + span) * NPROD + tid] = v;
  }
}

// Split path, second pass: one block a list position adds its spans'
// partial sums in span order, 0, 1, 2, ..., and writes the 8x8 Gram.  The
// threads stage kSumSpans spans at a time in shared memory (coalesced,
// all loads in flight together); thread k adds product k's in order.
constexpr int kSumThreads = 64;  // a Gram entry a thread
constexpr int kSumSpans = 32;

template <int MODEL>
__global__ void __launch_bounds__(kSumThreads)
    fused_assemble_span_sum(const float* __restrict__ partial, int chunks,
                            const int* __restrict__ count, int n,
                            float* __restrict__ out) {
  constexpr int R = num_params(MODEL) + 2;
  constexpr int NPROD = R * (R + 1) / 2;
  static_assert(NPROD <= kSumThreads, "a thread adds each product");
  __shared__ float s_part[kSumSpans * NPROD];
  __shared__ float s_sum[NPROD];
  const int t = threadIdx.x, slot = blockIdx.x;
  if (slot >= list_len(count, n)) return;  // the whole block
  const float* p = partial + (size_t)slot * chunks * NPROD;
  float v = 0.f;
  for (int first = 0; first < chunks; first += kSumSpans) {
    const int here = min(kSumSpans, chunks - first);
    __syncthreads();
    for (int i = t; i < here * NPROD; i += kSumThreads)
      s_part[i] = p[(size_t)first * NPROD + i];
    __syncthreads();
    if (t < NPROD)
      for (int j = 0; j < here; ++j)
        v = first + j == 0 ? s_part[t] : v + s_part[j * NPROD + t];
  }
  if (t < NPROD) s_sum[t] = v;
  __syncthreads();
  out[(size_t)slot * 64 + t] =
      gram_entry<R>(t, [&](int k) { return s_sum[k]; });
}

// Subsets of `per` bytes that fit in `budget` bytes, at most `most`.
inline int fitting(size_t budget, size_t per, int most) {
  return per ? (int)std::min((size_t)most, budget / per) : most;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  // Without the opt-in a block's dynamic and static shared memory
  // together stay within 48 KB; the static part is at most the warp
  // path's reduction slots.
  constexpr size_t kStatic =
      sizeof(float) * kWarpSubsets * (32 / kWarpLanes) * kMaxProducts;
  if (smem + kStatic <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Where a subset's tile and rows go on a path with `budget` bytes: the
// tile in shared memory if it fits alone, the rows beside it (or alone,
// when the tile is read from memory) if they fit too.  The split path
// reads the tile from memory: staged in every span's block, it would be
// copied once a span.  Returns the bytes of one subset (or span).
inline size_t place(Args& a, int c, size_t budget) {
  const size_t tile = (size_t)tile_floats(a.tile_h, a.tile_w, c, true) * 4;
  const size_t rows = (size_t)rows_floats(row_len(a), c, true) * 4;
  a.stage_tile = a.chunks == 1 && tile <= budget;
  a.stage_rows = (a.stage_tile ? tile : 0) + rows <= budget;
  return (size_t)subset_floats(a, c) * 4;
}

// A launch planned once and issued any number of times: plan_path()
// chooses the path, the grid and the shared memory and makes the opt-in;
// issue() launches it on whichever list `a.idx` / `a.count` then name.
// fused_assemble_launch plans and issues once; an LM level plans K1 once
// and issues it at every step (lm_level.cu).
struct Plan {
  Args a;
  void (*kernel)(Args);
  // The split path's second pass (the spans' sums), else null.
  void (*span_sum)(const float*, int, const int*, int, float*);
  int blocks, threads;
  size_t smem;
};

cudaError_t issue(const Plan& p, cudaStream_t stream) {
  p.kernel<<<p.blocks, p.threads, p.smem, stream>>>(p.a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !p.span_sum) return e;
  p.span_sum<<<p.a.n, kSumThreads, 0, stream>>>(p.a.partial, p.a.chunks,
                                                p.a.count, p.a.n, p.a.out);
  return cudaGetLastError();
}

template <int MODEL, int INTERP, int C>
cudaError_t plan_path(int threads, Plan& p) {
  Args& a = p.a;
  a.vec = a.p_len % 4 == 0 && a.chunk % 4 == 0 &&
          (uintptr_t)a.pix % 16 == 0;
  p.span_sum = nullptr;
  if (a.chunks > 1) {
    if (threads != kBlockThreads) return cudaErrorInvalidValue;
    p.kernel = fused_assemble_span<MODEL, INTERP, C>;
    p.span_sum = fused_assemble_span_sum<MODEL>;
    p.smem = place(a, C, kBlockBudget);
    p.blocks = a.n * a.chunks;
    p.threads = kBlockThreads;
  } else if (threads == kWarpLanes) {
    // Fewer subsets a block (and a warp) where all do not fit.  Nothing
    // here changes the sums.
    const size_t per = place(a, C, kWarpBudget);
    a.groups = 32 / kWarpLanes;
    int warps = fitting(kWarpBudget, per * a.groups, kWarpSubsets);
    if (warps == 0) {
      a.groups = 1;
      warps = fitting(kWarpBudget, per, kWarpSubsets);
    }
    const int per_block = a.groups * warps;
    p.kernel = fused_assemble_warp<MODEL, INTERP, C>;
    p.smem = per * per_block;
    p.blocks = (a.n + per_block - 1) / per_block;
    p.threads = 32 * warps;
  } else if (threads == kBlockThreads) {
    p.kernel = fused_assemble_block<MODEL, INTERP, C>;
    p.smem = place(a, C, kBlockBudget);
    p.blocks = a.n;
    p.threads = kBlockThreads;
  } else {
    return cudaErrorInvalidValue;
  }
  return allow_smem(p.kernel, p.smem);
}

template <int MODEL, int INTERP>
cudaError_t plan_c(int c, int threads, Plan& p) {
  switch (c) {
    case 1: return plan_path<MODEL, INTERP, 1>(threads, p);
    case 2: return plan_path<MODEL, INTERP, 2>(threads, p);
    case 3: return plan_path<MODEL, INTERP, 3>(threads, p);
  }
  return cudaErrorInvalidValue;
}

template <int MODEL>
cudaError_t plan_i(int interp, int c, int threads, Plan& p) {
  switch (interp) {
    case 0: return plan_c<MODEL, 0>(c, threads, p);
    case 1: return plan_c<MODEL, 1>(c, threads, p);
    case 2: return plan_c<MODEL, 2>(c, threads, p);
  }
  return cudaErrorInvalidValue;
}

// Checks fused_assemble_launch's arguments (n > 0) and plans its launch.
cudaError_t make_plan(int model, int interp, int c, int threads, int chunk,
                      const float* img, int hp, int wp, int img_h,
                      int img_w, const float* pix, int p_len,
                      const float* center, const float* params,
                      const float* bbox, const int* idx, const int* count,
                      int n, int num_subsets, int tile_h, int tile_w,
                      float* work, long long work_floats, float* out,
                      Plan& p) {
  if (hp < tile_h || wp < tile_w || p_len <= 0 || chunk < 0 || model < 0 ||
      model > 3)
    return cudaErrorInvalidValue;
  if (chunk == 0) chunk = p_len > kChunkMin ? kChunkPixels : p_len;
  chunk = std::min(chunk, p_len);
  const long long chunks = (p_len + chunk - 1) / chunk;
  const long long nprod =
      (num_params(model) + 2) * (num_params(model) + 3) / 2;
  if (chunks > 1 && (n * chunks > INT32_MAX || !work ||
                     work_floats < n * chunks * nprod))
    return cudaErrorInvalidValue;
  p.a = Args{img,    hp,     wp,     img_h,  img_w, pix,
             p_len,  center, params, bbox,   idx,   count, n,
             num_subsets, tile_h, tile_w, false, false, false,
             1,      chunk,  (int)chunks, work, out};
  switch (model) {
    case 0: return plan_i<0>(interp, c, threads, p);
    case 1: return plan_i<1>(interp, c, threads, p);
    case 2: return plan_i<2>(interp, c, threads, p);
    case 3: return plan_i<3>(interp, c, threads, p);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).  `count` is a
// device pointer to the length of the list `idx` (at most n), or null for
// n; the grid covers n positions, and those past the length write
// nothing.  `threads` picks
// the path: kWarpLanes for the warp path, kBlockThreads for the block
// path (anything else is cudaErrorInvalidValue).  `chunk` is the pixels a
// block sums: 0 for the split rule (kChunkMin, kChunkPixels), else a
// span length (p_len or more: one block a subset); a subset cut into
// several spans takes the split path, on kBlockThreads threads only, and
// `work` holds at least n x spans x the model's Gram products floats
// (`work_floats`) for their partial sums.
int fused_assemble_launch(int model, int interp, int c, int threads,
                          int chunk, const float* img, int hp, int wp,
                          int img_h, int img_w, const float* pix, int p_len,
                          const float* center, const float* params,
                          const float* bbox, const int* idx,
                          const int* count, int n, int num_subsets, int tile_h, int tile_w,
                          float* work, long long work_floats, float* out,
                          void* stream_ptr) {
  if (n <= 0) return 0;
  Plan p;
  const cudaError_t e = make_plan(
      model, interp, c, threads, chunk, img, hp, wp, img_h, img_w, pix,
      p_len, center, params, bbox, idx, count, n, num_subsets, tile_h,
      tile_w, work, work_floats, out, p);
  if (e != cudaSuccess) return (int)e;
  return (int)issue(p, (cudaStream_t)stream_ptr);
}

// fused_assemble_launch in two halves, for a caller that launches K1 on
// many lists with the same arguments otherwise: fused_assemble_plan
// takes its arguments but the stream (n > 0), checks them, plans the
// launch (the path, the grid, the shared memory and its opt-in) and
// writes a plan into *plan, which fused_assemble_plan_free frees;
// fused_assemble_issue launches the plan on the list `idx` of length
// *count (the room n the plan was made for).  Each returns a
// cudaError_t.  The launches equal fused_assemble_launch's.
int fused_assemble_plan(int model, int interp, int c, int threads,
                        int chunk, const float* img, int hp, int wp,
                        int img_h, int img_w, const float* pix, int p_len,
                        const float* center, const float* params,
                        const float* bbox, const int* idx, const int* count,
                        int n, int num_subsets, int tile_h, int tile_w,
                        float* work, long long work_floats, float* out,
                        void** plan) {
  *plan = nullptr;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  Plan* p = new (std::nothrow) Plan;
  if (!p) return (int)cudaErrorMemoryAllocation;
  const cudaError_t e = make_plan(
      model, interp, c, threads, chunk, img, hp, wp, img_h, img_w, pix,
      p_len, center, params, bbox, idx, count, n, num_subsets, tile_h,
      tile_w, work, work_floats, out, *p);
  if (e != cudaSuccess) {
    delete p;
    return (int)e;
  }
  *plan = p;
  return 0;
}

int fused_assemble_issue(void* plan, const int* idx, const int* count,
                         void* stream_ptr) {
  Plan& p = *static_cast<Plan*>(plan);
  p.a.idx = idx;
  p.a.count = count;
  return (int)issue(p, (cudaStream_t)stream_ptr);
}

void fused_assemble_plan_free(void* plan) { delete static_cast<Plan*>(plan); }

// The launcher's placement of a subset's tile on the path of `threads`
// threads a subset, cut into `chunks` spans: 1 when it is staged in
// shared memory, 0 when the kernel reads it from the padded image (the
// global-tile path, and the split path at any tile), -1 for an
// unsupported path or channel count.
int fused_assemble_tile_in_shared(int c, int threads, int chunks,
                                  int tile_h, int tile_w) {
  if (c < 1 || c > 3 || (threads != kWarpLanes && threads != kBlockThreads) ||
      chunks < 1 || (chunks > 1 && threads != kBlockThreads))
    return -1;
  Args a{};
  a.p_len = a.chunk = 1;
  a.chunks = chunks;
  a.tile_h = tile_h;
  a.tile_w = tile_w;
  place(a, c, threads == kWarpLanes ? kWarpBudget : kBlockBudget);
  return a.stage_tile ? 1 : 0;
}

const char* fused_assemble_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
