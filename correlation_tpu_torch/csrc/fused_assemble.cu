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
// Design of this first version: one block of 128 threads per subset.  The
// block reads its subset id from the index list of still-active subsets,
// computes the tile origin from the warped bounding-box corners (as
// compute_origins does), stages the tile_h x tile_w x C tile in shared
// memory, and loops over pixels; each thread keeps the upper triangle of
// the Gram products in registers.  The block reduces them with warp
// shuffles and then shared memory in a fixed order, without atomics, so
// results repeat bit for bit from run to run (LM iteration counts depend
// on delta-chi against the precision threshold).
//
// What bounds it: at pyramid level 0 a subset has 441 pixels of ~150 flops
// each against a 4 KB tile (32x32 floats), a few hundred bytes of pixel
// data per pixel row and 256 bytes out.  That is far too little work per
// block to be HBM-bound: the kernel is latency- and occupancy-bound (tile
// staging, the shuffle reduction, one small block per subset).  Packing
// several level-1/2 subsets into one block, and staging tiles with
// cp.async or TMA, are left for later work.
//
// Built with -fmad=false so each pixel's arithmetic rounds exactly as the
// plain PyTorch version's separate tensor operations do; only the order
// of the Gram sums differs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdio.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

template <int MODEL, int INTERP, int C>
__global__ void __launch_bounds__(kThreads) fused_assemble_kernel(
    const float* __restrict__ img, int hp, int wp, int img_h, int img_w,
    const float* __restrict__ pix, int p_len,
    const float* __restrict__ center, const float* __restrict__ params,
    const float* __restrict__ bbox, const int* __restrict__ idx,
    int num_subsets, int tile_h, int tile_w, float* __restrict__ out) {
  constexpr int NP = num_params(MODEL);
  constexpr int R = NP + 2;  // G rows: H, V, bad
  constexpr int NPROD = R * (R + 1) / 2;
  constexpr int TAPS = INTERP == 2 ? 4 : 2;
  constexpr int HALO = INTERP == 2 ? 1 : 0;

  extern __shared__ float tile[];  // [tile_h][tile_w][C]
  __shared__ int s_org[2];
  __shared__ float s_p[6];
  __shared__ float s_red[kWarps][NPROD];
  __shared__ float s_sum[NPROD];

  const int b = blockIdx.x;
  const int s = idx ? idx[b] : b;
  const int tid = threadIdx.x;
  // An index outside [0, S) is a caller's bug: stop the kernel, as a
  // device-side assert does, rather than read another subset's rows.
  if ((unsigned)s >= (unsigned)num_subsets) {
    if (tid == 0)
      printf("fused_assemble: subset index %d outside [0, %d)\n", s,
             num_subsets);
    __trap();
  }

  if (tid == 0) {
    float p[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < NP; ++k) p[k] = params[(size_t)s * NP + k];
    const float cx = center[2 * s], cy = center[2 * s + 1];
    float mnx = INFINITY, mny = INFINITY;
    bool finite = true;
    for (int c = 0; c < 4; ++c) {
      const float bx = bbox[(size_t)s * 8 + 2 * c];
      const float by = bbox[(size_t)s * 8 + 2 * c + 1];
      float xd, yd;
      warp<MODEL>(p, bx, by, bx - cx, by - cy, xd, yd);
      finite = finite && isfinite(xd) && isfinite(yd);
      mnx = fminf(mnx, xd);
      mny = fminf(mny, yd);
    }
    const float ox = fminf(fmaxf(floorf(mnx) - (HALO + 1), 0.f),
                           (float)max(wp - tile_w, 0));
    const float oy = fminf(fmaxf(floorf(mny) - (HALO + 1), 0.f),
                           (float)max(hp - tile_h, 0));
    s_org[0] = finite ? (int)oy : 0;
    s_org[1] = finite ? (int)ox : 0;
    for (int k = 0; k < 6; ++k) s_p[k] = p[k];
  }
  __syncthreads();
  const int y0 = s_org[0], x0 = s_org[1];

  // Stage the tile; zero outside the padded image (the clipped origin
  // keeps the tile inside, the guard only protects the reads).
  const int row_len = tile_w * C;
  for (int i = tid; i < tile_h * row_len; i += kThreads) {
    const int r = i / row_len;
    const int rem = i - r * row_len;
    const int gy = y0 + r, gx = x0 + rem / C;
    tile[i] = (gy < hp && gx < wp)
                  ? img[((size_t)gy * wp + x0) * C + rem]
                  : 0.f;
  }
  float p[6];
  for (int k = 0; k < 6; ++k) p[k] = s_p[k];
  __syncthreads();

  float acc[NPROD];
#pragma unroll
  for (int n = 0; n < NPROD; ++n) acc[n] = 0.f;

  const float* px = pix + (size_t)s * 8 * p_len;
  for (int q = tid; q < p_len; q += kThreads) {
    const float x = px[q], y = px[p_len + q], m = px[2 * p_len + q];
    const float dxc = px[3 * p_len + q], dyc = px[4 * p_len + q];
    float xd, yd;
    warp<MODEL>(p, x, y, dxc, dyc, xd, yd);
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
    const float rxf = ax - HALO - x0, ryf = ay - HALO - y0;
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
        const float* col = tile + (ry * tile_w + rx + k) * C + c;
        float v = col[0];
        float t = ky[0] * v, td = dky[0] * v;
#pragma unroll
        for (int j = 1; j < TAPS; ++j) {
          v = col[j * row_len];
          t = t + ky[j] * v;
          td = td + dky[j] * v;
        }
        tmp[k] = t;
        tmp_d[k] = td;
      }
      float w = kx[0] * tmp[0], wdx = dkx[0] * tmp[0], wdy = kx[0] * tmp_d[0];
#pragma unroll
      for (int k = 1; k < TAPS; ++k) {
        w = w + kx[k] * tmp[k];
        wdx = wdx + dkx[k] * tmp[k];
        wdy = wdy + kx[k] * tmp_d[k];
      }
      const float dwdx = wdx * live, dwdy = wdy * live;
      const float und = px[(5 + c) * p_len + q];
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

  // Fixed-order block reduction: shuffle tree inside each warp, then the
  // warps' partial sums in warp order.
  const int lane = tid & 31, warp_id = tid >> 5;
#pragma unroll
  for (int n = 0; n < NPROD; ++n) {
    float v = acc[n];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_red[warp_id][n] = v;
  }
  __syncthreads();
  if (tid < NPROD) {
    float v = s_red[0][tid];
    for (int w = 1; w < kWarps; ++w) v += s_red[w][tid];
    s_sum[tid] = v;
  }
  __syncthreads();
  if (tid < 64) {
    const int i = tid >> 3, j = tid & 7;
    float v = 0.f;
    if (i < R && j < R) {
      const int lo = i < j ? i : j, hi = i < j ? j : i;
      // index of (lo, hi) in the row-major upper triangle
      v = s_sum[lo * R - lo * (lo - 1) / 2 + (hi - lo)];
    }
    out[(size_t)b * 64 + tid] = v;
  }
}

template <int MODEL, int INTERP, int C>
cudaError_t launch(const float* img, int hp, int wp, int img_h, int img_w,
                   const float* pix, int p_len, const float* center,
                   const float* params, const float* bbox, const int* idx,
                   int n, int num_subsets, int tile_h, int tile_w,
                   float* out, cudaStream_t stream) {
  const size_t smem = (size_t)tile_h * tile_w * C * sizeof(float);
  auto kernel = fused_assemble_kernel<MODEL, INTERP, C>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<n, kThreads, smem, stream>>>(img, hp, wp, img_h, img_w, pix,
                                        p_len, center, params, bbox, idx,
                                        num_subsets, tile_h, tile_w, out);
  return cudaGetLastError();
}

template <int MODEL, int INTERP>
cudaError_t dispatch_c(int c, const float* img, int hp, int wp, int img_h,
                       int img_w, const float* pix, int p_len,
                       const float* center, const float* params,
                       const float* bbox, const int* idx, int n,
                       int num_subsets, int tile_h, int tile_w, float* out,
                       cudaStream_t stream) {
#define FA_ARGS                                                             \
  img, hp, wp, img_h, img_w, pix, p_len, center, params, bbox, idx, n,    \
      num_subsets, tile_h, tile_w, out, stream
  switch (c) {
    case 1: return launch<MODEL, INTERP, 1>(FA_ARGS);
    case 2: return launch<MODEL, INTERP, 2>(FA_ARGS);
    case 3: return launch<MODEL, INTERP, 3>(FA_ARGS);
  }
  return cudaErrorInvalidValue;
}

template <int MODEL>
cudaError_t dispatch_i(int interp, int c, const float* img, int hp, int wp,
                       int img_h, int img_w, const float* pix, int p_len,
                       const float* center, const float* params,
                       const float* bbox, const int* idx, int n,
                       int num_subsets, int tile_h, int tile_w, float* out,
                       cudaStream_t stream) {
  switch (interp) {
    case 0: return dispatch_c<MODEL, 0>(c, FA_ARGS);
    case 1: return dispatch_c<MODEL, 1>(c, FA_ARGS);
    case 2: return dispatch_c<MODEL, 2>(c, FA_ARGS);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int fused_assemble_launch(int model, int interp, int c, const float* img,
                          int hp, int wp, int img_h, int img_w,
                          const float* pix, int p_len, const float* center,
                          const float* params, const float* bbox,
                          const int* idx, int n, int num_subsets,
                          int tile_h, int tile_w, float* out,
                          void* stream_ptr) {
  if (n <= 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  switch (model) {
    case 0: return dispatch_i<0>(interp, c, FA_ARGS);
    case 1: return dispatch_i<1>(interp, c, FA_ARGS);
    case 2: return dispatch_i<2>(interp, c, FA_ARGS);
    case 3: return dispatch_i<3>(interp, c, FA_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

const char* fused_assemble_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
