// The fused assembly's stages as separate kernels for Hopper (sm_90a).
//
// Replaces the five Pallas TPU kernels of experiments/exp_matmul_overhead.py
// (`run` :36, bodies `k_loop` :71, `k_batch` :83, `k_gram_loop` :94,
// `k_gram_big` :104, `k_vpu` :120).  That experiment timed the stages of
// the TPU assembly kernel one by one; the variants of each pair compute the
// same function and differ in how the work is laid out, which is what the
// experiment measures.  On Hopper the questions become: one block walking
// its subsets in turn against one block per subset (loop / batched), and
// one warp per subset against one block packing B subsets into one large
// Gram (gram_loop / gram_big), the packing choice of the fused assembly at
// pyramid levels 1 and 2.  Sizes (exp_matmul_overhead.py:20-21): G = 256
// steps of B = 8 subsets, K = 120, M = 128, P = 512, TW = 32.
//
//   loop, batched  out[g,b] = a[g,b]^T o[g,b]: a [G,B,K,M], o [G,B,K,P] bf16,
//                  out [G,B,M,P] f32.  A shared-memory tiled FMA product:
//                  256 threads, 128 x 128 output tiles, 8 x 8 outputs a
//                  thread, K in steps of 8.  loop: a grid of G blocks, each
//                  block walks its B subsets; batched: G x B blocks.  32
//                  GFLOP and 850 MB of traffic: bound by the FMA rate of the
//                  CUDA cores (no tensor cores, no wgmma/TMA: later work).
//   gram_loop      out[g,b] = x x^T, x = g[g,b] [8, P] f32: one warp per
//                  subset, each lane sums its pixels p = lane, lane + 32, ...
//                  for the 36 products of the upper triangle, then a
//                  fixed-order butterfly of warp shuffles (the fused
//                  assembly's reduction).  Reads 32 MiB (2048 subsets x 8 x
//                  512 f32) once for 75 MFLOP: bound by memory, ~10 us at
//                  HBM bandwidth, less where the input sits in the 50 MB L2.
//   gram_big       the same function computed as the TPU kernel did: one
//                  block per g stages the [8B, P] rows in shared memory
//                  (128 KB, row stride P + 1 so that rows fall in distinct
//                  banks) and forms the whole [8B, 8B] Gram, 4 x 4 outputs a
//                  thread, keeping only the B diagonal 8 x 8 blocks: B times
//                  the work of gram_loop (1.1 GFLOP), and at 128 KB of shared
//                  memory one block an SM, so 256 blocks run in two waves on
//                  132 SMs with no overlap of staging and arithmetic.
//   vpu            the column-weight stage and three multiply-reduce stages:
//                  sel [G,B,4TW,P], rx [G,B,1,P] f32 -> out [G,B,3,P] f32,
//                  one thread per (g, b, p).  Reads 512 MB once: bound by
//                  HBM bandwidth.
//
// Sums run in a fixed order and every element-wise step rounds as the
// plain PyTorch versions' do (-fmad=false, with explicit fmaf in the
// products' accumulations); only the order of the sums differs from those
// versions, so results agree to float32 summation error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---- loop / batched ----------------------------------------------------

constexpr int kProdThreads = 256;
constexpr int kTM = 128, kTP = 128, kTK = 8;

// out [M, P] = a[K, M]^T o[K, P] for one subset, by the whole block.
__device__ void subset_product(const __nv_bfloat16* __restrict__ a,
                               const __nv_bfloat16* __restrict__ o,
                               float* __restrict__ out, int K, int M, int P) {
  __shared__ float sa[kTK][kTM];
  __shared__ float so[kTK][kTP];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  for (int m0 = 0; m0 < M; m0 += kTM) {
    for (int p0 = 0; p0 < P; p0 += kTP) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += kTK) {
        for (int e = tid; e < kTK * kTM; e += kProdThreads) {
          const int kk = e / kTM, k = k0 + kk, m = m0 + e % kTM;
          sa[kk][e % kTM] =
              (k < K && m < M) ? __bfloat162float(a[(size_t)k * M + m]) : 0.f;
        }
        for (int e = tid; e < kTK * kTP; e += kProdThreads) {
          const int kk = e / kTP, k = k0 + kk, p = p0 + e % kTP;
          so[kk][e % kTP] =
              (k < K && p < P) ? __bfloat162float(o[(size_t)k * P + p]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kTK; ++kk) {
          float ra[8], rb[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) ra[i] = sa[kk][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 8; ++j) rb[j] = so[kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = p0 + tx + 16 * j;
          if (m < M && p < P) out[(size_t)m * P + p] = acc[i][j];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kProdThreads) stage_loop_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ o,
    int B, int K, int M, int P, float* __restrict__ out) {
  for (int b = 0; b < B; ++b) {
    const size_t s = (size_t)blockIdx.x * B + b;
    subset_product(a + s * K * M, o + s * K * P, out + s * M * P, K, M, P);
  }
}

__global__ void __launch_bounds__(kProdThreads) stage_batched_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ o,
    int K, int M, int P, float* __restrict__ out) {
  const size_t s = blockIdx.x;
  subset_product(a + s * K * M, o + s * K * P, out + s * M * P, K, M, P);
}

// ---- gram_loop / gram_big ----------------------------------------------

constexpr int kGramThreads = 256;
constexpr int kGramWarps = kGramThreads / 32;

// Index of (lo, hi), lo <= hi, in the row-major upper triangle of 8 x 8.
__host__ __device__ constexpr int tri8(int lo, int hi) {
  return lo * 8 - lo * (lo - 1) / 2 + (hi - lo);
}

__global__ void __launch_bounds__(kGramThreads) stage_gram_loop_kernel(
    const float* __restrict__ g, int n, int P, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kGramWarps + (threadIdx.x >> 5);
  if (s >= n) return;  // the whole warp leaves together
  const float* x = g + (size_t)s * 8 * P;
  float acc[36];
#pragma unroll
  for (int q = 0; q < 36; ++q) acc[q] = 0.f;
  for (int p = lane; p < P; p += 32) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = x[(size_t)i * P + p];
    int q = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = i; j < 8; ++j, ++q) acc[q] = fmaf(v[i], v[j], acc[q]);
  }
  // Butterfly: every lane ends with the same totals, summed in a fixed order.
#pragma unroll
  for (int q = 0; q < 36; ++q)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
  float* o = out + (size_t)s * 64;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (((i * 8 + j) & 31) == lane)
        o[i * 8 + j] = acc[i <= j ? tri8(i, j) : tri8(j, i)];
}

__global__ void __launch_bounds__(kGramThreads) stage_gram_big_kernel(
    const float* __restrict__ g, int B, int P, float* __restrict__ out) {
  extern __shared__ float rows[];  // [8B][P + 1]
  const int R = 8 * B, ld = P + 1;
  const float* x = g + (size_t)blockIdx.x * R * P;
  for (int e = threadIdx.x; e < R * P; e += kGramThreads)
    rows[(e / P) * ld + e % P] = x[e];
  __syncthreads();
  const int side = R / 4;  // 4 x 4 output tiles per side
  for (int t = threadIdx.x; t < side * side; t += kGramThreads) {
    const int r0 = (t / side) * 4, c0 = (t % side) * 4;
    // Four partial sums per output (p mod 4), added pairwise at the end.
    float acc[4][4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[q][i][j] = 0.f;
    int p = 0;
    for (; p + 4 <= P; p += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float rv[4], cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) rv[i] = rows[(r0 + i) * ld + p + q];
#pragma unroll
        for (int j = 0; j < 4; ++j) cv[j] = rows[(c0 + j) * ld + p + q];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[q][i][j] = fmaf(rv[i], cv[j], acc[q][i][j]);
      }
    }
    for (; p < P; ++p) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[0][i][j] = fmaf(rows[(r0 + i) * ld + p], rows[(c0 + j) * ld + p],
                              acc[0][i][j]);
    }
    if (r0 / 8 != c0 / 8) continue;  // off the diagonal blocks: discarded
    float* o = out + ((size_t)blockIdx.x * B + r0 / 8) * 64;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[((r0 + i) % 8) * 8 + (c0 + j) % 8] =
            (acc[0][i][j] + acc[1][i][j]) + (acc[2][i][j] + acc[3][i][j]);
  }
}

// ---- vpu ---------------------------------------------------------------

constexpr int kTW = 32;
constexpr int kVpuThreads = 256;

__global__ void __launch_bounds__(kVpuThreads) stage_vpu_kernel(
    const float* __restrict__ sel, const float* __restrict__ rx, int n, int P,
    float* __restrict__ out) {
  const size_t t = (size_t)blockIdx.x * kVpuThreads + threadIdx.x;
  if (t >= (size_t)n * P) return;
  const size_t s = t / P;
  const int p = (int)(t % P);
  const float* col = sel + s * 4 * kTW * P + p;
  const int r = (int)rx[s * P + p];  // truncates toward zero, as astype(int32)
  float w_v = 0.f, dwdx = 0.f, dwdy = 0.f;
  for (int c = 0; c < kTW; ++c) {
    const int d = c - r;
    float w_col = 0.f, w_col_d = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float m = d == kk ? 1.f : 0.f;
      w_col = w_col + m * 0.3f;
      w_col_d = w_col_d + m * 0.1f;
    }
    float tmp = col[(size_t)c * P];
    float tmp_d = col[(size_t)(kTW + c) * P];
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      const float v = col[(size_t)(j * kTW + c) * P];
      tmp = tmp + 0.25f * v;
      tmp_d = tmp_d + 0.1f * v;
    }
    w_v = w_v + w_col * tmp;
    dwdx = dwdx + w_col_d * tmp;
    dwdy = dwdy + w_col * tmp_d;
  }
  float* o = out + s * 3 * P + p;
  o[0] = w_v;
  o[P] = dwdx;
  o[2 * P] = dwdy;
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success).

int stage_product_launch(int batched, const void* a, const void* o, int G,
                         int B, int K, int M, int P, float* out,
                         void* stream_ptr) {
  if (G <= 0 || B <= 0) return 0;
  auto a16 = (const __nv_bfloat16*)a;
  auto o16 = (const __nv_bfloat16*)o;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (batched)
    stage_batched_kernel<<<G * B, kProdThreads, 0, stream>>>(a16, o16, K, M, P,
                                                             out);
  else
    stage_loop_kernel<<<G, kProdThreads, 0, stream>>>(a16, o16, B, K, M, P,
                                                      out);
  return (int)cudaGetLastError();
}

int stage_gram_launch(int big, const float* g, int G, int B, int P,
                      float* out, void* stream_ptr) {
  if (G <= 0 || B <= 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (!big) {
    const int n = G * B;
    stage_gram_loop_kernel<<<(n + kGramWarps - 1) / kGramWarps, kGramThreads,
                             0, stream>>>(g, n, P, out);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)8 * B * (P + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stage_gram_big_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  stage_gram_big_kernel<<<G, kGramThreads, smem, stream>>>(g, B, P, out);
  return (int)cudaGetLastError();
}

int stage_vpu_launch(const float* sel, const float* rx, int G, int B, int P,
                     float* out, void* stream_ptr) {
  const size_t total = (size_t)G * B * P;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + kVpuThreads - 1) / kVpuThreads);
  stage_vpu_kernel<<<blocks, kVpuThreads, 0, (cudaStream_t)stream_ptr>>>(
      sel, rx, G * B, P, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
