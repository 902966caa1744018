// The fused assembly's stages as separate kernels for Hopper (sm_90a).
//
// Replaces the five Pallas TPU kernels of experiments/exp_matmul_overhead.py
// (`run` :36, bodies `k_loop` :71, `k_batch` :83, `k_gram_loop` :94,
// `k_gram_big` :104, `k_vpu` :120).  That experiment timed the stages of
// the TPU assembly kernel one by one; the variants of each pair compute the
// same function and differ in how the work is laid out, which is what the
// experiment measures.  On Hopper the questions become: one block walking
// its subsets in turn against one block per subset (loop / batched), and
// one warp per subset on the CUDA cores against subsets packed into
// tensor-core products (gram_loop / gram_big), the packing choice of the
// fused assembly at pyramid levels 1 and 2.  Sizes
// (exp_matmul_overhead.py:20-21): G = 256 steps of B = 8 subsets, K = 120,
// M = 128, P = 512, TW = 32.
//
//   loop, batched  out[g,b] = a[g,b]^T o[g,b]: a [G,B,K,M], o [G,B,K,P] bf16,
//                  out [G,B,M,P] f32 (k_loop / k_batch).  Bound: 851 MB of
//                  traffic, 537 MB of it the f32 output, 0.254 ms at 3.35
//                  TB/s, against 32 GFLOP, 0.033 ms on the tensor cores: a
//                  streaming store with a small product in front of it.
//                  One product routine (product_walk) serves both grids:
//                  loop, G blocks each walking its B subsets; batched, G x B
//                  blocks of one subset.  A block of 16 warps computes 128 x
//                  128 output tiles with mma.sync m16n8k16 bf16 -> f32, both
//                  operands read by ldmatrix.trans (a and o are K-outer);
//                  no product runs on the CUDA cores.  Each warp keeps its
//                  16 rows of a^T for every k-step in registers, so a
//                  subset's a is staged once and its buffer refills with
//                  the next subset's a (cp.async) while this subset's tiles
//                  run; o streams in 128-column tiles through three stages,
//                  two tiles' cp.async in flight during a tile's mma and
//                  stores.  K is zero-padded in shared memory to a multiple
//                  of 16 (zeros add nothing, exactly).  Each warp stages its
//                  16 x 64 f32 fragment tile in its own shared memory and
//                  writes it back as 16-byte stores, two whole 256-byte row
//                  pieces an instruction.  213 KB of shared memory, one
//                  block an SM.  On the card, 128-column tiles beat 64-column
//                  ones at two blocks an SM (longer row pieces reach memory
//                  together); more blocks an SM with narrower tiles, a
//                  block-wide output stage and streaming or evict-first
//                  cache hints did not.  loop starts block g at subset g mod
//                  B: blocks in step otherwise write regions 2 MB apart,
//                  which was slower.  Rows of 16 B
//                  alignment (M and P multiples of 8) take cp.async and
//                  16-byte stores; other shapes stage and store element by
//                  element with the same products.  K, M <= 128 (the
//                  wrapper checks).
//   gram_loop      out[g,b] = x x^T, x = g[g,b] [8, P] f32: one warp per
//                  subset, each lane sums its pixels p = lane, lane + 32, ...
//                  for the 36 products of the upper triangle, then a
//                  fixed-order butterfly of warp shuffles (the fused
//                  assembly's reduction).  Reads 32 MiB (2048 subsets x 8 x
//                  512 f32) once for 75 MFLOP: bound by memory, ~10 us at
//                  HBM bandwidth, less where the input sits in the 50 MB L2.
//   gram_big       the same function with subsets packed into one product,
//                  as the TPU kernel packed B of them, on the tensor cores:
//                  mma.sync m16n8k8 TF32 -> f32 with two subsets' 16 rows as
//                  A and one subset's 8 rows as B, so each product yields
//                  one wanted diagonal block and one discarded cross block
//                  (2x the needed work, against 8x for the [8B, 8B] Gram).
//                  In the fragment layouts a lane's A registers for one
//                  subset are, register for register, that subset's B
//                  fragment, and the sum over P may run in any pixel order
//                  A and B share: so each lane loads float4s of consecutive
//                  pixels straight into registers (no shared memory) and
//                  each float4 feeds two k-steps.  A block of 8 warps takes
//                  a pair of subsets, each warp every 8th 32-pixel chunk
//                  (two at P = 512), one chunk's loads in flight; the warps'
//                  partial Grams add in shared memory in a fixed order.
//                  1024 blocks of 256 threads, 50 registers.  On the card
//                  (experiments/design_sweep.py, NVIDIA H100 80GB HBM3,
//                  700 W) 4 warps with 1, 2 or 4 chunks in flight and 8
//                  with 1 took the same time within the noise, 0.0154-0.0158
//                  ms from HBM; 8 warps halve each warp's chain of
//                  tensor-core additions, and the error with it (max
//                  |kernel - plain| 3.3e-6 against 5.2e-6).  1 or 2 warps
//                  (0.018-0.027 ms, up to 2.0e-5) and 8 with 4 chunks
//                  (0.020 ms) were slower.  Plain TF32 (2^-11 relative a
//                  term) misses the 1e-5 x sum |terms| tolerance, so each
//                  value splits as hi = tf32(x), lo = tf32(x - hi) and the
//                  Gram is hi hi + (hi lo + lo hi), the cross terms in an
//                  accumulator of their own (about 2^-21 a term).  Bound by
//                  memory: 33.5 MB read, 0.01 ms; the tensor cores' share
//                  is under a microsecond.  P not a multiple of 4, or rows
//                  off 16-byte alignment, load element by element with the
//                  same pixel order; pixels past P and the missing partner
//                  of an odd subset count are zeros, which add nothing.
//   vpu            the column-weight stage and three multiply-reduce stages:
//                  sel [G,B,4TW,P], rx [G,B,1,P] f32 -> out [G,B,3,P] f32,
//                  one thread per (g, b, p).  Reads 512 MB once: bound by
//                  HBM bandwidth.
//
// The products' bf16 x bf16 terms are exact in f32 and the tensor cores
// add them in their own order; gram_big's terms carry the split's 2^-21;
// the other kernels' sums run in a fixed order and every element-wise step
// rounds as the plain PyTorch versions' do (-fmad=false, with explicit
// fmaf in gram_loop).  So results agree with those versions to f32
// summation error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- loop / batched ----------------------------------------------------

constexpr int kProdThreads = 512;  // 16 warps: 8 down M x 2 across a tile
constexpr int kMaxK = 128, kMaxM = 128;
constexpr int kWarpCols = 64;            // output columns of a warp
constexpr int kTileP = 2 * kWarpCols;    // output columns a step
constexpr int kStages = 3;               // o tiles in flight: this, 2 ahead
// Shared-memory row strides: 16 bytes past a multiple of 128 keep the eight
// rows of every ldmatrix and every fragment store in distinct banks.
constexpr int kLdA = kMaxM + 8;          // bf16
constexpr int kLdO = kTileP + 8;         // bf16
constexpr int kLdOut = kWarpCols + 8;    // f32
constexpr int kTileO = kMaxK * kLdO;     // one stage of o
constexpr int kProdSmem = (kMaxK * kLdA + kStages * kTileO) * 2 +
                          (kProdThreads / 32) * 16 * kLdOut * 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n of this thread's newest copy groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += A B for one 16 x 8 x 16 step: A in a[4], B in b0, b1 (bf16 pairs).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [0, K) x columns [c0, c0 + width) of a row-major bf16 matrix
// with row length `ld` into shared memory with row stride `lds`.
template <bool kVec>
__device__ void stage_rows(uint16_t* __restrict__ dst, int lds,
                           const uint16_t* __restrict__ src, int ld, int c0,
                           int K, int width) {
  if (kVec) {  // width, ld, c0 multiples of 8; 16-byte aligned rows
    const int chunks = width / 8;
    for (int e = threadIdx.x; e < K * chunks; e += kProdThreads) {
      const int k = e / chunks, c = (e - k * chunks) * 8;
      cp_async16(dst + k * lds + c, src + (size_t)k * ld + c0 + c);
    }
  } else {
    for (int e = threadIdx.x; e < K * width; e += kProdThreads) {
      const int k = e / width, c = e - k * width;
      dst[k * lds + c] = src[(size_t)k * ld + c0 + c];
    }
  }
}

// out[s] = a[s]^T o[s] for the n subsets s = s0 + (j + rot) % n, j = 0 ..
// n - 1, by the block.  The tiles (j, p-tile) run in one sequence; o's
// loads run kStages - 1 tiles ahead, each tile's copies one commit group.
template <bool kVec>
__device__ void product_walk(const uint16_t* __restrict__ a,
                             const uint16_t* __restrict__ o,
                             float* __restrict__ out, size_t s0, int n,
                             int rot, int K, int M, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sa = reinterpret_cast<uint16_t*>(smem);
  uint16_t* so = sa + kMaxK * kLdA;  // kStages tiles of o
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sw = reinterpret_cast<float*>(so + kStages * kTileO) +
              warp * 16 * kLdOut;
  auto subset = [&](int j) { return s0 + (j + rot) % n; };
  const int nks = (K + 15) / 16;
  const int pad = nks * 16 - K;
  // Zero rows K .. 16 nks - 1 once: no load writes them.
  for (int e = threadIdx.x; e < pad * kLdA; e += kProdThreads)
    sa[K * kLdA + e] = 0;
  for (int e = threadIdx.x; e < pad * kLdO; e += kProdThreads) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) so[st * kTileO + K * kLdO + e] = 0;
  }
  const int tiles = (P + kTileP - 1) / kTileP;
  const int total = n * tiles;
  const size_t a_size = (size_t)K * M, o_size = (size_t)K * P;
  auto load_tile = [&](int u) {  // tile u's o into its stage
    if (u < total) {
      const int pu = u % tiles * kTileP;
      stage_rows<kVec>(so + u % kStages * kTileO, kLdO,
                       o + subset(u / tiles) * o_size, P, pu, K,
                       min(kTileP, P - pu));
    }
    cp_async_commit();
  };
  stage_rows<kVec>(sa, kLdA, a + subset(0) * a_size, M, 0, K, M);
#pragma unroll
  for (int u = 0; u < kStages - 1; ++u) load_tile(u);

  const int m0 = warp % 8 * 16, n0 = warp / 8 * kWarpCols;
  const int i8 = lane >> 3, r8 = lane & 7;  // ldmatrix: matrix, row
  const int g = lane >> 2, c = lane & 3;    // mma fragment: row, column pair
  uint32_t af[kMaxK / 16][4];               // a^T, this warp's rows
  for (int t = 0; t < total; ++t) {
    const int j = t / tiles, p0 = t % tiles * kTileP;
    // Subset j's a was copied with tile t - tiles + kStages - 1; with
    // fewer tiles a subset than kStages - 1, wait for every copy.
    if (p0 == 0 && tiles < kStages - 1)
      cp_async_wait<0>();
    else
      cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t staged; every warp is done with tile t - 1
    if (p0 == 0) {
#pragma unroll
      for (int ks = 0; ks < kMaxK / 16; ++ks)
        if (ks < nks)
          ldmatrix_x4_trans(
              af[ks], sa + (ks * 16 + r8 + 8 * (i8 >> 1)) * kLdA + m0 +
                          8 * (i8 & 1));
      __syncthreads();  // sa is free: the next subset's a streams in
      if (j + 1 < n)
        stage_rows<kVec>(sa, kLdA, a + subset(j + 1) * a_size, M, 0, K, M);
    }
    load_tile(t + kStages - 1);  // into the stage tile t - 1 left

    float acc[kWarpCols / 8][4] = {};
    const uint16_t* sb = so + t % kStages * kTileO + n0;
#pragma unroll
    for (int ks = 0; ks < kMaxK / 16; ++ks) {
      if (ks < nks) {
#pragma unroll
        for (int np = 0; np < kWarpCols / 16; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, sb + (ks * 16 + r8 + 8 * (i8 & 1)) * kLdO +
                                   np * 16 + 8 * (i8 >> 1));
          mma_bf16(acc[2 * np], af[ks], b[0], b[1]);
          mma_bf16(acc[2 * np + 1], af[ks], b[2], b[3]);
        }
      }
    }

    // The warp's 16 x 64 tile through its own shared memory, then out as
    // 16-byte stores, two whole 256-byte row pieces an instruction.
#pragma unroll
    for (int nt = 0; nt < kWarpCols / 8; ++nt) {
      *reinterpret_cast<float2*>(sw + g * kLdOut + nt * 8 + 2 * c) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(sw + (g + 8) * kLdOut + nt * 8 + 2 * c) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
    __syncwarp();
    float* dst = out + subset(j) * (size_t)M * P;
    const int pc = p0 + n0;
    if (kVec) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 2 * i + (lane >> 4), col = (lane & 15) * 4;
        const int m = m0 + r, p = pc + col;
        if (m < M && p < P)
          *reinterpret_cast<float4*>(dst + (size_t)m * P + p) =
              *reinterpret_cast<const float4*>(sw + r * kLdOut + col);
      }
    } else {
      for (int e = lane; e < 16 * kWarpCols; e += 32) {
        const int r = e / kWarpCols, col = e % kWarpCols;
        const int m = m0 + r, p = pc + col;
        if (m < M && p < P) dst[(size_t)m * P + p] = sw[r * kLdOut + col];
      }
    }
    __syncwarp();
  }
}

// loop: block g walks its B subsets, starting at subset g mod B, so that
// the blocks running together write 256 KB regions spread over the output
// rather than regions 2 MB apart.
template <bool kVec>
__global__ void __launch_bounds__(kProdThreads, 1) stage_loop_kernel(
    const uint16_t* __restrict__ a, const uint16_t* __restrict__ o, int B,
    int K, int M, int P, float* __restrict__ out) {
  product_walk<kVec>(a, o, out, (size_t)blockIdx.x * B, B, blockIdx.x % B, K,
                     M, P);
}

// batched: one block per subset.
template <bool kVec>
__global__ void __launch_bounds__(kProdThreads, 1) stage_batched_kernel(
    const uint16_t* __restrict__ a, const uint16_t* __restrict__ o, int K,
    int M, int P, float* __restrict__ out) {
  product_walk<kVec>(a, o, out, blockIdx.x, 1, 0, K, M, P);
}

template <typename Kernel>
cudaError_t prepare_product(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kProdSmem);
}

template <bool kVec>
cudaError_t launch_product(int batched, const uint16_t* a, const uint16_t* o,
                           int G, int B, int K, int M, int P, float* out,
                           cudaStream_t stream) {
  if (batched) {
    cudaError_t e = prepare_product(stage_batched_kernel<kVec>);
    if (e != cudaSuccess) return e;
    stage_batched_kernel<kVec><<<G * B, kProdThreads, kProdSmem, stream>>>(
        a, o, K, M, P, out);
  } else {
    cudaError_t e = prepare_product(stage_loop_kernel<kVec>);
    if (e != cudaSuccess) return e;
    stage_loop_kernel<kVec><<<G, kProdThreads, kProdSmem, stream>>>(
        a, o, B, K, M, P, out);
  }
  return cudaGetLastError();
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

// gram_big: a block of kBigWarps warps per pair of subsets (s0, s1).  Warp
// w takes the kChunk-pixel chunks w, w + kBigWarps, ... of both subsets'
// rows, kDepth of them loaded before their products; the warps' partial
// Grams meet in shared memory.  experiments/design_sweep.py builds and
// times other warp counts and depths through GRAM_BIG_WARPS and
// GRAM_BIG_DEPTH; the defaults are the design it chose.
#ifndef GRAM_BIG_WARPS
#define GRAM_BIG_WARPS 8
#endif
#ifndef GRAM_BIG_DEPTH
#define GRAM_BIG_DEPTH 1
#endif
constexpr int kBigWarps = GRAM_BIG_WARPS;  // a power of two, 1 to 8
constexpr int kBigThreads = 32 * kBigWarps;
constexpr int kChunk = 32;  // pixels of each row a warp takes a chunk
constexpr int kDepth = GRAM_BIG_DEPTH;
static_assert(kBigWarps >= 1 && kBigWarps <= 8 &&
                  (kBigWarps & (kBigWarps - 1)) == 0,
              "GRAM_BIG_WARPS: 1, 2, 4 or 8");
static_assert(kDepth >= 1, "GRAM_BIG_DEPTH: at least 1");

// x rounded to TF32 (nearest, ties away), as an f32 with the 13 low
// mantissa bits cleared, so that x - tf32_rna(x) is exact.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xFFFFE000u);
}

// d += A B for one 16 x 8 x 8 step: A in a0..a3, B in b0, b1 (TF32).
__device__ __forceinline__ void mma_tf32(float (&d)[4], float a0, float a1,
                                         float a2, float a3, float b0,
                                         float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)),
        "r"(__float_as_uint(a2)), "r"(__float_as_uint(a3)),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// One k-step of 8 pixels.  Lane (r, t) holds row r of subset 0 (u) and of
// subset 1 (w) at the step's pixels t and t + 4: A = [u; w] has them at
// (r, t), (r + 8, t), (r, t + 4), (r + 8, t + 4), and subset 0's B (u^T)
// has the same u at (t, r), (t + 4, r): the same registers.  d += hi hi,
// e += hi lo + lo hi (the 3xTF32 split; lo lo is below f32 rounding).
__device__ __forceinline__ void gram_step(float (&d0)[4], float (&e0)[4],
                                          float (&d1)[4], float (&e1)[4],
                                          float u0, float u1, float w0,
                                          float w1) {
  const float uh0 = tf32_rna(u0), uh1 = tf32_rna(u1);
  const float wh0 = tf32_rna(w0), wh1 = tf32_rna(w1);
  const float ul0 = tf32_rna(u0 - uh0), ul1 = tf32_rna(u1 - uh1);
  const float wl0 = tf32_rna(w0 - wh0), wl1 = tf32_rna(w1 - wh1);
  mma_tf32(e0, ul0, wl0, ul1, wl1, uh0, uh1);
  mma_tf32(e0, uh0, wh0, uh1, wh1, ul0, ul1);
  mma_tf32(d0, uh0, wh0, uh1, wh1, uh0, uh1);
  mma_tf32(e1, ul0, wl0, ul1, wl1, wh0, wh1);
  mma_tf32(e1, uh0, wh0, uh1, wh1, wl0, wl1);
  mma_tf32(d1, uh0, wh0, uh1, wh1, wh0, wh1);
}

// row[p .. p + 3], zeros past P or where !ok.  kVec: one 16-byte load (P a
// multiple of 4, rows 16-byte aligned); else element by element.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int p,
                                        int P, bool ok) {
  if (kVec)
    return ok && p < P ? __ldg(reinterpret_cast<const float4*>(row + p))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = ok && p + j < P ? __ldg(row + p + j) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <bool kVec>
__global__ void __launch_bounds__(kBigThreads) stage_gram_big_kernel(
    const float* __restrict__ g, int n, int P, float* __restrict__ out) {
  __shared__ float part[kBigWarps][128];  // per warp: 2 subsets x 64
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 2, t = lane & 3;
  const size_t s0 = 2 * (size_t)blockIdx.x;
  const bool has1 = s0 + 1 < (size_t)n;  // odd n: subset 1 is zeros
  const float* x0 = g + (s0 * 8 + r) * P;
  const float* x1 = x0 + (size_t)8 * P;
  float d0[4] = {}, e0[4] = {}, d1[4] = {}, e1[4] = {};
  for (int c = warp * kChunk; c < P; c += kDepth * kBigWarps * kChunk) {
    // Lane t takes pixels 4t .. 4t + 3 and 16 + 4t .. 19 + 4t of a chunk;
    // each float4 feeds two k-steps.  The pixels' order within the sum is
    // free as long as A and B share it, and they share registers.
    float4 u[kDepth][2], w[kDepth][2];
#pragma unroll
    for (int q = 0; q < kDepth; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = c + q * kBigWarps * kChunk + 16 * h + 4 * t;
        u[q][h] = load4<kVec>(x0, p, P, true);
        w[q][h] = load4<kVec>(x1, p, P, has1);
      }
#pragma unroll
    for (int q = 0; q < kDepth; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        gram_step(d0, e0, d1, e1, u[q][h].x, u[q][h].y, w[q][h].x,
                  w[q][h].y);
        gram_step(d0, e0, d1, e1, u[q][h].z, u[q][h].w, w[q][h].z,
                  w[q][h].w);
      }
  }
  // D's lane (r, t) holds rows r and r + 8, columns 2t and 2t + 1: subset
  // 0's Gram in d0[0..1] (rows 0-7 of A B(u)), subset 1's in d1[2..3] (rows
  // 8-15 of A B(w)); the other halves are the discarded cross products.
  float* mine = part[warp];
  mine[r * 8 + 2 * t] = d0[0] + e0[0];
  mine[r * 8 + 2 * t + 1] = d0[1] + e0[1];
  mine[64 + r * 8 + 2 * t] = d1[2] + e1[2];
  mine[64 + r * 8 + 2 * t + 1] = d1[3] + e1[3];
  __syncthreads();
  // The 128 outputs, each the warps' partials added neighbours first:
  // (p0 + p1) + (p2 + p3) for four warps.
  for (int i = threadIdx.x; i < 128; i += kBigThreads) {
    float v[kBigWarps];
#pragma unroll
    for (int q = 0; q < kBigWarps; ++q) v[q] = part[q][i];
#pragma unroll
    for (int m = kBigWarps / 2; m > 0; m /= 2)
#pragma unroll
      for (int q = 0; q < m; ++q) v[q] = v[2 * q] + v[2 * q + 1];
    if (s0 + i / 64 < (size_t)n) out[s0 * 64 + i] = v[0];
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
  if (G <= 0 || B <= 0 || M <= 0 || P <= 0) return 0;
  if (K < 0 || K > kMaxK || M > kMaxM) return (int)cudaErrorInvalidValue;
  auto a16 = (const uint16_t*)a;
  auto o16 = (const uint16_t*)o;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const bool vec = M % 8 == 0 && P % 8 == 0 &&
                   ((uintptr_t)a | (uintptr_t)o | (uintptr_t)out) % 16 == 0;
  return (int)(vec ? launch_product<true>(batched, a16, o16, G, B, K, M, P,
                                          out, stream)
                   : launch_product<false>(batched, a16, o16, G, B, K, M, P,
                                           out, stream));
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
  const int n = G * B, pairs = (n + 1) / 2;
  if (P % 4 == 0 && (uintptr_t)g % 16 == 0)
    stage_gram_big_kernel<true><<<pairs, kBigThreads, 0, stream>>>(g, n, P,
                                                                   out);
  else
    stage_gram_big_kernel<false><<<pairs, kBigThreads, 0, stream>>>(g, n, P,
                                                                    out);
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
