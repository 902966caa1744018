// Per-column row gather for Hopper (sm_90a): out[i][j] = src[idx[i][j]][j].
//
// Replaces the Pallas TPU kernel experiments/exp_gather.py:14 (`kernel`, a
// take_along_axis over the sublane axis inside VMEM).  That experiment asked
// whether a per-lane gather lowers on the TPU; on Hopper the same gather is
// the fused assembly's tile read (csrc/fused_assemble.cu reads 16 taps per
// pixel from a tile staged in shared memory), and this kernel is that read
// alone, at the experiment's sizes (src 64 x 512 f32, idx 16 x 512 int32).
//
// What bounds it: latency, not bytes.  It moves 196,608 bytes, 0.06 us of
// HBM time, less than a launch.  What is left to design is how many
// dependent memory trips stand between the launch and the last store, and
// how many SMs share them.
//
// Design: the columns are cut into slabs of kSlab = 32, a block of 16 warps
// each (16 blocks at the experiment's sizes).  A block stages src[:, slab]
// (rows x 128 bytes, 8 KB at 64 rows) in shared memory, a warp a row and a
// lane a column, while each thread's first index is already in flight;
// after one barrier the gathers read shared memory.  The two memory trips
// overlap, at the cost of reading all of src and a barrier.  Rows past what
// a block's 227 KB of shared memory holds (kMaxStagedRows) are not staged:
// an index there reads src straight from memory, so any rows, cols and n
// take this one kernel.
//
// The other design timed on the card, one thread per 4 outputs reading its
// indices and then src[idx][j] straight through the read-only path (two
// dependent trips, no barrier), took 0.0022-0.0025 ms from HBM against this
// kernel's 0.0017-0.0021 and an empty launch's 0.0010 (NVIDIA H100 80GB
// HBM3, 700 W; PERF.md section 6), and was dropped.
//
// An index outside [0, rows) is a caller's bug: the kernel prints it and
// traps, as a device-side assert does, and the next synchronising call
// raises.

#include <cuda_runtime.h>
#include <stdio.h>

namespace {

constexpr int kSlab = 32;      // columns a block owns
constexpr int kThreads = 512;  // 16 warps: a row of the slab each
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStagedRows = 227 * 1024 / (kSlab * 4);

__device__ __forceinline__ int checked(int r, int rows, size_t e, int cols) {
  if ((unsigned)r >= (unsigned)rows) {
    printf("gather_rows: index %d at [%llu, %llu] outside [0, %d)\n", r,
           (unsigned long long)(e / cols), (unsigned long long)(e % cols),
           rows);
    __trap();
  }
  return r;
}

__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const float* __restrict__ src, const int* __restrict__ idx, int rows,
    int cols, int n, float* __restrict__ out) {
  extern __shared__ float slab[];  // [staged][kSlab]
  const int staged = min(rows, kMaxStagedRows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * kSlab + lane;
  const bool live = j < cols;
  // This thread's first index leaves before the staging loads.
  const int first = live && warp < n ? __ldg(idx + (size_t)warp * cols + j) : 0;
  if (live)
    for (int r = warp; r < staged; r += kWarps)
      slab[r * kSlab + lane] = __ldg(src + (size_t)r * cols + j);
  __syncthreads();
  if (!live) return;
  for (int i = warp; i < n; i += kWarps) {
    const size_t e = (size_t)i * cols + j;
    const int r = checked(i == warp ? first : __ldg(idx + e), rows, e, cols);
    out[e] = r < staged ? slab[r * kSlab + lane]
                        : __ldg(src + (size_t)r * cols + j);
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int gather_rows_launch(const float* src, const int* idx, int rows, int cols,
                       int n, float* out, void* stream_ptr) {
  if (rows <= 0 || cols <= 0 || n <= 0) return 0;
  const size_t smem = (size_t)min(rows, kMaxStagedRows) * kSlab * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gather_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gather_rows_kernel<<<(cols + kSlab - 1) / kSlab, kThreads, smem,
                       (cudaStream_t)stream_ptr>>>(src, idx, rows, cols, n,
                                                   out);
  return (int)cudaGetLastError();
}

// One block of one warp that does nothing.
int empty_kernel_launch(void* stream_ptr) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream_ptr>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
