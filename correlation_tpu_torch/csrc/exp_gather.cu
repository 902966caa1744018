// Per-column row gather for Hopper (sm_90a): out[i][j] = src[idx[i][j]][j].
//
// Replaces the Pallas TPU kernel experiments/exp_gather.py:14 (`kernel`, a
// take_along_axis over the sublane axis inside VMEM).  That experiment asked
// whether a per-lane gather lowers on the TPU; on Hopper the same gather is
// the fused assembly's tile read (csrc/fused_assemble.cu reads 16 taps per
// pixel from a tile staged in shared memory), and this kernel is that read
// alone, at the experiment's sizes (src 64 x 512 f32, idx 16 x 512 int32).
//
// Design: a block owns a slab of up to kCols columns.  It stages src[:, slab]
// in dynamic shared memory (64 rows x 512 columns = 128 KB, above the 48 KB
// static limit, so the launcher raises the block's limit with
// cudaFuncSetAttribute), coalesced row by row, then each thread gathers its
// own column: N reads from shared memory, one store each.
//
// What bounds it: at these sizes nothing but latency.  The kernel moves
// 128 KB in and 32 KB out, a few microseconds of HBM time; one block of 512
// threads stages and gathers, so the launch, the staging round trip and the
// barrier are the cost.  Shared-memory reads by neighbouring threads hit
// neighbouring columns, so they fall in distinct banks whatever the rows.
//
// An index outside [0, rows) is a caller's bug: the kernel prints it and
// traps, as a device-side assert does, and the next synchronising call
// raises.

#include <cuda_runtime.h>
#include <stdio.h>

namespace {

constexpr int kCols = 512;  // threads per block = columns per slab

__global__ void __launch_bounds__(kCols) gather_rows_kernel(
    const float* __restrict__ src, const int* __restrict__ idx, int rows,
    int cols, int n, float* __restrict__ out) {
  extern __shared__ float slab[];  // [rows][width]
  const int c0 = blockIdx.x * kCols;
  const int width = min(kCols, cols - c0);
  const int t = threadIdx.x;
  if (t < width) {
    for (int r = 0; r < rows; ++r) slab[r * width + t] = src[(size_t)r * cols + c0 + t];
  }
  __syncthreads();
  if (t >= width) return;
  for (int i = 0; i < n; ++i) {
    const int r = idx[(size_t)i * cols + c0 + t];
    if ((unsigned)r >= (unsigned)rows) {
      printf("gather_rows: index %d at [%d, %d] outside [0, %d)\n", r, i,
             c0 + t, rows);
      __trap();
    }
    out[(size_t)i * cols + c0 + t] = slab[r * width + t];
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int gather_rows_launch(const float* src, const int* idx, int rows, int cols,
                       int n, float* out, void* stream_ptr) {
  if (rows <= 0 || cols <= 0 || n <= 0) return 0;
  const size_t smem = (size_t)rows * min(cols, kCols) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gather_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (cols + kCols - 1) / kCols;
  gather_rows_kernel<<<blocks, kCols, smem, (cudaStream_t)stream_ptr>>>(
      src, idx, rows, cols, n, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
