// Designs timed against the shipped experiment kernels and not shipped.
//
// Built only by experiments/design_sweep.py, into a library of its own;
// never part of the kernel library that ops/_build.py builds.  Each entry
// here computes the same function as a shipped kernel, so that the sweep
// can hold it against that kernel on the same inputs.
//
//   gather_rows_direct  out[i][j] = src[idx[i][j]][j] as csrc/exp_gather.cu,
//       one thread per 4 outputs of a row (16-byte idx loads and out stores
//       where cols is a multiple of 4 and the pointers are 16-byte aligned;
//       else one thread per output): each thread reads its indices, then
//       src[idx][j] straight through the read-only path.  Two dependent
//       memory trips and no barrier, where the shipped kernel overlaps the
//       index trip with staging src in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int checked(int r, int rows, size_t e, int cols) {
  if ((unsigned)r >= (unsigned)rows) {
    printf("gather_rows_direct: index %d at [%llu, %llu] outside [0, %d)\n",
           r, (unsigned long long)(e / cols), (unsigned long long)(e % cols),
           rows);
    __trap();
  }
  return r;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) gather_rows_direct_kernel(
    const float* __restrict__ src, const int* __restrict__ idx, int rows,
    int cols, size_t total, float* __restrict__ out) {
  constexpr int kPer = kVec ? 4 : 1;
  const size_t e = ((size_t)blockIdx.x * kThreads + threadIdx.x) * kPer;
  if (e >= total) return;
  const int j = (int)(e % cols);
  if (kVec) {  // e, cols multiples of 4: the four outputs share a row
    const int4 r = __ldg(reinterpret_cast<const int4*>(idx + e));
    float4 v;
    v.x = __ldg(src + (size_t)checked(r.x, rows, e, cols) * cols + j);
    v.y = __ldg(src + (size_t)checked(r.y, rows, e + 1, cols) * cols + j + 1);
    v.z = __ldg(src + (size_t)checked(r.z, rows, e + 2, cols) * cols + j + 2);
    v.w = __ldg(src + (size_t)checked(r.w, rows, e + 3, cols) * cols + j + 3);
    *reinterpret_cast<float4*>(out + e) = v;
  } else {
    out[e] = __ldg(src + (size_t)checked(__ldg(idx + e), rows, e, cols) * cols + j);
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int gather_rows_direct_launch(const float* src, const int* idx, int rows,
                              int cols, int n, float* out, void* stream_ptr) {
  if (rows <= 0 || cols <= 0 || n <= 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const size_t total = (size_t)n * cols;
  const bool vec = cols % 4 == 0 && ((uintptr_t)idx | (uintptr_t)out) % 16 == 0;
  const size_t threads = vec ? total / 4 : total;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  if (vec)
    gather_rows_direct_kernel<true><<<blocks, kThreads, 0, stream>>>(
        src, idx, rows, cols, total, out);
  else
    gather_rows_direct_kernel<false><<<blocks, kThreads, 0, stream>>>(
        src, idx, rows, cols, total, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
