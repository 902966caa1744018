// The Levenberg-Marquardt step for Hopper (sm_90a): one LM iteration of a
// pyramid level, after the assembly, over a list of subsets.
//
// Not a TPU kernel: the JAX package leaves this step to XLA, as the tail
// of correlation_tpu/engine.py::_make_body (:343-453) and, in init mode,
// the initial step of its solve_level (:597-626).  Same contract as the
// plain PyTorch version, correlation_tpu_torch/ops/solve.py::
// lm_step_reference: for list position i < *count, subset s = idx[i], with
// the assembly of position i at out[i] (A at [j][k], b at [j][NP], chi at
// [NP][NP], the bad-pixel count at [NP+1][NP+1]):
//   chi = chi_raw * scaling, delta-chi, the lambda schedule and its
//   clamps, the fresh Gram on a converging step or the cached last-good
//   one on a diverging step, lm_delta's unrolled Cholesky (the pivot's
//   sqrt in float64), the saved-parameter step, the SOLVER,
//   MAX_ITERS_REACHED and out-of-image codes (the four warped bounding-box
//   corners, as models/warp.warp_points), and every write of the state;
//   in init mode the classification of the assembly at the guess
//   (BAD_DOMAIN, SOLVER, out-of-image), the first step and the cache.
//
// Why a kernel: eager PyTorch issued this step as ~270 small operations
// an LM iteration (lm_delta ~230 of them), 3-3.6 ms of host issue at 4096
// subsets on an H100 against 0.34 ms for lm_delta's device time from a
// CUDA graph (PERF.md).  One thread a listed subset does it in one launch.
// There is no reuse between subsets and the work is a 6x6 solve and a few
// dozen scalars, so neither shared memory nor the tensor cores help.
//
// The list's length is read from the device (`count`), and threads past
// it return at once: an LM loop enqueues list -> assembly -> step with no
// host read between iterations, and an iteration whose list is empty
// costs a launch whose threads exit.
//
// What bounds it: bytes.  A subset reads its 64-float Gram, scaling and
// its state (parameters, lambda, chi, counters) and writes the state
// back; it reads the cached Gram on a diverging step or writes it on an
// accepted one, never both, and the bounding box and center only for the
// out-of-image test: at most about 0.7 KB (AFFINE).  Its ~200 float
// operations are far below the fp32 peak per byte.  The reads of a
// thread are 256 bytes apart, so a warp's loads are not coalesced: at
// 4096 subsets the whole step is at most about 2.8 MB, which fits in the
// L2.
//
// Bit for bit with the plain version: the same op order, built with
// -fmad=false (no fused multiply-add), IEEE division (nvcc's default
// -prec-div=true, as PyTorch's CUDA division), the pivot as
// 1.0f / (float)sqrt((double)d) as torch.sqrt of a float64 tensor rounded
// to float32 and PyTorch's reciprocal; NaN-propagating maximum and clamps
// as torch.maximum and torch.clamp; the constants (precision, lambda_*)
// rounded to float32 by the launcher's caller, as PyTorch rounds a Python
// scalar against a float32 tensor.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kThreads = 128;

// ErrorCode (config.py).
constexpr int kNone = 0;
constexpr int kModelOutOfImage = 1;
constexpr int kInterpOutOfImage = 2;
constexpr int kMaxItersReached = 3;
constexpr int kBadDomain = 4;
constexpr int kSolver = 5;

__host__ __device__ constexpr int num_params(int model) {
  return model == 0 ? 1 : model == 1 ? 2 : model == 2 ? 3 : 6;
}

struct Args {
  const float* out;     // [n, 8, 8] by list position
  const int* idx;       // [n] subset indices
  const int* count;     // [1] the list's length, or null for n
  int n, num_subsets;
  const float* scaling;   // [S]
  const float* n_points;  // [S]
  const float* bbox;      // [S, 4, 2]
  const float* center;    // [S, 2]
  float x_max, y_max;     // img_w - 1, img_h - 1
  float* p_cur;           // [S, NP]
  float* p_lg;            // [S, NP]
  float* ab;              // [S, 8, 8]
  float* lam;             // [S]
  float* chi_lg;          // [S]
  int* iteration;         // [S]
  int* reached;           // [S]
  int* error;             // [S]
  unsigned char* active;     // [S] bool
  unsigned char* init_fail;  // [S] bool
  float precision, lambda_min, lambda_max, lambda_up, lambda_down;
  int max_iterations;
};

// torch.maximum and torch.clamp on CUDA: a NaN operand propagates.
__device__ __forceinline__ float nan_maximum(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

// ops/solve.lm_delta on one subset's Gram g (A at g[8i + j], b at
// g[8i + NP]), term for term.
template <int NP>
__device__ __forceinline__ void lm_delta(const float* g, float lam, float sc,
                                         float* x) {
  const float damp = 1.0f + lam;
  float a[NP][NP], b[NP], l[NP][NP], inv_d[NP], y[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      float e = g[8 * i + j] * sc;
      if (i == j) e = e * damp;
      a[i][j] = e;
    }
    b[i] = g[8 * i + NP] * sc;
  }
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    float d = a[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d = d - l[j][k] * l[j][k];
    const float inv = 1.0f / (float)sqrt((double)d);
    inv_d[j] = inv;
    l[j][j] = d * inv;
#pragma unroll
    for (int i = j + 1; i < NP; ++i) {
      float s = a[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - l[i][k] * l[j][k];
      l[i][j] = s * inv;
    }
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - l[i][k] * y[k];
    y[i] = s * inv_d[i];
  }
#pragma unroll
  for (int i = NP - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < NP; ++k) s = s - l[k][i] * x[k];
    x[i] = s * inv_d[i];
  }
}

// ops/solve.oob_code for subset s at parameters p: the four bounding-box
// corners warped as models/warp.warp_points does.
template <int MODEL>
__device__ __forceinline__ int oob_code(const Args& a, int s,
                                        const float* p) {
  const float cx = a.center[2 * s], cy = a.center[2 * s + 1];
  bool out = false;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float bx = a.bbox[(size_t)s * 8 + 2 * c];
    const float by = a.bbox[(size_t)s * 8 + 2 * c + 1];
    float x, y;
    if constexpr (MODEL == 0) {
      x = bx + p[0];
      y = by;
    } else if constexpr (MODEL == 1) {
      x = bx + p[0];
      y = by + p[1];
    } else {
      const float dx = bx - cx, dy = by - cy;
      if constexpr (MODEL == 2) {
        x = bx + p[0] - p[2] * dy;
        y = by + p[1] + p[2] * dx;
      } else {
        x = bx + p[0] + p[2] * dx + p[3] * dy;
        y = by + p[1] + p[4] * dx + p[5] * dy;
      }
    }
    out = out || !isfinite(x) || !isfinite(y) || x < 0.f || x > a.x_max ||
          y < 0.f || y > a.y_max;
  }
  return out ? kModelOutOfImage : kInterpOutOfImage;
}

template <int MODEL, bool INIT>
__global__ void __launch_bounds__(kThreads) lm_step_kernel(const Args a) {
  constexpr int NP = num_params(MODEL);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int n = a.count ? min(*a.count, a.n) : a.n;
  if (i >= n) return;
  const int s = a.idx[i];
  if ((unsigned)s >= (unsigned)a.num_subsets) {
    printf("lm_step: subset index %d outside [0, %d)\n", s, a.num_subsets);
    __trap();
  }
  const float* g = a.out + (size_t)i * 64;
  float* ab = a.ab + (size_t)s * 64;
  const float sc = a.scaling[s];
  float q[NP], dp[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) q[k] = a.p_cur[(size_t)s * NP + k];

  if constexpr (INIT) {
    const float chi0 = g[NP * 9] * sc;
    const bool interp_err = g[(NP + 1) * 9] > 0.f;
    lm_delta<NP>(g, a.lam[s], sc, dp);
    const bool nok = a.n_points[s] > 0.f;
    bool finite = true;
#pragma unroll
    for (int k = 0; k < NP; ++k) finite = finite && isfinite(dp[k]);
    const bool solver0 = !interp_err && nok && !finite;
    const bool fail = interp_err || !nok || solver0;
    a.error[s] = interp_err ? oob_code<MODEL>(a, s, q)
                 : !nok     ? kBadDomain
                 : solver0  ? kSolver
                            : kNone;
#pragma unroll
    for (int k = 0; k < NP; ++k)
      a.p_cur[(size_t)s * NP + k] = fail ? q[k] : q[k] + dp[k];
    a.chi_lg[s] = fail ? FLT_MAX : chi0;
    a.active[s] = !fail;
    a.init_fail[s] = fail;
#pragma unroll 8
    for (int e = 0; e < 64; ++e) ab[e] = g[e];
    return;
  } else {
    float plg[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) plg[k] = a.p_lg[(size_t)s * NP + k];
    const float lam_c = a.lam[s];
    const float lgc = a.chi_lg[s];
    const int it = a.iteration[s];

    const float chi = g[NP * 9] * sc;
    const bool err_now = g[(NP + 1) * 9] > 0.f;
    const float delta_chi =
        fabsf((lgc - chi) / (nan_maximum(lgc, chi) + a.precision));
    const bool converging = chi <= lgc;
    const float lam_next =
        converging ? clamp_min(lam_c * a.lambda_down, a.lambda_min)
                   : clamp_max(lam_c * a.lambda_up, a.lambda_max);
    lm_delta<NP>(converging ? g : ab, lam_next, sc, dp);
    float p_new[NP];
    bool finite = true;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      p_new[k] = (converging ? q[k] : plg[k]) + dp[k];
      finite = finite && isfinite(dp[k]);
    }
    const bool solver_now = !err_now && !finite;
    const bool do_step = !(err_now || solver_now);
    const bool converged = delta_chi < a.precision;
    const int next_iter = it + 1;
    const bool exhausted =
        next_iter > a.max_iterations || lam_next >= a.lambda_max;
    const bool accept = do_step && converging;

    // The out-of-image code reads the parameters before they are written.
    const int code = err_now      ? oob_code<MODEL>(a, s, q)
                     : solver_now ? kSolver
                     : do_step && exhausted && !converged ? kMaxItersReached
                                                          : a.error[s];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      a.p_cur[(size_t)s * NP + k] = do_step ? p_new[k] : q[k];
      a.p_lg[(size_t)s * NP + k] = accept ? q[k] : plg[k];
    }
    if (accept) {
#pragma unroll 8
      for (int e = 0; e < 64; ++e) ab[e] = g[e];
    }
    a.chi_lg[s] = accept ? chi : lgc;
    a.lam[s] = do_step ? lam_next : lam_c;
    a.iteration[s] = do_step ? next_iter : it;
    if (do_step) a.reached[s] = it;
    a.active[s] = do_step && !(converged || exhausted);
    a.error[s] = code;
  }
}

template <int MODEL>
cudaError_t launch(bool init, const Args& a, cudaStream_t stream) {
  const int blocks = (a.n + kThreads - 1) / kThreads;
  if (init)
    lm_step_kernel<MODEL, true><<<blocks, kThreads, 0, stream>>>(a);
  else
    lm_step_kernel<MODEL, false><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).  `count` is a
// device pointer to the list's length (at most n), or null for n; the
// grid covers n list positions.  The constants are float32, rounded by
// the caller.  Synchronises nothing.
int lm_step_launch(int model, int init, const float* out, const int* idx,
                   const int* count, int n, int num_subsets,
                   const float* scaling, const float* n_points,
                   const float* bbox, const float* center, int img_h,
                   int img_w, float* p_cur, float* p_lg, float* ab,
                   float* lam, float* chi_lg, int* iteration, int* reached,
                   int* error, unsigned char* active,
                   unsigned char* init_fail, float precision,
                   float lambda_min, float lambda_max, float lambda_up,
                   float lambda_down, int max_iterations, void* stream_ptr) {
  if (n <= 0) return 0;
  if (model < 0 || model > 3 || num_subsets <= 0)
    return (int)cudaErrorInvalidValue;
  // The plain version compares with the Python floats img_w - 1.0 and
  // img_h - 1.0, rounded to float32.
  const Args a{out,    idx,       count,     n,
               num_subsets,       scaling,   n_points,
               bbox,   center,    (float)((double)img_w - 1.0),
               (float)((double)img_h - 1.0),
               p_cur,  p_lg,      ab,        lam,
               chi_lg, iteration, reached,   error,
               active, init_fail, precision, lambda_min,
               lambda_max,        lambda_up, lambda_down,
               max_iterations};
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const bool first = init != 0;
  switch (model) {
    case 0: return launch<0>(first, a, stream);
    case 1: return launch<1>(first, a, stream);
    case 2: return launch<2>(first, a, stream);
    case 3: return launch<3>(first, a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
