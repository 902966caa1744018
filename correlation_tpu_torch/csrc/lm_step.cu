// The Levenberg-Marquardt step for Hopper (sm_90a): one LM iteration of a
// pyramid level, after the assembly, over a list of subsets, and the list
// of the subsets still active after it.
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
// With an output list (idx_next, count_next; a device count only) the
// same launch writes the listed subsets that are still active after the
// step, in list order, and their number: the next iteration's list.  The
// loop's lists start from a stable sort of the active flags, and only
// listed rows change, so this filter equals that sort on its first
// *count_next entries, and the sort runs once a level.
//
// What bounds it.  The work is a 6x6 solve and a few dozen scalars a
// subset; the bytes are a subset's 256-byte Gram, its state and, on a
// diverging or accepted step, its 256-byte cached Gram: about 2.3 MB at
// 4096 AFFINE subsets, 0.7 us at the HBM rate, under the ~1 us launch
// floor.  So latency bounds it: the chain of dependent reads, the
// Cholesky's serial pivots (a float64 sqrt and an IEEE division each),
// the scan across blocks, and how much of the card the grid covers.  The
// first design, one thread a subset, read each Gram as 64 scalars 256
// bytes apart across a warp (32 sectors a load instruction) on 32 blocks
// of the 132 SMs; on an H100 it took 0.0119 ms from HBM against 0.0081
// ms for this one with the next list, 0.0064 ms without it (PERF.md).
//
// What the design does.
//   - A team of kTeam = 8 lanes a subset, lane r holding row r of the
//     Gram: two 16-byte loads a lane, so a warp's four teams read 1 KB in
//     one coalesced run, and the cached Gram is read and written the same
//     way.  16 subsets a block of 128 threads: 256 blocks at 4096
//     subsets cover the 132 SMs twice.  At most 64 registers a thread
//     (kBlocksPerSM): 8 blocks an SM, so that the 1024 blocks of 16384
//     subsets run in one wave (the AFFINE step needs 66 uncapped, which
//     leaves room for 7, 924 blocks).
//   - The Cholesky is spread over the team column by column: lane r
//     computes row r of L, the pivot and row j of L reach the team by
//     __shfl_sync, and every lane forms the pivot's reciprocal from the
//     same value, so each element is the same float32 operations in the
//     same order as the plain version's.  The triangular solves run in
//     every lane on shuffled values.  The scalar logic runs in every lane
//     of the team on the same words (one transaction a warp); lane k
//     writes parameter k, lane 0 the scalars.
//   - The dependent reads are three: the list's length (the list entry
//     is read beside it), then the state, the fresh Gram, the error code
//     and the out-of-image test's box (40 bytes a subset, read whether or
//     not the step finds an interpolation error), then a diverging
//     step's cached Gram.  Reading the cached Gram with the fresh one,
//     before the step knows whether it diverges (256 more bytes a
//     converging subset), saved nothing at 4096 subsets and was slower
//     at 16384, so it waits.
//   - The next list is a stable compaction across blocks in the same
//     launch: a warp ballot orders a block's kept subsets, and the
//     block's offset is read in one round, as in a single-pass scan with
//     look-back (CUB's), relying as it does on blocks starting in index
//     order: each block publishes its kept count in a flag and adds it
//     to the word of its group of 32 blocks, then sums the flags of its
//     group's earlier blocks and the words of the earlier groups (at
//     most 31 + 32 reads up to 16384 subsets).  Every block finishes its
//     step at about the same time, so a look-back that walks back to the
//     nearest inclusive prefix needs one round for each 32 blocks it
//     passes (8 at 4096 subsets: 0.0047 ms of a 0.0115 ms step), and one
//     that reads 256 flags a round contends on them (0.0107 ms).  Flags
//     carry the launch's epoch and the group words alternate with its
//     parity, so no memset, fence or ticket is needed between launches
//     or graph replays.
//   - Blocks past the list's length exit at once: an iteration whose
//     list is empty costs a launch whose blocks read the count and exit,
//     the first writing a zero count.
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

constexpr int kTeam = 8;                 // lanes a subset, one a Gram row
constexpr int kThreads = 128;            // a block
constexpr int kTile = kThreads / kTeam;  // subsets a block
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 8;
constexpr unsigned kFull = 0xffffffffu;

// A block's flag: bit 62 set once published, the launch's epoch in bits
// 32-61 and the block's kept count in the low 32; a flag of another epoch
// is not published yet.  The workspace holds flag_capacity flags, then
// two sets of flag_capacity / kGroup group words (one an epoch parity),
// then the epoch.
constexpr unsigned long long kPublished = 1ull << 62;
constexpr unsigned kEpochMask = (1u << 30) - 1;
constexpr int kGroup = 32;  // blocks a group word counts

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
  int* idx_next;     // [n] the next list, or null
  int* count_next;   // [1] its length
  unsigned long long* flags;  // the workspace: flags, group words, epoch
  int flag_capacity;
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

// Lane `src` of the caller's team.
__device__ __forceinline__ float from_lane(float v, int src) {
  return __shfl_sync(kFull, v, src, kTeam);
}

__device__ __forceinline__ void load_row(const float* p, float (&r)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

__device__ __forceinline__ void store_row(float* p, const float (&r)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(r[4], r[5], r[6], r[7]);
}

// ops/solve.lm_delta over a team: lane r holds row r of the Gram (A at
// row[j], b at row[NP]); every lane returns the whole solution x.  Lane r
// computes row r of L, each element term for term as the one-thread
// Cholesky does; lanes past NP compute rows that nothing reads.
template <int NP>
__device__ __forceinline__ void team_lm_delta(const float (&row)[8],
                                              float lam, float sc, int lane,
                                              float (&x)[NP]) {
  const float damp = 1.0f + lam;
  float a[NP], l[NP], inv_d[NP], y[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    float e = row[k] * sc;
    if (k == lane) e = e * damp;
    a[k] = e;
  }
  const float b = row[NP] * sc;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    // Lane j: the pivot d; lane r > j: the sum of L[r][j].
    float s = a[j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - l[k] * from_lane(l[k], j);
    const float inv = 1.0f / (float)sqrt((double)from_lane(s, j));
    inv_d[j] = inv;
    l[j] = s * inv;
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float t = b;
#pragma unroll
    for (int k = 0; k < i; ++k) t = t - l[k] * y[k];
    y[i] = from_lane(t, i) * inv_d[i];
  }
#pragma unroll
  for (int i = NP - 1; i >= 0; --i) {
    float t = y[i];
#pragma unroll
    for (int k = i + 1; k < NP; ++k) t = t - from_lane(l[i], k) * x[k];
    x[i] = t * inv_d[i];
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

// Element `lane` of v (lane < NP), without indexing registers at run time.
template <int NP>
__device__ __forceinline__ float pick(const float (&v)[NP], int lane) {
  float r = 0.f;
#pragma unroll
  for (int k = 0; k < NP; ++k) r = lane == k ? v[k] : r;
  return r;
}

__device__ __forceinline__ unsigned long long load_flag(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ bool published(unsigned long long f,
                                          unsigned epoch) {
  return (f & kPublished) && (unsigned)(f >> 32 & kEpochMask) == epoch;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Every thread of a participating block: write the team's subset s to
// the next list where `keep` holds, in list order across the grid, and
// the list's length from the block that holds the last position.
//
// A block's offset is the kept count of the blocks before it, read in
// one round: each block publishes its count in its flag (tagged with the
// launch's epoch) and adds it to its group's word (kGroup blocks: the
// blocks counted in the high half, their sum in the low); warp 0 reads
// the flags of the group's earlier blocks, warp 1 the words of the
// earlier groups, each waiting until they are whole.  A block waits only
// on blocks before it.  The group words of the launch's epoch start at
// zero: block 0 zeroes the other epoch's, which the launch before used.
// The last block moves the epoch on once every block has read it (each
// has published into a flag or a group word that it waited for), and
// every block zeroes some flags past the grid, which no block of this
// launch reads, so that a later launch finds each flag of the epoch
// before its own, or zero.
__device__ __forceinline__ void write_list(const Args& a, int tiles,
                                           unsigned epoch, bool keep, int s,
                                           int lane) {
  __shared__ int warp_kept[kWarps];
  __shared__ int part[2];  // kept before this block: in its group, before it
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  const unsigned leaders = __ballot_sync(kFull, keep && lane == 0);
  if (wl == 0) warp_kept[warp] = __popc(leaders);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? warp_kept[w] : 0;
    total += warp_kept[w];
  }
  const int b = blockIdx.x, g = b / kGroup;
  const int cap = a.flag_capacity, words = cap / kGroup;
  unsigned long long* flags = a.flags;
  unsigned long long* groups = flags + cap + (epoch & 1) * words;
  if (threadIdx.x == 0) {
    *reinterpret_cast<volatile unsigned long long*>(flags + b) =
        kPublished | (unsigned long long)epoch << 32 | (unsigned)total;
    atomicAdd(groups + g, 1ull << 32 | (unsigned)total);
  }
  if (warp == 0) {
    const int j = g * kGroup + wl;
    int v = 0;
    if (j < b) {
      unsigned long long f;
      do {
        f = load_flag(flags + j);
      } while (!published(f, epoch));
      v = (int)(unsigned)f;
    }
    v = warp_sum(v);
    if (wl == 0) part[0] = v;
  } else if (warp == 1) {
    int v = 0;
    for (int h = wl; h < g; h += 32) {
      unsigned long long w;
      do {
        w = load_flag(groups + h);
      } while (w >> 32 != kGroup);
      v += (int)(unsigned)w;
    }
    v = warp_sum(v);
    if (wl == 0) part[1] = v;
  } else if (warp == 2 && b == 0) {
    unsigned long long* other = flags + cap + ((epoch + 1) & 1) * words;
    for (int h = wl; h < words; h += 32) other[h] = 0;
  }
  for (long long j = tiles + b + (long long)threadIdx.x * tiles; j < cap;
       j += (long long)kThreads * tiles)
    flags[j] = 0;
  __syncthreads();
  const int exclusive = part[0] + part[1];
  if (threadIdx.x == 0 && b == tiles - 1) {
    *a.count_next = exclusive + total;
    *reinterpret_cast<volatile unsigned*>(flags + cap + 2 * words) =
        (epoch + 1) & kEpochMask;
  }
  if (keep && lane == 0)
    a.idx_next[exclusive + before + __popc(leaders & ((1u << wl) - 1))] = s;
}

// At most 64 registers a thread, so that 8 blocks fit on an SM and the
// 1024 blocks of 16384 subsets run in one wave.
template <int MODEL, bool INIT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    lm_step_kernel(const Args a) {
  constexpr int NP = num_params(MODEL);
  const int lane = threadIdx.x % kTeam;
  const int i = blockIdx.x * kTile + threadIdx.x / kTeam;
  // The list entry is read beside the length, not after it: both lie in
  // the list's room of n entries.
  const int entry = a.idx[min(i, a.n - 1)];
  const int n = a.count ? min(*a.count, a.n) : a.n;
  const int tiles = (n + kTile - 1) / kTile;  // blocks that step a subset
  if ((int)blockIdx.x >= tiles) {
    if (blockIdx.x == 0 && threadIdx.x == 0 && a.idx_next) *a.count_next = 0;
    return;
  }
  // No thread of a stepping block returns early: its teams shuffle and
  // its threads meet at write_list's barriers.  A team past the list's
  // end reads position 0 and subset 0 (n >= 1 here) and writes nothing.
  const bool listed = i < n;
  const int s = listed ? entry : 0;
  if ((unsigned)s >= (unsigned)a.num_subsets) {
    if (lane == 0)
      printf("lm_step: subset index %d outside [0, %d)\n", s, a.num_subsets);
    __trap();
  }
  const unsigned epoch =
      a.idx_next ? *reinterpret_cast<const volatile unsigned*>(
                       a.flags + a.flag_capacity +
                       2 * (a.flag_capacity / kGroup))
                 : 0u;
  float g[8];
  load_row(a.out + (size_t)(listed ? i : 0) * 64 + lane * 8, g);
  float* ab = a.ab + (size_t)s * 64 + lane * 8;  // this lane's cached row
  const float sc = a.scaling[s];
  float q[NP], dp[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) q[k] = a.p_cur[(size_t)s * NP + k];
  // The out-of-image code, read and computed beside the state rather
  // than after the step finds an interpolation error: one dependent read
  // less at the end, for 40 bytes a subset.
  const int oob = oob_code<MODEL>(a, s, q);
  const float chi_raw = from_lane(g[NP], NP);      // out[i][NP][NP]
  const float bad = from_lane(g[NP + 1], NP + 1);  // out[i][NP+1][NP+1]
  bool keep;

  if constexpr (INIT) {
    const float chi0 = chi_raw * sc;
    const bool interp_err = bad > 0.f;
    team_lm_delta<NP>(g, a.lam[s], sc, lane, dp);
    const bool nok = a.n_points[s] > 0.f;
    bool finite = true;
#pragma unroll
    for (int k = 0; k < NP; ++k) finite = finite && isfinite(dp[k]);
    const bool solver0 = !interp_err && nok && !finite;
    const bool fail = interp_err || !nok || solver0;
    keep = listed && !fail;
    if (listed) {
      if (lane < NP) {
        const float qk = pick<NP>(q, lane);
        a.p_cur[(size_t)s * NP + lane] = fail ? qk : qk + pick<NP>(dp, lane);
      }
      store_row(ab, g);
      if (lane == 0) {
        a.error[s] = interp_err ? oob
                     : !nok     ? kBadDomain
                     : solver0  ? kSolver
                                : kNone;
        a.chi_lg[s] = fail ? FLT_MAX : chi0;
        a.active[s] = !fail;
        a.init_fail[s] = fail;
      }
    }
  } else {
    float plg[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) plg[k] = a.p_lg[(size_t)s * NP + k];
    const float lam_c = a.lam[s];
    const float lgc = a.chi_lg[s];
    const int it = a.iteration[s];
    const int code_before = a.error[s];

    const float chi = chi_raw * sc;
    const bool err_now = bad > 0.f;
    const float delta_chi =
        fabsf((lgc - chi) / (nan_maximum(lgc, chi) + a.precision));
    const bool converging = chi <= lgc;
    const float lam_next =
        converging ? clamp_min(lam_c * a.lambda_down, a.lambda_min)
                   : clamp_max(lam_c * a.lambda_up, a.lambda_max);
    float sel[8];
    if (converging || !listed) {
#pragma unroll
      for (int e = 0; e < 8; ++e) sel[e] = g[e];
    } else {
      load_row(ab, sel);
    }
    team_lm_delta<NP>(sel, lam_next, sc, lane, dp);
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
    const bool still = do_step && !(converged || exhausted);
    keep = listed && still;

    if (listed) {
      if (lane < NP) {
        const float qk = pick<NP>(q, lane);
        a.p_cur[(size_t)s * NP + lane] = do_step ? pick<NP>(p_new, lane) : qk;
        a.p_lg[(size_t)s * NP + lane] = accept ? qk : pick<NP>(plg, lane);
      }
      if (accept) store_row(ab, g);
      if (lane == 0) {
        // The out-of-image code is of the parameters before the step.
        a.error[s] = err_now      ? oob
                     : solver_now ? kSolver
                     : do_step && exhausted && !converged ? kMaxItersReached
                                                          : code_before;
        a.chi_lg[s] = accept ? chi : lgc;
        a.lam[s] = do_step ? lam_next : lam_c;
        a.iteration[s] = do_step ? next_iter : it;
        if (do_step) a.reached[s] = it;
        a.active[s] = still;
      }
    }
  }
  if (a.idx_next) write_list(a, tiles, epoch, keep, s, lane);
}

template <int MODEL>
cudaError_t launch(bool init, const Args& a, int blocks,
                   cudaStream_t stream) {
  if (init)
    lm_step_kernel<MODEL, true><<<blocks, kThreads, 0, stream>>>(a);
  else
    lm_step_kernel<MODEL, false><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The flags a launch over n list positions needs: one a block.
int lm_step_flags(int n) { return n > 0 ? (n + kTile - 1) / kTile : 0; }

// The 64-bit words of a workspace of `flags` flags: the flags, two sets
// of group words and the epoch.
int lm_step_workspace_words(int flags) {
  return flags + 2 * (flags / kGroup) + 1;
}

// Returns the cudaError_t of the launch (0 on success).  `count` is a
// device pointer to the list's length (at most n), or null for n; the
// grid covers n list positions.  With `idx_next` (room for n entries) and
// `count_next` the launch also writes the next list and its length; that
// needs `count` and a workspace `flags` of lm_step_workspace_words(
// flag_capacity) 64-bit words, flag_capacity a multiple of 32 and at
// least lm_step_flags(n), zeroed before its first launch and left to the
// kernel after it (launches that share one are ordered on one stream).  `out` and `ab` 16-byte aligned.  The constants
// are float32, rounded by the caller.  Synchronises nothing.
int lm_step_launch(int model, int init, const float* out, const int* idx,
                   const int* count, int n, int num_subsets,
                   const float* scaling, const float* n_points,
                   const float* bbox, const float* center, int img_h,
                   int img_w, float* p_cur, float* p_lg, float* ab,
                   float* lam, float* chi_lg, int* iteration, int* reached,
                   int* error, unsigned char* active,
                   unsigned char* init_fail, float precision,
                   float lambda_min, float lambda_max, float lambda_up,
                   float lambda_down, int max_iterations, int* idx_next,
                   int* count_next, unsigned long long* flags,
                   int flag_capacity, void* stream_ptr) {
  if (n <= 0) return 0;
  const int blocks = (n + kTile - 1) / kTile;
  if (model < 0 || model > 3 || num_subsets <= 0 ||
      (reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(ab)) %
          16)
    return (int)cudaErrorInvalidValue;
  if (idx_next &&
      (!count || !count_next || !flags || flag_capacity < blocks ||
       flag_capacity % kGroup))
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
               max_iterations,    idx_next,  count_next,
               flags,  flag_capacity};
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const bool first = init != 0;
  switch (model) {
    case 0: return launch<0>(first, a, blocks, stream);
    case 1: return launch<1>(first, a, blocks, stream);
    case 2: return launch<2>(first, a, blocks, stream);
    case 3: return launch<3>(first, a, blocks, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
