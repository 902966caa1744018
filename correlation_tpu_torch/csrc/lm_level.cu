// One pyramid level's LM loop on a device list, as one CUDA graph launch.
//
// On the card correlation_tpu_torch/engine.py::solve_level runs a level
// as the initial step and at most max_iterations + 2 iterations (the JAX
// loop's step bound).  Step k is K1 (fused_assemble.cu) on the current
// list into `out`, then the LM step (lm_step.cu) on the same list, which
// writes the listed subsets still active, the next step's list, and
// their number.  The plain loop stops at the first empty list; issued
// from the host without reading the device, every level would issue all
// its steps, 86-94% of them on empty lists at the benchmark's cells.
//
// lm_level_launch issues the level as one launch of a graph made of:
//   - the initial step: K1 on the first list, the LM step (init) writing
//     the next list into lists row 1 and its length into a word of the
//     graph's own;
//   - level_control (below): makes that list current (copies it into
//     lists row 0, its length into the current length's word), writes
//     the step's row of `counts` and moves a device step counter on, and
//     sets the loop's condition: the list is not empty and a step is
//     left of the bound;
//   - a conditional WHILE node whose body is one iteration: K1 and the
//     LM step on lists row 0, writing row 1, then level_control.
// So the device stops the loop at the first empty list, where the plain
// loop stops, and the host issues one launch a level.  K1 and the LM step
// are captured from fused_assemble_issue and lm_step_launch on a stream
// the library owns: the kernels, grids, blocks, shared memory and
// arguments of the per-step wrappers (ops/assemble_v2.py::fused_assemble,
// ops/solve.py::lm_step), so the results equal theirs bit for bit.  The
// LM step's scan workspace carries its epoch on the device, so it takes
// any number of launches.
//
// An executable graph is kept for each key that its launches cannot
// change (device, model, interpolation, channels, K1's path and span
// rule, padded pixels, tile, list room n, steps); only a new key
// instantiates one.  Every other level captures K1 and the LM step of the
// initial step and of the body again, into a template, and sets their
// nodes' arguments in the executable graph node by node, and the control
// kernels' directly (as cheap as cudaGraphExecUpdate from a whole
// template on an H100 with CUDA 12.8, and fewer calls).  Synchronises
// nothing and allocates no memory but a graph's own words (cudaMalloc,
// once a graph).
//
// The last level_control of a level adds the steps it ran to a total of
// its graph's; lm_level_steps copies the totals into a device buffer, so
// that the launch counters (ops/solve.py::resolve_launches) count the
// steps that ran.

#include <cuda_runtime.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <vector>

extern "C" {

int fused_assemble_plan(int model, int interp, int c, int threads,
                        int chunk, const float* img, int hp, int wp,
                        int img_h, int img_w, const float* pix, int p_len,
                        const float* center, const float* params,
                        const float* bbox, const int* idx, const int* count,
                        int n, int num_subsets, int tile_h, int tile_w,
                        float* work, long long work_floats, float* out,
                        void** plan);
int fused_assemble_issue(void* plan, const int* idx, const int* count,
                         void* stream_ptr);
void fused_assemble_plan_free(void* plan);
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
                   int flag_capacity, void* stream_ptr);

}  // extern "C"

namespace {

constexpr int kControlThreads = 256;
constexpr int kControlBlocks = 32;

// The graph's own words: the current list's length, the next list's
// length (the LM step writes it) and the level's steps run so far; then,
// 8-byte aligned, the steps its levels ran in all (unsigned long long).
enum Word { kCurCount, kNextCount, kStep, kRun = 4 };
constexpr size_t kWordBytes =
    kRun * sizeof(int) + sizeof(unsigned long long);

// Where a call failed (info[0]), and what it did (info[3]).
enum Stage { kOk, kPlan, kCapture, kInstantiate, kUpdate, kLaunch };
enum Made { kUpdated, kInstantiated };
enum Kernel { kNoKernel = -1, kK1, kLmStep, kControl };

// After step k (k = 0 where `first`): the next list, `next`[:c] with c =
// words[kNextCount], becomes current (`cur`, words[kCurCount]); counts[k]
// is c when the loop goes on, else -1, as is every row after it (filled
// by the first call); the loop goes on while c > 0 and a step is left.
// Where it stops, the level's k + 1 steps are added to `run`.
__global__ void level_control(int* words, unsigned long long* run,
                              int* counts, int steps, const int* next,
                              int* cur, int first,
                              cudaGraphConditionalHandle loop) {
  const int c = words[kNextCount];
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  for (int i = tid; i < c; i += stride) cur[i] = next[i];
  if (first)
    for (int i = 1 + tid; i < steps; i += stride) counts[i] = -1;
  if (tid == 0) {
    const int k = first ? 0 : words[kStep];
    const bool go = c > 0 && k + 1 < steps;
    counts[k] = go ? c : -1;
    words[kCurCount] = c;
    words[kStep] = k + 1;
    if (!go) *run += k + 1;
    cudaGraphSetConditional(loop, go ? 1u : 0u);
  }
}

// level_control's arguments, as a kernel node's parameters.
struct Control {
  int* words;
  unsigned long long* run;
  int* counts;
  int steps;
  const int* next;
  int* cur;
  int first;
  cudaGraphConditionalHandle loop;
  void* args[8];

  cudaKernelNodeParams params(int blocks) {
    void* const at[8] = {&words, &run,  &counts, &steps,
                         &next,  &cur,  &first,  &loop};
    std::copy(at, at + 8, args);
    cudaKernelNodeParams p = {};
    p.func = (void*)level_control;
    p.gridDim = dim3(blocks);
    p.blockDim = dim3(kControlThreads);
    p.kernelParams = args;
    return p;
  }
};

// One key's executable graph.
struct Loop {
  cudaGraph_t graph = nullptr;  // instantiated from; its nodes name exec's
  cudaGraphExec_t exec = nullptr;
  cudaGraphConditionalHandle handle = 0;
  std::vector<cudaGraphNode_t> kernels;  // the initial part's, the body's
  int* words = nullptr;  // kWordBytes
  int id = 0;  // the order it was made in
};

std::mutex g_mutex;
std::map<std::vector<int>, Loop> g_loops;
int g_made = 0;  // Loops made
std::map<int, cudaStream_t> g_streams;  // a capture stream a device

unsigned long long* run_total(const Loop& loop) {
  return (unsigned long long*)(loop.words + kRun);
}

// The kernel nodes of a graph whose nodes form one chain, in order.
cudaError_t chain(cudaGraph_t g, std::vector<cudaGraphNode_t>& out) {
  cudaGraphNode_t node[2];
  size_t n = 2;
  cudaError_t e = cudaGraphGetRootNodes(g, node, &n);
  if (e != cudaSuccess) return e;
  if (n != 1) return cudaErrorInvalidValue;
  for (cudaGraphNode_t at = node[0];;) {
    cudaGraphNodeType type;
    if ((e = cudaGraphNodeGetType(at, &type)) != cudaSuccess) return e;
    if (type == cudaGraphNodeTypeKernel) out.push_back(at);
    n = 2;
    if ((e = cudaGraphNodeGetDependentNodes(at, node, &n)) != cudaSuccess)
      return e;
    if (n == 0) return cudaSuccess;
    if (n != 1) return cudaErrorInvalidValue;
    at = node[0];
  }
}

// Captures issue(stream) into the graph g on `stream`; the first error.
template <typename Issue>
cudaError_t capture(cudaStream_t stream, cudaGraph_t g, Issue issue) {
  cudaError_t e = cudaStreamBeginCaptureToGraph(
      stream, g, nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) return e;
  const cudaError_t rc = issue(stream);
  cudaGraph_t same;
  e = cudaStreamEndCapture(stream, &same);
  return rc != cudaSuccess ? rc : e;
}

cudaError_t capture_stream(int device, cudaStream_t* out) {
  auto it = g_streams.find(device);
  if (it == g_streams.end()) {
    cudaStream_t s;
    const cudaError_t e =
        cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
    if (e != cudaSuccess) return e;
    it = g_streams.emplace(device, s).first;
  }
  *out = it->second;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The first arguments are fused_assemble_launch's but the stream: K1 of
// step 0 on the first list `idx` of length *count and room n, into `out`,
// at the parameters `params` (the state's p_cur).  Then lm_step_launch's
// state arguments, from `scaling` to `max_iterations`, and its scan
// workspace (`flags`, `flag_capacity`); the step reads the model, `out`,
// n and num_subsets of K1's.  `lists` is [2, n] int32, work rows the
// graph overwrites; `counts` [steps, 1] int32: counts[k] is step k's next
// length where step k + 1 runs, else -1.  Enqueues the level on
// `stream_ptr`.  Returns the first cudaError_t (0 on success); `info`
// (int[4]) gets the stage it came from in info[0] (Stage), the step
// whose capture failed in info[1] (0 the initial step, 1 the loop's
// body) and the kernel in info[2] (Kernel), and in info[3] whether the
// graph was updated or instantiated (Made).
int lm_level_launch(int model, int interp, int c, int threads, int chunk,
                    const float* img, int hp, int wp, int img_h, int img_w,
                    const float* pix, int p_len, const float* center,
                    const float* params, const float* bbox, const int* idx,
                    const int* count, int n, int num_subsets, int tile_h,
                    int tile_w, float* work, long long work_floats,
                    float* out, const float* scaling, const float* n_points,
                    const float* step_bbox, const float* step_center,
                    int step_img_h, int step_img_w, float* p_cur,
                    float* p_lg, float* ab, float* lam, float* chi_lg,
                    int* iteration, int* reached, int* error,
                    unsigned char* active, unsigned char* init_fail,
                    float precision, float lambda_min, float lambda_max,
                    float lambda_up, float lambda_down, int max_iterations,
                    unsigned long long* flags, int flag_capacity,
                    int* lists, int* counts, int steps, int* info,
                    void* stream_ptr) {
  info[0] = kOk;
  info[1] = 0;
  info[2] = kNoKernel;
  info[3] = kUpdated;
  if (steps <= 0 || n <= 0 || !count) return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(g_mutex);
  int device;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  Loop& loop = g_loops[{device, model, interp, c, threads, chunk, p_len, n,
                        tile_h, tile_w, steps}];
  if (!loop.words) loop.id = g_made++;
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  auto fail = [&](int stage, cudaError_t rc) {
    info[0] = stage;
    return (int)rc;
  };

  void* plan = nullptr;
  int rc = fused_assemble_plan(model, interp, c, threads, chunk, img, hp,
                               wp, img_h, img_w, pix, p_len, center, params,
                               bbox, idx, count, n, num_subsets, tile_h,
                               tile_w, work, work_floats, out, &plan);
  if (rc) {
    info[2] = kK1;
    return fail(kPlan, (cudaError_t)rc);
  }
  cudaStream_t cap;
  if ((e = capture_stream(device, &cap)) != cudaSuccess) {
    fused_assemble_plan_free(plan);
    return fail(kCapture, e);
  }
  if (!loop.words &&
      ((e = cudaMalloc(&loop.words, kWordBytes)) != cudaSuccess ||
       (e = cudaMemsetAsync(loop.words, 0, kWordBytes, stream)) !=
           cudaSuccess)) {
    fused_assemble_plan_free(plan);
    return fail(kInstantiate, e);
  }
  int* const own = loop.words;
  unsigned long long* const run = run_total(loop);
  int* const row0 = lists;
  int* const row1 = lists + (size_t)n;
  const int blocks = (int)std::min<long long>(
      kControlBlocks,
      ((long long)std::max(n, steps) + kControlThreads - 1) /
          kControlThreads);
  // Step k's launches on `s`: K1 on the current list (the first list
  // where `first`, else row 0) and the LM step writing row 1, then, where
  // `control`, level_control with the handle `h`.  Marks the failing
  // kernel in info.
  auto step = [&](cudaStream_t s, int first, bool control,
                  cudaGraphConditionalHandle h) {
    const int* cur = first ? idx : row0;
    const int* cur_count = first ? count : own + kCurCount;
    info[1] = !first;
    info[2] = kK1;
    int r = fused_assemble_issue(plan, cur, cur_count, s);
    if (r) return (cudaError_t)r;
    info[2] = kLmStep;
    r = lm_step_launch(model, first, out, cur, cur_count, n, num_subsets,
                       scaling, n_points, step_bbox, step_center,
                       step_img_h, step_img_w, p_cur, p_lg, ab, lam, chi_lg,
                       iteration, reached, error, active, init_fail,
                       precision, lambda_min, lambda_max, lambda_up,
                       lambda_down, max_iterations, row1, own + kNextCount,
                       flags, flag_capacity, s);
    if (r) return (cudaError_t)r;
    info[2] = kNoKernel;
    if (!control) return cudaSuccess;
    info[2] = kControl;
    level_control<<<blocks, kControlThreads, 0, s>>>(
        own, run, counts, steps, row1, row0, first, h);
    const cudaError_t last = cudaGetLastError();
    if (last == cudaSuccess) info[2] = kNoKernel;
    return last;
  };
  auto initial = [&](cudaGraphConditionalHandle h) {
    return [&step, h](cudaStream_t s) { return step(s, 1, true, h); };
  };
  auto body = [&](cudaGraphConditionalHandle h) {
    return [&step, h](cudaStream_t s) { return step(s, 0, true, h); };
  };
  // The whole graph into *g: the initial step, then the WHILE node over
  // the body, on the handle *h; its kernel nodes in order into *kernels.
  auto build = [&](cudaGraph_t* g, cudaGraphConditionalHandle* h,
                   std::vector<cudaGraphNode_t>* kernels) {
    cudaError_t r = cudaGraphCreate(g, 0);
    if (r != cudaSuccess) return r;
    if ((r = cudaGraphConditionalHandleCreate(
             h, *g, 0, cudaGraphCondAssignDefault)) != cudaSuccess)
      return r;
    if ((r = capture(cap, *g, initial(*h))) != cudaSuccess) return r;
    if ((r = chain(*g, *kernels)) != cudaSuccess) return r;
    cudaGraphNodeParams cond = {};
    cond.type = cudaGraphNodeTypeConditional;
    cond.conditional.handle = *h;
    cond.conditional.type = cudaGraphCondTypeWhile;
    cond.conditional.size = 1;
    cudaGraphNode_t node;
    cudaGraphNode_t last = kernels->back();
    if ((r = cudaGraphAddNode(&node, *g, &last, 1, &cond)) != cudaSuccess)
      return r;
    const cudaGraph_t inner = cond.conditional.phGraph_out[0];
    if ((r = capture(cap, inner, body(*h))) != cudaSuccess) return r;
    return chain(inner, *kernels);
  };

  int stage;
  if (loop.exec) {
    // K1 and the LM step of the initial step and of the body captured
    // into one template, their arguments set node by node in the
    // executable graph; the two control kernels' set directly.
    std::vector<cudaGraphNode_t> kernels;
    cudaGraph_t t = nullptr;
    stage = kCapture;
    if ((e = cudaGraphCreate(&t, 0)) == cudaSuccess &&
        (e = capture(cap, t, [&step](cudaStream_t s) {
           const cudaError_t r = step(s, 1, false, 0);
           return r != cudaSuccess ? r : step(s, 0, false, 0);
         })) == cudaSuccess &&
        (e = chain(t, kernels)) == cudaSuccess) {
      stage = kUpdate;
      const size_t m = kernels.size() / 2;  // K1's and the step's a step
      if (kernels.size() != 2 * m || loop.kernels.size() != 2 * m + 2)
        e = cudaErrorInvalidValue;
      Control control[2] = {
          {own, run, counts, steps, row1, row0, 1, loop.handle},
          {own, run, counts, steps, row1, row0, 0, loop.handle}};
      for (size_t i = 0; e == cudaSuccess && i < 2 * m + 2; ++i) {
        const size_t part = i / (m + 1), at = i % (m + 1);
        cudaKernelNodeParams p;
        if (at == m)
          p = control[part].params(blocks);
        else
          e = cudaGraphKernelNodeGetParams(kernels[part * m + at], &p);
        if (e == cudaSuccess)
          e = cudaGraphExecKernelNodeSetParams(loop.exec, loop.kernels[i],
                                               &p);
      }
    }
    if (t) cudaGraphDestroy(t);
    info[3] = kUpdated;
  } else {
    std::vector<cudaGraphNode_t> kernels;
    cudaGraph_t g = nullptr;
    cudaGraphConditionalHandle h = 0;
    e = build(&g, &h, &kernels);
    stage = kCapture;
    if (e == cudaSuccess) {
      stage = kInstantiate;
      e = cudaGraphInstantiate(&loop.exec, g, 0);
    }
    if (e == cudaSuccess) {
      loop.graph = g;
      loop.handle = h;
      loop.kernels = std::move(kernels);
      info[3] = kInstantiated;
    } else {
      loop.exec = nullptr;
      if (g) cudaGraphDestroy(g);
    }
  }
  fused_assemble_plan_free(plan);
  if (e != cudaSuccess) return fail(stage, e);
  e = cudaGraphLaunch(loop.exec, stream);
  return e != cudaSuccess ? fail(kLaunch, e) : 0;
}

// The graphs on the current device, up to `cap` of them: a row of
// (graph id, padded pixels, tile_h, tile_w, list room n) each into
// `rows`, and into totals[i] (device memory) the steps the graph has run
// in all, copied on `stream_ptr` (after the graphs launched before it
// there).  Returns the number of graphs on the device, which may pass
// `cap`, or minus a cudaError_t.
int lm_level_steps(long long* rows, unsigned long long* totals, int cap,
                   void* stream_ptr) {
  std::lock_guard<std::mutex> lock(g_mutex);
  int device;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return -(int)e;
  int m = 0;
  for (auto& [key, loop] : g_loops) {
    if (key[0] != device || !loop.words) continue;
    if (m < cap) {
      const long long row[5] = {loop.id, key[6], key[8], key[9], key[7]};
      std::copy(row, row + 5, rows + 5 * m);
      e = cudaMemcpyAsync(totals + m, run_total(loop), sizeof *totals,
                          cudaMemcpyDeviceToDevice,
                          (cudaStream_t)stream_ptr);
      if (e != cudaSuccess) return -(int)e;
    }
    ++m;
  }
  return m;
}

}  // extern "C"
