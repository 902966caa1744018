// One pyramid level's LM loop on a device list, issued by one call.
//
// On the card correlation_tpu_torch/engine.py::solve_level runs a level
// as the initial step and max_iterations + 2 iterations (the JAX loop's
// step bound).  Step k is K1 (fused_assemble.cu) on the current list into
// `out`, then the LM step (lm_step.cu) on the same list, which writes the
// listed subsets still active into row k % 2 of two alternating list rows
// and their number into row k of a counts buffer: the next step's list.
// Nothing in the loop reads the device, so the level's launches are fixed
// before the first one is issued.  lm_level_launch issues them from C, in
// the same order, on the same stream, with the same grids, blocks and
// arguments as the two Python wrappers a step (ops/assemble_v2.py::
// fused_assemble, ops/solve.py::lm_step), which cost about 0.11 ms of host
// time a step against about 0.005 ms of device time for an empty one.
// K1's path, shared memory and opt-in are planned once a level.  The
// kernels are not changed, so the results equal the per-step loop's bit
// for bit.  Synchronises nothing.

#include <cuda_runtime.h>

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

// The first arguments are fused_assemble_launch's but the stream: K1 of
// step 0 on the first list `idx` of length *count and room n, into `out`,
// at the parameters `params` (the state's p_cur).  Then lm_step_launch's
// state arguments, from `scaling` to `max_iterations`, and its scan
// workspace (`flags`, `flag_capacity`); the step reads the model, `out`,
// n and num_subsets of K1's.  `lists` is [2, n] int32, the alternating
// list rows, and `counts` [steps, 1] int32; step k (init for k = 0)
// reads the list K1 read and writes lists[k % 2] and counts[k].  Returns
// the first cudaError_t (0 on success), with the step it came from in
// failed[0] and in failed[1] 0 for K1, 1 for the LM step; nothing after
// it is issued.
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
                    int* lists, int* counts, int steps, int* failed,
                    void* stream_ptr) {
  failed[0] = 0;
  failed[1] = 0;
  if (steps <= 0 || !count) return (int)cudaErrorInvalidValue;
  void* plan = nullptr;
  int rc = fused_assemble_plan(model, interp, c, threads, chunk, img, hp,
                               wp, img_h, img_w, pix, p_len, center, params,
                               bbox, idx, count, n, num_subsets, tile_h,
                               tile_w, work, work_floats, out, &plan);
  if (rc) return rc;
  const int* cur = idx;
  const int* cur_count = count;
  for (int k = 0; k < steps; ++k) {
    int* next = lists + (size_t)(k % 2) * n;
    int* next_count = counts + k;
    failed[0] = k;
    failed[1] = 0;
    rc = fused_assemble_issue(plan, cur, cur_count, stream_ptr);
    if (rc) break;
    failed[1] = 1;
    rc = lm_step_launch(model, k == 0, out, cur, cur_count, n, num_subsets,
                        scaling, n_points, step_bbox, step_center,
                        step_img_h, step_img_w, p_cur, p_lg, ab, lam, chi_lg,
                        iteration, reached, error, active, init_fail,
                        precision, lambda_min, lambda_max, lambda_up,
                        lambda_down, max_iterations, next, next_count, flags,
                        flag_capacity, stream_ptr);
    if (rc) break;
    cur = next;
    cur_count = next_count;
  }
  fused_assemble_plan_free(plan);
  return rc;
}

}  // extern "C"
