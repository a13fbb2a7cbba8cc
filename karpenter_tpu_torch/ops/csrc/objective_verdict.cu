// H11 objective_verdict — replaces the verdict fold of the JAX package's
// ops/solver.py `solve_fill_variants` (solver.py:1960-2048: the feasibility
// bits, the argmin winner and kernels.pack_bool into one word) with
// `_objective_score` (:1917-1951) inlined.
//
// One launch per objective round. Block v scores variant v of the round:
// the claims it opened are the window rows [base_w_open, w_open_v) that are
// open, and the objective's formula runs over them:
//   cost_min     sum over opened rows of min over the row's viable types
//                of price_t (a warp per row, its lanes over the types);
//   frag_aware   n_opened * 1e6 - landed pods, one rounding (__fmaf_rn:
//                XLA contracts the reference's multiply-subtract);
//   topo_spread  sum over templates of (opened rows with that template)^2;
//   gang_slice   sum of (p_max - pods) over opened rows, + n_opened.
// Its feasibility is leftover_v summing to 0 and spills_v equal to the
// base's. The block writes score and bit to device memory, fences, and
// takes a ticket; the block that draws the last ticket folds all KV of
// them: the first index of the least where(feasible, score, +inf) (0 when
// nothing is feasible, and 0 when every feasible score is +inf, as the
// reference's argmin gives), and the word: bit v = variant v feasible,
// bits [24, 32) the winner.
//
// Determinism: no float atomics. Sums run in double with a fixed tree
// (integer sums are exact; a sum of f32 prices is exact in double while
// the prices span less than 2^17 and at most 2^12 rows open), then round
// to float once, so the kernel equals the plain version
// (ops/solver.py objective_verdict_plain) bit for bit.
//
// Bound on an H100: bytes. A round reads each variant's opened rows of
// its [W, T] viable-type slab (cost_min), its open / pods / template rows
// and its leftovers; a few hundred opened rows of 400 types are a few
// hundred KB, microseconds at 3.35 TB/s. The design reads only the opened
// rows, a warp per row with its lanes on neighbouring bytes, and folds in
// the same launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxKV = 24;     // ops/solver.py VARIANT_MAX
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
enum { kLexical, kCostMin, kFragAware, kTopoSpread, kGangSlice };

struct Args {
  // per variant
  const uint8_t* its[kMaxKV];       // [W, T]
  const uint8_t* open[kMaxKV];      // [W]
  const int32_t* pods[kMaxKV];      // [W]
  const int32_t* tmpl[kMaxKV];      // [W]
  const int32_t* w_open[kMaxKV];    // []
  const int32_t* spills[kMaxKV];    // []
  const int32_t* leftover[kMaxKV];  // [B]
  // shared
  const int32_t* base_w_open;       // []
  const int32_t* base_spills;       // []
  const float* price_t;             // [T]
  float* scores;                    // [KV] out
  int32_t* word;                    // [1] out
  int32_t* feas;                    // [KV] scratch
  int32_t* ticket;                  // [1] scratch, 0 at launch
  int KV, W, T, B, G, objective;
};

// block-wide sum of one double per thread, in a fixed tree; every thread
// gets the total
__device__ double block_sum(double x, double* red) {
  const int tid = threadIdx.x;
  red[tid] = x;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const double r = red[0];
  __syncthreads();
  return r;
}

__device__ int64_t block_max(int64_t x, int64_t* red) {
  const int tid = threadIdx.x;
  red[tid] = x;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s && red[tid + s] > red[tid]) red[tid] = red[tid + s];
    __syncthreads();
  }
  const int64_t r = red[0];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kThreads) objective_verdict_kernel(const __grid_constant__ Args a) {
  __shared__ double dred[kThreads];
  __shared__ int64_t ired[kThreads];
  __shared__ int last;
  const int v = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t lo = *a.base_w_open;
  const int32_t hi = min(*a.w_open[v], a.W);
  const uint8_t* open = a.open[v];
  const int32_t* pods = a.pods[v];
  const double n_opened = (double)(*a.w_open[v] - lo);

  // ---- the variant's score ----------------------------------------------
  float score = 0.0f;
  if (a.objective == kCostMin) {
    // a warp per opened row: the min price over its viable types
    double part = 0.0;
    for (int r = max(lo, 0) + warp; r < hi; r += kWarps) {
      if (!open[r]) continue;
      const uint8_t* row = a.its[v] + (int64_t)r * a.T;
      float m = INFINITY;
      for (int t = lane; t < a.T; t += 32)
        if (row[t]) m = fminf(m, a.price_t[t]);
      for (int o = 16; o > 0; o >>= 1) m = fminf(m, __shfl_xor_sync(kFull, m, o));
      if (lane == 0) part += (double)m;
    }
    score = (float)block_sum(part, dred);
  } else if (a.objective == kFragAware) {
    double landed = 0.0;
    for (int r = max(lo, 0) + tid; r < hi; r += kThreads)
      if (open[r]) landed += (double)pods[r];
    landed = block_sum(landed, dred);
    score = __fmaf_rn((float)n_opened, 1e6f, -(float)landed);
  } else if (a.objective == kTopoSpread) {
    // thread g counts the opened rows of template g
    double sq = 0.0;
    for (int g = tid; g < a.G; g += kThreads) {
      int64_t c = 0;
      for (int r = max(lo, 0); r < hi; ++r) c += open[r] && a.tmpl[v][r] == g;
      sq += (double)(c * c);
    }
    score = (float)block_sum(sq, dred);
  } else if (a.objective == kGangSlice) {
    int64_t pm = 0;
    for (int r = max(lo, 0) + tid; r < hi; r += kThreads)
      if (open[r] && pods[r] > pm) pm = pods[r];
    const int64_t p_max = block_max(pm, ired);
    double slack = 0.0;
    for (int r = max(lo, 0) + tid; r < hi; r += kThreads)
      if (open[r]) slack += (double)(p_max - pods[r]);
    score = (float)(block_sum(slack, dred) + n_opened);
  }

  // ---- feasibility: no leftover pod, no window spill ----------------------
  double left = 0.0;
  for (int b = tid; b < a.B; b += kThreads) left += (double)a.leftover[v][b];
  left = block_sum(left, dred);
  if (tid == 0) {
    a.scores[v] = score;
    a.feas[v] = left == 0.0 && *a.spills[v] == *a.base_spills;
    __threadfence();
    last = atomicAdd(a.ticket, 1) == a.KV - 1;
  }
  __syncthreads();

  // ---- the last block folds the word --------------------------------------
  if (last && tid == 0) {
    __threadfence();
    uint32_t bits = 0;
    int best = 0;
    float bk = INFINITY;
    bool any = false;
    for (int u = 0; u < a.KV; ++u) {
      const volatile float* sc = a.scores;
      const volatile int32_t* fe = a.feas;
      const bool f = fe[u] != 0;
      const float k = f ? sc[u] : INFINITY;
      if (u == 0 || k < bk) {
        bk = k;
        best = u;
      }
      if (f) bits |= 1u << u;
      any = any || f;
    }
    *a.word = (int32_t)(bits | ((uint32_t)(any ? best : 0) << 24));
  }
}

}  // namespace

// ptrs: a host array of 7 * KV device pointers (its, open, pods, template,
// w_open, spills, leftover, each KV in variant order) then base_w_open,
// base_spills, price_t, scores, word, feas, ticket (the ticket 0 at
// launch); dims: KV, W, T, B, G, objective.
extern "C" int objective_verdict(const int64_t* ptrs, int n_ptrs, const int64_t* dims, void* stream) {
  Args a;
  memset(&a, 0, sizeof(a));
  a.KV = (int)dims[0];
  a.W = (int)dims[1];
  a.T = (int)dims[2];
  a.B = (int)dims[3];
  a.G = (int)dims[4];
  a.objective = (int)dims[5];
  if (a.KV < 1 || a.KV > kMaxKV || n_ptrs != 7 * a.KV + 7 || a.objective < kLexical || a.objective > kGangSlice)
    return (int)cudaErrorInvalidValue;
  const void** fields[7] = {(const void**)a.its, (const void**)a.open, (const void**)a.pods,
                            (const void**)a.tmpl, (const void**)a.w_open, (const void**)a.spills,
                            (const void**)a.leftover};
  for (int f = 0; f < 7; ++f)
    for (int v = 0; v < a.KV; ++v) fields[f][v] = (const void*)ptrs[f * a.KV + v];
  const int64_t* tail = ptrs + 7 * a.KV;
  a.base_w_open = (const int32_t*)tail[0];
  a.base_spills = (const int32_t*)tail[1];
  a.price_t = (const float*)tail[2];
  a.scores = (float*)tail[3];
  a.word = (int32_t*)tail[4];
  a.feas = (int32_t*)tail[5];
  a.ticket = (int32_t*)tail[6];
  objective_verdict_kernel<<<a.KV, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* objective_verdict_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
