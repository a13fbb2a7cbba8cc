// H11 objective_verdict — replaces the verdict fold of the JAX package's
// ops/solver.py `solve_fill_variants` (solver.py:1960-2048: the feasibility
// bits, the argmin winner and kernels.pack_bool into one word) with
// `_objective_score` (:1917-1951) inlined.
//
// One launch per objective round. Variant v's claims are the window rows
// [base_w_open, w_open_v) that are open, and the objective's formula runs
// over them:
//   cost_min     sum over opened rows of min over the row's viable types
//                of price_t;
//   frag_aware   n_opened * 1e6 - landed pods, in double, rounded once;
//   topo_spread  sum over templates of (opened rows with that template)^2;
//   gang_slice   sum of (p_max - pods) over opened rows, + n_opened.
// Its feasibility is leftover_v summing to 0 and spills_v equal to the
// base's. The word: bit v = variant v feasible, bits [24, 32) the first
// index of the least where(feasible, score, +inf) (0 when nothing is
// feasible, and 0 when every feasible score is +inf, as the reference's
// argmin gives).
//
// Work items. Block b is (variant v = b / NC, chunk c = b % NC) of kRows
// window rows (and of kRows leftover entries): the grid spans the card,
// not KV blocks. The opened range is known only on the device, so a block
// whose chunk misses it (and the leftovers) writes an empty partial and
// takes its ticket at once. Warp 0 reads the chunk's open flags as 16-byte
// vectors and lists the opened rows with two ballots; it reads the pods /
// template columns as 16-byte vectors too. cost_min: price_t is staged in
// shared memory, a warp takes one listed row at a time, its lanes read the
// [T] viable-type row as 16-byte vectors (T = 400 is 25 lanes), the row's
// minimum is a register min and a warp reduce. frag_aware / gang_slice:
// count, sum of pods and max pods, as integers. topo_spread: per-template
// counts by integer atomics into a shared histogram, merged into the
// [KV, G] int32 scratch (left zeroed again by the fold).
//
// Fixed-order folds. A block writes its partial (a double for cost_min,
// int64 counts and sums, int max) to the workspace, fences and takes a
// ticket; the block that draws the last ticket folds each variant's
// partials in one fixed order over the block index (a lane per block
// index, blocks lane, lane + 32, ... in turn, then a butterfly of the 32
// lanes), rounds to float once where the plain version does, writes
// scores and word, and resets the ticket: no float atomics, and the result
// does not depend on which block finishes first. Exactness: integer sums
// are exact; a sum of f32 prices is exact in double while the prices span
// less than 2^17 and at most 2^12 rows are open, so there any order gives
// the plain version's (ops/solver.py objective_verdict_plain) bits.
//
// Bound on an H100: bytes. A round reads each variant's opened rows of its
// [W, T] viable-type slab (cost_min), its open / pods / template rows and
// its leftovers; a few hundred opened rows of 400 types are a few hundred
// KB, microseconds at 3.35 TB/s. At these sizes the kernel is latency:
// the design spreads the opened rows over many blocks and warps, makes
// each row one vector load a lane, and folds in the same launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxKV = 24;  // ops/solver.py VARIANT_MAX
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;            // window rows (and leftover entries) of a work item
constexpr int kHist = 2048;          // templates counted in shared memory; past it, straight into the scratch
constexpr int kStageTypes = 8192;    // price_t staged in shared memory up to this many types
constexpr unsigned kFull = 0xffffffffu;
enum { kLexical, kCostMin, kFragAware, kTopoSpread, kGangSlice };

// one work item's partial sums
struct Part {
  double cm;             // cost_min: sum of the opened rows' min prices
  long long cnt, spods;  // opened rows, their pods
  long long left;        // leftover entries of the item's range
  int pmax, pad;         // max pods over the opened rows (>= 0)
};

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
  // the workspace, one per (device, stream): parts [KV * NC], hist
  // [KV * G] zero between launches, ticket 0 between launches
  Part* parts;
  int32_t* hist;
  unsigned* ticket;
  int KV, W, T, B, G, objective, NC, stage;
};

// the cross-block protocol: partials stored (and counts added) before the
// ticket, loaded by the last block after it through L2 (the emulated
// suites swap these four for tests/cuda_emu.h's checked versions)
template <class T>
__device__ __forceinline__ void xstore(T* p, T v) {
  *p = v;
}
template <class T>
__device__ __forceinline__ T xload(const T* p) {
  return __ldcg(p);
}
__device__ __forceinline__ void xadd(int32_t* p, int v) { atomicAdd(p, v); }
__device__ __forceinline__ unsigned take_ticket(unsigned* t) { return atomicAdd(t, 1u); }

__device__ __forceinline__ bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// 16 bytes of a bool column from row r0 (rows past W read as false)
__device__ __forceinline__ uint32_t flags16(const uint8_t* col, int r0, int W) {
  uint32_t m = 0;
  if (r0 + 16 <= W && aligned16(col + r0)) {
    const uint4 v = *reinterpret_cast<const uint4*>(col + r0);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) m |= (uint32_t)(((w[k] >> (8 * j)) & 0xffu) != 0) << (4 * k + j);
  } else {
    for (int j = 0; j < 16 && r0 + j < W; ++j) m |= (uint32_t)(col[r0 + j] != 0) << j;
  }
  return m;
}

// 4 int32 of a column from row r0 (rows past W read as 0)
__device__ __forceinline__ int4 ints4(const int32_t* col, int r0, int W) {
  if (r0 + 4 <= W && aligned16(col + r0)) return *reinterpret_cast<const int4*>(col + r0);
  int4 v = make_int4(0, 0, 0, 0);
  if (r0 < W) v.x = col[r0];
  if (r0 + 1 < W) v.y = col[r0 + 1];
  if (r0 + 2 < W) v.z = col[r0 + 2];
  if (r0 + 3 < W) v.w = col[r0 + 3];
  return v;
}

// the min of price[t] over the row's viable types t, in every lane
__device__ float row_min(const uint8_t* row, int T, const float* price, int lane) {
  float m = INFINITY;
  const int head = min((int)((16 - ((uintptr_t)row & 15)) & 15), T);
  if (lane < head && row[lane]) m = price[lane];
  const int nv = (T - head) >> 4;
  const uint4* vec = reinterpret_cast<const uint4*>(row + head);
  for (int i = lane; i < nv; i += 32) {
    const uint4 x = vec[i];
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
    const float* p = price + head + 16 * i;
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if ((w[k] >> (8 * j)) & 0xffu) m = fminf(m, p[4 * k + j]);
  }
  const int t = head + 16 * nv + lane;
  if (lane < 16 && t < T && row[t]) m = fminf(m, price[t]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fminf(m, __shfl_xor_sync(kFull, m, o));
  return m;
}

__device__ __forceinline__ long long warp_sum(long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__global__ void __launch_bounds__(kThreads) objective_verdict_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) char smem[];  // price_t [T] when staged
  float* s_price = reinterpret_cast<float*>(smem);
  __shared__ int s_list[kRows];       // the chunk's opened rows, in row order
  __shared__ int s_tmpl[kRows];       // their templates (topo_spread), by row offset
  __shared__ int s_hist[kHist];
  __shared__ double s_cm[kWarps];
  __shared__ unsigned long long s_mask;
  __shared__ int s_n;
  __shared__ long long s_cnt, s_spods, s_left;
  __shared__ int s_pmax;
  __shared__ int s_last;
  __shared__ float s_score[kMaxKV];
  __shared__ int s_feas[kMaxKV];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int v = blockIdx.x / a.NC, c0 = (blockIdx.x % a.NC) * kRows;
  const int lo = max(*a.base_w_open, 0);
  const int hi = min(*a.w_open[v], a.W);
  const int r0 = max(c0, lo), r1 = min(c0 + kRows, hi);
  const bool rows = a.objective != kLexical && r0 < r1;
  const bool lefts = c0 < a.B;
  const int obj = a.objective;

  if (rows || lefts) {
    if (warp == 0) {
      // ---- the chunk's opened rows: open flags as 16-byte vectors, two ballots
      unsigned long long mask = 0;
      if (rows) {
        const uint32_t m16 = lane < kRows / 16 ? flags16(a.open[v], c0 + 16 * lane, a.W) : 0u;
        const uint32_t mA = __shfl_sync(kFull, m16, lane >> 4), mB = __shfl_sync(kFull, m16, 2 + (lane >> 4));
        const int rA = c0 + lane, rB = c0 + 32 + lane;
        const bool oA = ((mA >> (lane & 15)) & 1u) && rA >= r0 && rA < r1;
        const bool oB = ((mB >> (lane & 15)) & 1u) && rB >= r0 && rB < r1;
        const unsigned bA = __ballot_sync(kFull, oA), bB = __ballot_sync(kFull, oB);
        const unsigned lt = (1u << lane) - 1u;
        if (oA) s_list[__popc(bA & lt)] = rA;
        if (oB) s_list[__popc(bA) + __popc(bB & lt)] = rB;
        mask = (unsigned long long)bA | ((unsigned long long)bB << 32);
      }
      // ---- pods / templates as 16-byte vectors, 4 rows a lane
      long long cnt = 0, spods = 0;
      int pmax = 0;
      if (rows && obj != kCostMin && lane < kRows / 4) {
        const int4 q = ints4(obj == kTopoSpread ? a.tmpl[v] : a.pods[v], c0 + 4 * lane, a.W);
        const int x[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * lane + j;
          if (!((mask >> k) & 1ull)) continue;
          if (obj == kTopoSpread) {
            s_tmpl[k] = x[j];
          } else {
            ++cnt;
            spods += x[j];
            pmax = max(pmax, x[j]);
          }
        }
      }
      cnt = warp_sum(cnt);
      spods = warp_sum(spods);
      pmax = warp_max(pmax);
      if (lane == 0) {
        s_mask = mask;
        s_n = __popcll(mask);
        s_cnt = cnt;
        s_spods = spods;
        s_pmax = pmax;
      }
    } else if (warp == 1) {
      // ---- the item's leftover entries
      long long left = 0;
      if (lefts)
        for (int b = c0 + lane; b < min(c0 + kRows, a.B); b += 32) left += a.leftover[v][b];
      left = warp_sum(left);
      if (lane == 0) s_left = left;
    }
    if (obj == kCostMin && a.stage && rows)
      for (int t = tid; t < a.T; t += kThreads) s_price[t] = a.price_t[t];
    __syncthreads();
    const int n = s_n;

    double cm = 0.0;
    if (obj == kCostMin && n) {
      // a warp per listed row, in list order; the warp's rows summed in order
      const float* price = a.stage ? s_price : a.price_t;
      double part = 0.0;
      for (int k = warp; k < n; k += kWarps)
        part += (double)row_min(a.its[v] + (int64_t)s_list[k] * a.T, a.T, price, lane);
      if (lane == 0) s_cm[warp] = part;
      __syncthreads();
      for (int w = 0; w < kWarps; ++w) cm += s_cm[w];
    } else if (obj == kTopoSpread && n) {
      // the chunk's template counts: a shared histogram, merged by atomicExch
      const unsigned long long mask = s_mask;
      const bool mine = tid < kRows && ((mask >> tid) & 1ull);
      const int g = mine ? s_tmpl[tid] : -1;
      const bool ok = g >= 0 && g < a.G;
      int32_t* dst = a.hist + (int64_t)v * a.G;
      if (a.G <= kHist) {
        // zeroed before any add; no barrier between a thread's add and its
        // exchange: each exchange follows its own add, so every count is
        // swept into the scratch by some exchange
        if (ok) s_hist[g] = 0;
        __syncthreads();
        if (ok) {
          atomicAdd(&s_hist[g], 1);
          const int cg = atomicExch(&s_hist[g], 0);
          if (cg) xadd(&dst[g], cg);
        }
      } else if (ok) {
        xadd(&dst[g], 1);
      }
    }
    if (tid == 0) {
      Part p;
      p.cm = cm;
      p.cnt = obj == kCostMin || obj == kTopoSpread ? 0 : s_cnt;
      p.spods = obj == kCostMin || obj == kTopoSpread ? 0 : s_spods;
      p.pmax = obj == kCostMin || obj == kTopoSpread ? 0 : s_pmax;
      p.left = lefts ? s_left : 0;
      p.pad = 0;
      xstore(&a.parts[blockIdx.x], p);
    }
  } else if (tid == 0) {
    Part p;
    p.cm = 0.0;
    p.cnt = p.spods = p.left = 0;
    p.pmax = p.pad = 0;
    xstore(&a.parts[blockIdx.x], p);
  }

  // ---- the ticket: every thread's stores (the partial, the histogram's
  // atomics) are made visible before thread 0 takes it
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = take_ticket(a.ticket) == (unsigned)(a.KV * a.NC - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // ---- the last block folds each variant: a warp a variant
  const long long base_w = *a.base_w_open;
  for (int u = warp; u < a.KV; u += kWarps) {
    double cm = 0.0;
    long long cnt = 0, spods = 0, left = 0;
    int pmax = 0;
    for (int c = lane; c < a.NC; c += 32) {
      const Part* p = a.parts + (int64_t)u * a.NC + c;
      cm += xload(&p->cm);
      cnt += xload(&p->cnt);
      spods += xload(&p->spods);
      left += xload(&p->left);
      pmax = max(pmax, xload(&p->pmax));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cm += __shfl_xor_sync(kFull, cm, o);
    cnt = warp_sum(cnt);
    spods = warp_sum(spods);
    left = warp_sum(left);
    pmax = warp_max(pmax);
    long long sq = 0;
    if (obj == kTopoSpread) {
      int32_t* h = a.hist + (int64_t)u * a.G;
      for (int g = lane; g < a.G; g += 32) {
        const long long cg = xload(h + g);
        sq += cg * cg;
        h[g] = 0;
      }
      sq = warp_sum(sq);
    }
    if (lane == 0) {
      const double n_opened = (double)(*a.w_open[u] - base_w);
      float score = 0.0f;
      if (obj == kCostMin) score = (float)cm;
      else if (obj == kFragAware) score = (float)(n_opened * 1e6 - (double)spods);
      else if (obj == kTopoSpread) score = (float)(double)sq;
      else if (obj == kGangSlice) score = (float)((double)(cnt * (long long)pmax - spods) + n_opened);
      a.scores[u] = score;
      s_score[u] = score;
      s_feas[u] = left == 0 && *a.spills[u] == *a.base_spills;
    }
  }
  __syncthreads();
  if (tid == 0) {
    uint32_t bits = 0;
    int best = 0;
    float bk = INFINITY;
    bool any = false;
    for (int u = 0; u < a.KV; ++u) {
      const bool f = s_feas[u] != 0;
      const float k = f ? s_score[u] : INFINITY;
      if (u == 0 || k < bk) {
        bk = k;
        best = u;
      }
      if (f) bits |= 1u << u;
      any = any || f;
    }
    *a.word = (int32_t)(bits | ((uint32_t)(any ? best : 0) << 24));
    *a.ticket = 0u;
  }
}

}  // namespace

// ptrs: 7 * KV device pointers (its, open, pods, template, w_open, spills,
// leftover, each KV in variant order), then base_w_open, base_spills,
// price_t, scores, word, and the workspace's parts, hist ([KV, G] int32,
// zero) and ticket (0); dims: KV, W, T, B, G, objective, and the bytes of
// parts and the ints of hist the caller holds (ops/cuda.py mirrors the
// need: KV * NC Parts of 40 bytes, NC = ceil(max(W, B, 1) / kRows)). The
// grid is KV * NC blocks.
extern "C" int objective_verdict(const int64_t* ptrs, int n_ptrs, const int64_t* dims, void* stream) {
  static_assert(sizeof(Part) == 40, "ops/cuda.py OBJ_PART_BYTES");
  Args a;
  memset(&a, 0, sizeof(a));
  a.KV = (int)dims[0];
  a.W = (int)dims[1];
  a.T = (int)dims[2];
  a.B = (int)dims[3];
  a.G = (int)dims[4];
  a.objective = (int)dims[5];
  if (a.KV < 1 || a.KV > kMaxKV || n_ptrs != 7 * a.KV + 8 || a.objective < kLexical || a.objective > kGangSlice ||
      a.W < 0 || a.T < 0 || a.B < 0 || a.G < 0)
    return (int)cudaErrorInvalidValue;
  a.NC = (max(max(a.W, a.B), 1) + kRows - 1) / kRows;
  if (dims[6] < (int64_t)a.KV * a.NC * (int64_t)sizeof(Part) || dims[7] < (int64_t)a.KV * a.G)
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
  a.parts = (Part*)tail[5];
  a.hist = (int32_t*)tail[6];
  a.ticket = (unsigned*)tail[7];
  a.stage = a.objective == kCostMin && a.T <= kStageTypes;
  const size_t smem = a.stage ? (size_t)a.T * sizeof(float) : 0;
  objective_verdict_kernel<<<a.KV * a.NC, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* objective_verdict_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
