// H11 objective_verdict — replaces the verdict fold of the JAX package's
// ops/solver.py `solve_fill_variants` (solver.py:1960-2048: the feasibility
// bits, the argmin winner and kernels.pack_bool into one word) with
// `_objective_score` (:1917-1951) inlined.
//
// One launch per objective round. Variant v's claims are the window rows
// [base_w_open, w_open_v) that are open, and the objective's formula runs
// over them, every f32 sum in XLA:CPU's order (below):
//   cost_min     sum over W of the opened rows' min over the row's viable
//                types of price_t (0 elsewhere);
//   frag_aware   n_opened * 1e6 - landed, one rounding (an fma), landed
//                the sum over W of the opened rows' pods as f32;
//   topo_spread  sum over the G templates of (opened rows with it)^2;
//   gang_slice   sum over W of p_max - pods on opened rows, + n_opened.
// Its feasibility is leftover_v summing to 0 and spills_v equal to the
// base's. The word: bit v = variant v feasible, bits [24, 32) the first
// index of the least where(feasible, score, +inf) (0 when nothing is
// feasible, and 0 when every feasible score is +inf, as the reference's
// argmin gives).
//
// XLA's order (jax 0.9.0 on the CPU; ops/solver.py xla_tree_sum): a sum
// of n elements is a reduce-window of size 32, stride 32 and padding
// lo = p / 2 before, p - lo after (p = ceil(n / 32) * 32 - n), each window
// summed left to right in f32 from +0.0, then the same over the
// ceil(n / 32) partials while more than 32 are left, and what is left in
// order. Skipped zeros (padding, rows not opened) change no sum: x + 0.0 is
// x for every x a sum from +0.0 can reach.
//
// Work items. Block b is (variant v = b / NC, item c = b % NC): window
// rows [32c - lo, 32c + 32 - lo), XLA's window c over W, and leftover
// entries [32c, 32c + 32); the grid spans the card, not KV blocks. The
// opened range is known only on the device, so an item that misses it
// (and the leftovers) writes an empty partial and takes its ticket at
// once. Warp 0 reads the window's open flags, a row a lane, and lists
// the opened rows with a ballot. cost_min: price_t is staged in shared
// memory, a warp takes one listed row at a time, its lanes read the [T]
// viable-type row as 16-byte vectors (T = 400 is 25 lanes), the row's
// minimum is a register min and a warp reduce; frag_aware: the pods as
// f32. Warp 0 then sums the window's values in row order, in f32 from
// +0.0, through shuffles: the window's partial, bit for bit XLA's. gang_slice: count, sum
// of pods and max pods, as integers (p_max is the whole variant's, known
// only after every item). topo_spread: per-template counts by integer
// atomics into a shared histogram, merged into the [KV, G] int32 scratch
// (left zeroed again by the fold).
//
// Fixed-order folds. A block writes its partial to the workspace, fences
// and takes a ticket; the block that draws the last ticket folds each
// variant (a warp a variant) by XLA's rule, level by level in a fixed
// order (tree_sum: a lane a window of the level, its 32 values loaded at
// once and summed left to right; the levels in shared memory; the last
// level's values a lane each, summed in order through shuffles):
// cost_min and frag_aware over the windows' partials; gang_slice over
// the windows' cnt * p_max - sum(pods), which is each window's f32 sum
// exactly while it is at most 2^24 (every prefix an integer a float
// holds), else summed again from the window's rows; topo_spread over G
// of the counts squared (one f32 multiply). It writes scores and word and
// resets the ticket: no float atomics, and the result does not depend on
// which block finishes first. So the scores are the plain version's
// (ops/solver.py objective_verdict_plain) bit for bit.
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
constexpr int kRows = 32;            // XLA's window: window rows (and leftover entries) of a work item
constexpr int kHist = 2048;          // templates counted in shared memory; past it, straight into the scratch
constexpr int kStageTypes = 4096;    // price_t staged in shared memory up to this many types
constexpr int kLevel = 256;          // a warp's tree_sum levels in shared memory (ops/cuda.py OBJ_LEVEL_FLOATS)
constexpr long long kExactInt = 1ll << 24;  // integers up to here are floats
constexpr unsigned kFull = 0xffffffffu;
enum { kLexical, kCostMin, kFragAware, kTopoSpread, kGangSlice };

// one work item's partial
struct Part {
  float f;               // cost_min / frag_aware: the window's f32 sum in row order
  int pmax;              // gang_slice: max pods over the window's opened rows (>= 0)
  long long cnt, spods;  // gang_slice: opened rows, their pods
  long long left;        // leftover entries of the item's range
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
  int KV, W, T, B, G, objective, NC, NB, lo, stage;
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

// the f32 sum from +0.0 of one value a lane, lanes 0, 1, ..., 31 in
// order (a value past the data is 0.0, which changes no sum), in every lane
__device__ __forceinline__ float fold_lanes(float v) {
  float s = 0.0f;
#pragma unroll
  for (int u = 0; u < 32; ++u) s = __fadd_rn(s, __shfl_sync(kFull, v, u));
  return s;
}

// XLA:CPU's f32 sum of x(0), ..., x(n - 1) by one warp (ops/solver.py
// xla_tree_sum): while more than 32 values are left, a lane takes a window
// of 32 after lo leading zeros, loads its 32 values at once and sums them
// left to right from +0.0 into `lvl` (the warp's levels); then the last
// level's values, a lane each, are summed in order. x(i) is the lane's own
// work (no collective inside). Every lane returns the sum.
template <class F>
__device__ float tree_sum(int n, F x, float* lvl, int lane) {
  const float* src = nullptr;
  float* dst = lvl;
  while (n > 32) {
    const int m = (n + 31) / 32, lo = (32 * m - n) / 2;
    for (int j = lane; j < m; j += 32) {
      float v[32];
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        const int i = 32 * j - lo + u;
        v[u] = i >= 0 && i < n ? (src ? src[i] : x(i)) : 0.0f;
      }
      float s = 0.0f;
#pragma unroll
      for (int u = 0; u < 32; ++u) s = __fadd_rn(s, v[u]);
      dst[j] = s;
    }
    __syncwarp();
    src = dst;
    dst += m;
    n = m;
  }
  return fold_lanes(lane < n ? (src ? src[lane] : x(lane)) : 0.0f);
}

__global__ void __launch_bounds__(kThreads) objective_verdict_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) char smem[];  // price_t [T] when staged
  float* s_price = reinterpret_cast<float*>(smem);
  __shared__ int s_list[kRows];       // the window's opened rows' offsets, in row order
  __shared__ int s_tmpl[kRows];       // their templates (topo_spread), by row offset
  __shared__ float s_val[kRows];      // cost_min / frag_aware: each opened row's value, by row offset
  __shared__ int s_hist[kHist];
  __shared__ float s_lvl[kWarps][kLevel];
  __shared__ unsigned s_mask;
  __shared__ int s_n;
  __shared__ long long s_cnt, s_spods, s_left;
  __shared__ int s_pmax;
  __shared__ int s_last;
  __shared__ float s_score[kMaxKV];
  __shared__ int s_feas[kMaxKV];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int v = blockIdx.x / a.NC, c = blockIdx.x % a.NC, w0 = kRows * c - a.lo;
  const int lo = max(*a.base_w_open, 0);
  const int hi = min(*a.w_open[v], a.W);
  const int r0 = max(w0, lo), r1 = min(w0 + kRows, hi);
  const bool rows = a.objective != kLexical && c < a.NB && r0 < r1;
  const bool lefts = kRows * c < a.B;
  const int obj = a.objective;

  if (rows || lefts) {
    if (warp == 0) {
      // ---- the window's opened rows, a row a lane, one ballot
      const int r = w0 + lane;
      const bool o = rows && r >= r0 && r < r1 && a.open[v][r];
      const unsigned mask = __ballot_sync(kFull, o);
      if (o) s_list[__popc(mask & ((1u << lane) - 1u))] = lane;
      long long cnt = 0, spods = 0;
      int pmax = 0;
      if (o && obj != kCostMin) {
        const int x = (obj == kTopoSpread ? a.tmpl[v] : a.pods[v])[r];
        if (obj == kTopoSpread) {
          s_tmpl[lane] = x;
        } else if (obj == kFragAware) {
          s_val[lane] = (float)x;
        } else {
          cnt = 1;
          spods = x;
          pmax = x;
        }
      }
      cnt = warp_sum(cnt);
      spods = warp_sum(spods);
      pmax = warp_max(pmax);
      if (lane == 0) {
        s_mask = mask;
        s_n = __popc(mask);
        s_cnt = cnt;
        s_spods = spods;
        s_pmax = pmax;
      }
    } else if (warp == 1) {
      // ---- the item's leftover entries
      long long left = 0;
      if (lefts)
        for (int b = kRows * c + lane; b < min(kRows * c + kRows, a.B); b += 32) left += a.leftover[v][b];
      left = warp_sum(left);
      if (lane == 0) s_left = left;
    }
    if (obj == kCostMin && a.stage && rows)
      for (int t = tid; t < a.T; t += kThreads) s_price[t] = a.price_t[t];
    __syncthreads();
    const int n = s_n;

    if (obj == kCostMin && n) {
      // a warp per listed row: the row's min price at its offset
      const float* price = a.stage ? s_price : a.price_t;
      for (int k = warp; k < n; k += kWarps) {
        const int off = s_list[k];
        const float m = row_min(a.its[v] + (int64_t)(w0 + off) * a.T, a.T, price, lane);
        if (lane == 0) s_val[off] = m;
      }
    } else if (obj == kTopoSpread && n) {
      // the window's template counts: a shared histogram, merged by atomicExch
      const unsigned mask = s_mask;
      const bool mine = tid < kRows && ((mask >> tid) & 1u);
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
    __syncthreads();
    if (warp == 0) {
      // the window's values in row order, from +0.0
      float f = 0.0f;
      if (obj == kCostMin || obj == kFragAware) f = fold_lanes((s_mask >> lane) & 1u ? s_val[lane] : 0.0f);
      if (lane == 0) {
        Part p;
        const bool ints = obj == kGangSlice && rows;
        p.f = f;
        p.cnt = ints ? s_cnt : 0;
        p.spods = ints ? s_spods : 0;
        p.pmax = ints ? s_pmax : 0;
        p.left = lefts ? s_left : 0;
        xstore(&a.parts[blockIdx.x], p);
      }
    }
  } else if (tid == 0) {
    Part p;
    p.f = 0.0f;
    p.pmax = 0;
    p.cnt = p.spods = p.left = 0;
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
  const int base_w = *a.base_w_open;
  float* lvl = s_lvl[warp];
  for (int u = warp; u < a.KV; u += kWarps) {
    const Part* pu = a.parts + (int64_t)u * a.NC;
    long long left = 0;
    int pmax = 0;
    for (int i = lane; i < a.NC; i += 32) {
      left += xload(&pu[i].left);
      pmax = max(pmax, xload(&pu[i].pmax));
    }
    left = warp_sum(left);
    pmax = warp_max(pmax);
    float sum = 0.0f;
    if (obj == kCostMin || obj == kFragAware) {
      sum = tree_sum(a.NB, [&](int i) { return xload(&pu[i].f); }, lvl, lane);
    } else if (obj == kGangSlice) {
      const int ulo = max(base_w, 0), uhi = min(*a.w_open[u], a.W);
      // window i's f32 sum of p_max - pods, a lane a window, into the
      // partial's f: its integer sum while that is a float's exactly, else
      // its rows again in order
      Part* pw = a.parts + (int64_t)u * a.NC;
      for (int i = lane; i < a.NB; i += 32) {
        const long long ex = xload(&pu[i].cnt) * (long long)pmax - xload(&pu[i].spods);
        float s = (float)ex;
        if (ex > kExactInt) {
          s = 0.0f;
          const int b0 = kRows * i - a.lo;
          for (int r = max(b0, ulo); r < min(b0 + kRows, uhi); ++r)
            if (a.open[u][r]) s = __fadd_rn(s, (float)(pmax - a.pods[u][r]));
        }
        pw[i].f = s;
      }
      __syncwarp();
      sum = tree_sum(a.NB, [&](int i) { return pw[i].f; }, lvl, lane);
    } else if (obj == kTopoSpread) {
      const int32_t* h = a.hist + (int64_t)u * a.G;
      sum = tree_sum(a.G, [&](int g) {
        const float cg = (float)xload(h + g);
        return __fmul_rn(cg, cg);
      }, lvl, lane);
      __syncwarp();
      for (int g = lane; g < a.G; g += 32) a.hist[(int64_t)u * a.G + g] = 0;
    }
    if (lane == 0) {
      const float n_opened = (float)(*a.w_open[u] - base_w);
      float score = 0.0f;
      if (obj == kCostMin) score = sum;
      else if (obj == kFragAware) score = __fmaf_rn(n_opened, 1e6f, -sum);
      else if (obj == kTopoSpread) score = sum;
      else if (obj == kGangSlice) score = __fadd_rn(sum, n_opened);
      a.scores[u] = score;
      s_score[u] = score;
      s_feas[u] = left == 0 && *a.spills[u] == *a.base_spills;
    }
    __syncwarp();
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

// the floats tree_sum keeps in shared memory for n values
int level_floats(int n) {
  int total = 0;
  while (n > 32) {
    n = (n + 31) / 32;
    total += n;
  }
  return total;
}

}  // namespace

// ptrs: 7 * KV device pointers (its, open, pods, template, w_open, spills,
// leftover, each KV in variant order), then base_w_open, base_spills,
// price_t, scores, word, and the workspace's parts, hist ([KV, G] int32,
// zero) and ticket (0); dims: KV, W, T, B, G, objective, and the bytes of
// parts and the ints of hist the caller holds (ops/cuda.py mirrors the
// need: KV * NC Parts of 32 bytes, NC = max(ceil(W / kRows), ceil(B /
// kRows), 1)). The grid is KV * NC blocks. A W or G whose levels do not fit
// a warp's kLevel floats is refused.
extern "C" int objective_verdict(const int64_t* ptrs, int n_ptrs, const int64_t* dims, void* stream) {
  static_assert(sizeof(Part) == 32, "ops/cuda.py OBJ_PART_BYTES");
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
  a.NB = (a.W + kRows - 1) / kRows;
  a.lo = (kRows * a.NB - a.W) / 2;
  a.NC = max(max(a.NB, (a.B + kRows - 1) / kRows), 1);
  if (dims[6] < (int64_t)a.KV * a.NC * (int64_t)sizeof(Part) || dims[7] < (int64_t)a.KV * a.G ||
      level_floats(a.NB) > kLevel || level_floats(a.G) > kLevel)
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
