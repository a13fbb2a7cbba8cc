// H12 dp_dead — the deadness matrix of a dp merge round, replacing the
// deadness half of the JAX package's `_dp_verdict_word` (ops/solver.py:
// 2100-2153): `_rows_dead` (:2030) in the fill and per-pod families and
// `_kscan_rows_dead` (:3557) in the kind scan's.
//
// Entry [r, s] of the [DP, 1 + DP] result: whether every row of source s
// is capacity-dead for row r's min request r_min[r]. Source 0 is the round
// base's open rows, [0, W); source 1 + q the rows dp row q opened,
// [base.w_open, w_open[q]) that are open. A row is alive for r when some
// viable type t (its[row, t]) has a cell (t, g) that takes another pod:
//   fill / per-pod: group_valid[t, g] and, over every resource k,
//     used + r_min (one f32 add) <= alloc[t, g, k] or the sum is 0;
//   kind scan: the per-cell count of count_cell.cuh (shared with H2, H5
//     and H9) at (used, r_min) is > 0, in a valid cell some domain d of
//     the key admits (the type's key requirement holds d and, for the zone
//     key, an available offering in zone d; for another key, any available
//     offering) — the all-admitting masks of `_kscan_rows_dead`.
// The cells each mode may use are bit words per type ([T][ceil(GR / 32)],
// ops/cuda.py DpCatalog), built once per catalog and key.
//
// One pass over each source's rows for every request. A work item is
// (source s, chunk of kRows window rows); warp 0 reads the chunk's open
// flags as 16-byte vectors and lists its rows in range with two ballots.
// A warp takes one listed row at a time: it loads the row's usage once and
// its viable types once (16-byte vectors, 16 types a lane), and tests every
// request not yet alive for s against them (r_min staged in shared
// memory), a type a lane a step, with a warp vote after each step that
// ends the row's scan once every pending request has a cell. Alive bits per (r, s) go to the block's shared words, then by
// integer atomicOr to the workspace; a block reads its source's alive
// words before its chunk and stops once every request is alive there, and
// a warp checks the block's words before each row. The block that takes
// the last ticket writes dead[r, s] = !alive and resets the words and the
// ticket.
//
// The ceiling test. Per resource k, ceil[k] is the catalog's largest
// allocatable over valid cells (ops/cuda.py DpCatalog; -inf with none, NaN
// when one is NaN). A row is dead for r without a type scan when, for some
// k, r_min[r, k] >= 0 and the one f32 add tot = used[k] + r_min[r, k] has
// tot > 0 and tot > ceil[k]:
//   fill: every valid cell has alloc[t, g, k] <= ceil[k] < tot (a NaN
//     alloc fails `tot <= alloc` as well), and tot != 0, so the cell test
//     fails at k in every cell. A NaN tot (a NaN usage, or inf - inf)
//     compares false, so the test never fires on it and the scan decides;
//     a +inf request (a padding row) gives tot = +inf, which exceeds every
//     finite ceiling, as it fits no finite cell; a total of exactly 0 is
//     kept for the scan, whose `tot == 0` admits it.
//   kind scan: cell_count_t returns c > 0 only where fits_at(c) holds
//     (each of its returns is a count whose fits_at it checked). For
//     c >= 1 and r_min[k] >= 0, u + 1 * q <= u + c * q in the reals and
//     rounding is monotone, so fma(1, q, u) = tot <= fma(c, q, u); fits_at
//     at k needs fma(c, q, u) <= alloc (impossible: >= tot > ceil >=
//     alloc) or fma(c, q, u) == 0 (impossible: >= tot > 0). So the count is
//     0 in every cell, as the scan would find. The test is the same in
//     both modes.
//
// Bound on an H100: bytes — each source's open rows' [T] viable-type bytes
// and [R] usage, once for all requests, the open flags and the catalog.
// A round of a few hundred open rows of 1000 types is well under a
// millisecond at 3.35 TB/s; at these sizes the launch is latency, which
// the work items spread over the SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "count_cell.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;          // window rows of a work item
constexpr int kParamRows = 32;     // dp rows whose pointers ride the kernel's parameters (ops/cuda.py DP_PARAM_ROWS)
constexpr int kMaxDP = 1024;       // requests: 32 words of alive bits
constexpr int kMaxWords = kMaxDP / 32;
constexpr int kSmem = 200 * 1024;  // dynamic shared memory a block may take
constexpr unsigned kFull = 0xffffffffu;

struct Row {
  const float* used;     // [W, R]
  const uint8_t* its;    // [W, T]
  const uint8_t* open;   // [W]
  const int32_t* w_open; // []
};

struct Args {
  Row base;
  Row rows[kParamRows];        // dp rows 0..DP-1 when DP <= kParamRows
  const int64_t* table;        // else [DP, 4] device pointers (used, its, open, w_open)
  const float* r_min;          // [DP, R]
  const float* alloc;          // [T, GR, R]
  const uint32_t* cells;       // [T, NWG] the cells the mode may use
  const float* ceil;           // [R]
  uint8_t* dead;               // [DP, 1 + DP] out
  // the workspace, one per (device, stream): alive [(1 + DP) * NWR] and the
  // ticket, both 0 between launches
  uint32_t* alive;
  unsigned* ticket;
  int DP, W, T, GR, R, kscan, NWG, NWR, NC, stage;
};

// the cross-block protocol: alive bits ORed in before the ticket, loaded
// by the last block after it through L2 (the emulated suite swaps these
// three for tests/cuda_emu.h's checked versions)
__device__ __forceinline__ void xor_bits(uint32_t* p, uint32_t v) { atomicOr(p, v); }
__device__ __forceinline__ uint32_t xload(const uint32_t* p) { return __ldcg(p); }
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

__device__ __forceinline__ Row source_row(const Args& a, int s) {
  if (s == 0) return a.base;
  if (a.DP <= kParamRows) return a.rows[s - 1];
  const int64_t* t = a.table + (int64_t)(s - 1) * 4;
  return Row{(const float*)t[0], (const uint8_t*)t[1], (const uint8_t*)t[2], (const int32_t*)t[3]};
}

// the requests of alive word w
__device__ __forceinline__ uint32_t word_mask(int DP, int w) {
  const int n = DP - 32 * w;
  return n >= 32 ? kFull : (1u << n) - 1u;
}

// the requests of `pend` (word rw) that cell (t, g) takes
__device__ __forceinline__ uint32_t cell_takes(const Args& a, const float* u, const float* rmin, const float* al,
                                               int rw, uint32_t pend) {
  uint32_t got = 0;
  while (pend) {
    const int r = __ffs(pend) - 1;
    pend &= pend - 1;
    const float* q = rmin + (int64_t)(32 * rw + r) * a.R;
    bool ok;
    if (a.kscan) {
      ok = ktpu::cell_count(u, q, al, a.R) > 0;
    } else {
      ok = true;
      for (int k = 0; k < a.R && ok; ++k) {
        const float tot = __fadd_rn(u[k], q[k]);
        ok = tot <= al[k] || tot == 0.0f;
      }
    }
    if (ok) got |= 1u << r;
  }
  return got;
}

// the requests of `pend` that type t takes in some usable cell
__device__ __forceinline__ uint32_t type_takes(const Args& a, const float* u, const float* rmin,
                                               const uint32_t* cells, const float* alloc, int t, int rw,
                                               uint32_t pend) {
  uint32_t got = 0;
  for (int w = 0; w < a.NWG && got != pend; ++w) {
    uint32_t bits = cells[(int64_t)t * a.NWG + w];
    while (bits && got != pend) {
      const int g = 32 * w + __ffs(bits) - 1;
      bits &= bits - 1;
      got |= cell_takes(a, u, rmin, alloc + ((int64_t)t * a.GR + g) * a.R, rw, pend & ~got);
    }
  }
  return got;
}

__global__ void __launch_bounds__(kThreads) dp_dead_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int s_list[kRows];
  __shared__ int s_n;
  __shared__ uint32_t s_alive[kMaxWords];
  __shared__ int s_todo;
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x / a.NC, c0 = (blockIdx.x % a.NC) * kRows;
  // shared memory: r_min [DP, R], ceil [R], the warps' usage rows [kWarps, R],
  // then (staged) the cell words [T, NWG] and alloc [T, GR, R]
  float* s_rmin = reinterpret_cast<float*>(smem);
  float* s_ceil = s_rmin + a.DP * a.R;
  float* s_u = s_ceil + a.R;
  uint32_t* s_cells = reinterpret_cast<uint32_t*>(s_u + kWarps * a.R);
  float* s_alloc = reinterpret_cast<float*>(s_cells + a.T * a.NWG);

  const Row src = source_row(a, s);
  int lo = 0, hi = a.W;
  if (s > 0) {
    lo = max(*a.base.w_open, 0);
    hi = min(*src.w_open, a.W);
  }
  const int r0 = max(c0, lo), r1 = min(c0 + kRows, hi);

  // ---- the source's alive words (a hint: a block stops when all are set)
  if (tid == 0) s_todo = 0;
  __syncthreads();
  if (r0 < r1 && tid < a.NWR) {
    s_alive[tid] = __ldcg(a.alive + (int64_t)s * a.NWR + tid);
    if (s_alive[tid] != word_mask(a.DP, tid)) s_todo = 1;
  }
  __syncthreads();

  if (s_todo) {
    if (warp == 0) {
      // ---- the chunk's open rows: 16-byte vectors of flags, two ballots
      const uint32_t m16 = lane < kRows / 16 ? flags16(src.open, c0 + 16 * lane, a.W) : 0u;
      const uint32_t mA = __shfl_sync(kFull, m16, lane >> 4), mB = __shfl_sync(kFull, m16, 2 + (lane >> 4));
      const int rA = c0 + lane, rB = c0 + 32 + lane;
      const bool oA = ((mA >> (lane & 15)) & 1u) && rA >= r0 && rA < r1;
      const bool oB = ((mB >> (lane & 15)) & 1u) && rB >= r0 && rB < r1;
      const unsigned bA = __ballot_sync(kFull, oA), bB = __ballot_sync(kFull, oB);
      const unsigned lt = (1u << lane) - 1u;
      if (oA) s_list[__popc(bA & lt)] = rA;
      if (oB) s_list[__popc(bA) + __popc(bB & lt)] = rB;
      if (lane == 0) s_n = __popc(bA) + __popc(bB);
    }
    for (int i = tid; i < a.DP * a.R; i += kThreads) s_rmin[i] = a.r_min[i];
    for (int i = tid; i < a.R; i += kThreads) s_ceil[i] = a.ceil[i];
    __syncthreads();
    const int n = s_n;
    if (n && a.stage) {
      for (int i = tid; i < a.T * a.NWG; i += kThreads) s_cells[i] = a.cells[i];
      for (int i = tid; i < a.T * a.GR * a.R; i += kThreads) s_alloc[i] = a.alloc[i];
    }
    __syncthreads();
    const uint32_t* cells = a.stage ? s_cells : a.cells;
    const float* alloc = a.stage ? s_alloc : a.alloc;
    float* u = s_u + warp * a.R;

    // ---- a warp a listed row: its usage and viable types read once
    for (int k = warp; k < n; k += kWarps) {
      bool all = true;
      for (int w = 0; w < a.NWR; ++w) all = all && *(volatile uint32_t*)&s_alive[w] == word_mask(a.DP, w);
      if (__shfl_sync(kFull, all, 0)) break;  // lane 0's view, so the warp stays converged
      const int row = s_list[k];
      __syncwarp();
      for (int i = lane; i < a.R; i += 32) u[i] = src.used[(int64_t)row * a.R + i];
      __syncwarp();
      const uint8_t* its = src.its + (int64_t)row * a.T;
      const int head = min((int)((16 - ((uintptr_t)its & 15)) & 15), a.T);
      const int nv = (a.T - head) >> 4;
      for (int rw = 0; rw < a.NWR; ++rw) {
        uint32_t pend = __shfl_sync(kFull, word_mask(a.DP, rw) & ~*(volatile uint32_t*)&s_alive[rw], 0);
        // the ceiling test, a lane a request
        bool capped = false;
        if ((pend >> lane) & 1u) {
          const float* q = s_rmin + (int64_t)(32 * rw + lane) * a.R;
          for (int j = 0; j < a.R && !capped; ++j) {
            const float tot = __fadd_rn(u[j], q[j]);
            capped = q[j] >= 0.0f && tot > 0.0f && tot > s_ceil[j];
          }
        }
        pend &= ~__ballot_sync(kFull, capped);
        if (!pend) continue;
        // the row's viable types: the head bytes, then 16-byte vectors (16
        // types a lane, one type a lane a step), then the tail bytes; a
        // warp vote after each step stops the scan once every pending
        // request has a cell, and later steps test only those left
        uint32_t got = 0;
        if (lane < head && its[lane]) got = type_takes(a, u, s_rmin, cells, alloc, lane, rw, pend);
        uint32_t all = __reduce_or_sync(kFull, got);
        for (int i0 = 0; i0 < nv && all != pend; i0 += 32) {
          const int i = i0 + lane;
          const uint4 x = i < nv ? reinterpret_cast<const uint4*>(its + head)[i] : make_uint4(0u, 0u, 0u, 0u);
          const uint32_t wv[4] = {x.x, x.y, x.z, x.w};
          for (int b = 0; b < 16 && all != pend; ++b) {
            if ((wv[b >> 2] >> (8 * (b & 3))) & 0xffu)
              got |= type_takes(a, u, s_rmin, cells, alloc, head + 16 * i + b, rw, pend & ~all);
            all |= __reduce_or_sync(kFull, got);
          }
        }
        const int t = head + 16 * nv + lane;
        if (all != pend) {
          if (lane < 16 && t < a.T && its[t]) got |= type_takes(a, u, s_rmin, cells, alloc, t, rw, pend & ~all);
          all |= __reduce_or_sync(kFull, got);
        }
        if (lane == 0 && all) atomicOr(&s_alive[rw], all);
      }
    }
    __syncthreads();
    if (tid < a.NWR && s_alive[tid]) xor_bits(a.alive + (int64_t)s * a.NWR + tid, s_alive[tid]);
  }

  // ---- the ticket: the alive bits are published before it is taken
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = take_ticket(a.ticket) == (unsigned)((1 + a.DP) * a.NC - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int S = 1 + a.DP;
  for (int i = tid; i < a.DP * S; i += kThreads) {
    const int r = i / S, src_i = i % S;
    a.dead[i] = !((xload(a.alive + (int64_t)src_i * a.NWR + (r >> 5)) >> (r & 31)) & 1u);
  }
  __syncthreads();
  for (int i = tid; i < S * a.NWR; i += kThreads) a.alive[i] = 0u;
  if (tid == 0) *a.ticket = 0u;
}

}  // namespace

// ptrs: base used, its, open, w_open; r_min, alloc, cells, ceil, dead, the
// workspace's alive words and ticket; the [DP, 4] pointer table (0 when
// DP <= kParamRows); then, when DP <= kParamRows, each dp row's used, its,
// open, w_open. dims: DP, W, T, GR, R, kscan, NWG, and the alive words the
// caller holds (>= (1 + DP) * ceil(DP / 32)).
extern "C" int dp_dead(const int64_t* ptrs, int n_ptrs, const int64_t* dims, void* stream) {
  Args a;
  memset(&a, 0, sizeof(a));
  int* f[] = {&a.DP, &a.W, &a.T, &a.GR, &a.R, &a.kscan, &a.NWG};
  for (int i = 0; i < 7; ++i) *f[i] = (int)dims[i];
  if (a.DP < 1 || a.DP > kMaxDP || a.W < 0 || a.T < 0 || a.GR < 0 || a.R < 0 || a.NWG != (a.GR + 31) / 32)
    return (int)cudaErrorInvalidValue;
  a.NWR = (a.DP + 31) / 32;
  if (n_ptrs != 12 + (a.DP <= kParamRows ? 4 * a.DP : 0) || dims[7] < (int64_t)(1 + a.DP) * a.NWR)
    return (int)cudaErrorInvalidValue;
  a.base = Row{(const float*)ptrs[0], (const uint8_t*)ptrs[1], (const uint8_t*)ptrs[2], (const int32_t*)ptrs[3]};
  a.r_min = (const float*)ptrs[4];
  a.alloc = (const float*)ptrs[5];
  a.cells = (const uint32_t*)ptrs[6];
  a.ceil = (const float*)ptrs[7];
  a.dead = (uint8_t*)ptrs[8];
  a.alive = (uint32_t*)ptrs[9];
  a.ticket = (unsigned*)ptrs[10];
  a.table = (const int64_t*)ptrs[11];
  if (a.DP <= kParamRows) {
    for (int q = 0; q < a.DP; ++q) {
      const int64_t* p = ptrs + 12 + 4 * q;
      a.rows[q] = Row{(const float*)p[0], (const uint8_t*)p[1], (const uint8_t*)p[2], (const int32_t*)p[3]};
    }
  } else if (!a.table) {
    return (int)cudaErrorInvalidValue;
  }
  a.NC = (max(a.W, 1) + kRows - 1) / kRows;
  const int64_t base_bytes = ((int64_t)a.DP * a.R + a.R + (int64_t)kWarps * a.R) * 4;
  const int64_t table_bytes = ((int64_t)a.T * a.NWG + (int64_t)a.T * a.GR * a.R) * 4;
  if (base_bytes > kSmem) return (int)cudaErrorInvalidValue;
  a.stage = base_bytes + table_bytes <= kSmem;
  const size_t smem = (size_t)(base_bytes + (a.stage ? table_bytes : 0));
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(dp_dead_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  dp_dead_kernel<<<(1 + a.DP) * a.NC, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* dp_dead_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
