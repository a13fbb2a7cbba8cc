// H12 dp_dead — the deadness matrix of a dp merge round, replacing the
// deadness half of the JAX package's `_dp_verdict_word` (ops/solver.py:
// 2100-2153): `_rows_dead` (:2030) in the fill and per-pod families and
// `_kscan_rows_dead` (:3557) in the kind scan's.
//
// One launch per round. Block (r, s) of the DP x (1 + DP) grid decides
// entry [r, s] of the [DP, 1 + DP] result: whether every row of source s
// is capacity-dead for row r's min request r_min[r]. Source 0 is the
// round base's live open rows; source 1 + q the rows dp row q opened,
// [base.w_open, w_open[q]) that are open. A row is alive when some
// viable type t (its[row, t]) has an allocatable group g that takes
// another pod:
//   fill / per-pod: group_valid[t, g] and, over every resource r,
//     used + r_min (one f32 add) <= alloc[t, g, r] or the sum is 0;
//   kind scan: the per-cell count of count_cell.cuh (shared with H2, H5
//     and H9) at (used, r_min) is > 0, in a cell some domain d of the key
//     admits (the type's key requirement holds d and, for the zone key, an
//     available offering in zone d; for another key, any available
//     offering) — the all-admitting masks of `_kscan_rows_dead`.
// r_min = +inf (a padding row) fits no cell: inf totals exceed every
// allocatable, 0 * inf is NaN and fails every comparison.
//
// A warp walks one row at a time, its lanes over the types; the block
// stops at the first alive row (a shared flag read between rows). The
// kind scan's per-cell domain test is built once per block in shared
// memory ([T, GR] bytes, at most kCells).
//
// Bound on an H100: bytes — each source's open rows' [T] viable-type
// bytes and [R] usage, once per r, and the catalog's alloc. A round of
// a few hundred open rows of 1000 types is ~1 MB per (r, s), well under
// a millisecond at 3.35 TB/s; the block per (r, s) is latency-bound
// (DP (1 + DP) blocks: six at DP = 2).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "count_cell.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCells = 16384;  // the kind scan's [T, GR] cell table, in shared memory

struct Args {
  // the round base
  const float* base_used;     // [W, R]
  const uint8_t* base_its;    // [W, T]
  const uint8_t* base_open;   // [W]
  const int32_t* base_w_open; // []
  // per dp row q: rows[q * 4 + {0 used, 1 its, 2 open, 3 w_open}]
  const int64_t* rows;        // [DP, 4] device pointers
  const float* r_min;         // [DP, R]
  const float* alloc;         // [T, GR, R]
  const uint8_t* group_valid; // [T, GR]
  // the kind scan's key: the catalog's requirement rows and offerings
  const uint8_t* it_mask;     // [T, K, V]
  const uint8_t* it_defined;  // [T, K]
  const uint8_t* zc_avail;    // [T, GR, Z, C]
  uint8_t* dead;              // [DP, 1 + DP] out
  int DP, W, T, GR, R, kscan, key_kid, zone_kid, D, K, V, Z, C;
};

__device__ bool cell_alive(const Args& a, const float* u, const float* q, int t, int g, const uint8_t* kadm) {
  if (!a.group_valid[t * a.GR + g]) return false;
  const float* al = a.alloc + ((int64_t)t * a.GR + g) * a.R;
  if (a.kscan) return kadm[t * a.GR + g] && ktpu::cell_count(u, q, al, a.R) > 0;
  for (int r = 0; r < a.R; ++r) {
    const float tot = __fadd_rn(u[r], q[r]);
    if (!(tot <= al[r] || tot == 0.0f)) return false;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads) dp_dead_kernel(const __grid_constant__ Args a) {
  __shared__ uint8_t kadm[kCells];  // [T, GR]: some domain of the key admits the cell
  __shared__ int alive;
  const int rr = blockIdx.x / (1 + a.DP), s = blockIdx.x % (1 + a.DP);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) alive = 0;
  if (a.kscan) {
    for (int c = tid; c < a.T * a.GR; c += kThreads) {
      const int t = c / a.GR, g = c % a.GR;
      const bool undef = !a.it_defined[t * a.K + a.key_kid];
      const uint8_t* km = a.it_mask + ((int64_t)t * a.K + a.key_kid) * a.V;
      const uint8_t* av = a.zc_avail + ((int64_t)t * a.GR + g) * a.Z * a.C;
      bool any_off = false;  // another key: any available offering
      for (int z = 0; z < a.Z * a.C; ++z) any_off = any_off || av[z];
      bool ok = false;
      for (int d = 0; d < a.D && !ok; ++d) {
        if (!(undef || km[d])) continue;
        if (a.key_kid == a.zone_kid) {
          if (d < a.Z)
            for (int cc = 0; cc < a.C; ++cc) ok = ok || av[d * a.C + cc];
        } else {
          ok = any_off;
        }
      }
      kadm[c] = ok;
    }
  }
  __syncthreads();

  const float* q = a.r_min + (int64_t)rr * a.R;
  const float* used;
  const uint8_t *its, *open;
  int lo = 0, hi = a.W;
  if (s == 0) {
    used = a.base_used;
    its = a.base_its;
    open = a.base_open;
  } else {
    const int64_t* row = a.rows + (int64_t)(s - 1) * 4;
    used = (const float*)row[0];
    its = (const uint8_t*)row[1];
    open = (const uint8_t*)row[2];
    lo = max(*a.base_w_open, 0);
    hi = min(*(const int32_t*)row[3], a.W);
  }
  for (int i = lo + warp; i < hi; i += kWarps) {
    if (__shfl_sync(0xffffffffu, *(volatile int*)&alive, 0)) break;
    if (!open[i]) continue;
    const uint8_t* it_row = its + (int64_t)i * a.T;
    const float* u = used + (int64_t)i * a.R;
    bool found = false;
    for (int t = lane; t < a.T && !found; t += 32) {
      if (!it_row[t]) continue;
      for (int g = 0; g < a.GR && !found; ++g) found = cell_alive(a, u, q, t, g, kadm);
    }
    if (__any_sync(0xffffffffu, found) && lane == 0) alive = 1;
  }
  __syncthreads();
  if (tid == 0) a.dead[blockIdx.x] = !alive;
}

}  // namespace

// ptrs: base used, its, open, w_open; the [DP, 4] row table; r_min,
// alloc, group_valid, it_mask, it_defined, zc_avail, dead. dims: DP, W,
// T, GR, R, kscan, key_kid, zone_kid, D, K, V, Z, C.
extern "C" int dp_dead(const int64_t* ptrs, int n_ptrs, const int64_t* dims, void* stream) {
  if (n_ptrs != 12) return (int)cudaErrorInvalidValue;
  Args a;
  memset(&a, 0, sizeof(a));
  a.base_used = (const float*)ptrs[0];
  a.base_its = (const uint8_t*)ptrs[1];
  a.base_open = (const uint8_t*)ptrs[2];
  a.base_w_open = (const int32_t*)ptrs[3];
  a.rows = (const int64_t*)ptrs[4];
  a.r_min = (const float*)ptrs[5];
  a.alloc = (const float*)ptrs[6];
  a.group_valid = (const uint8_t*)ptrs[7];
  a.it_mask = (const uint8_t*)ptrs[8];
  a.it_defined = (const uint8_t*)ptrs[9];
  a.zc_avail = (const uint8_t*)ptrs[10];
  a.dead = (uint8_t*)ptrs[11];
  int* f[] = {&a.DP, &a.W, &a.T, &a.GR, &a.R, &a.kscan, &a.key_kid, &a.zone_kid, &a.D, &a.K, &a.V, &a.Z, &a.C};
  for (int i = 0; i < 13; ++i) *f[i] = (int)dims[i];
  if (a.DP < 1 || (a.kscan && ((int64_t)a.T * a.GR > kCells || a.key_kid < 0 || a.key_kid >= a.K || a.D > a.V)))
    return (int)cudaErrorInvalidValue;
  dp_dead_kernel<<<a.DP * (1 + a.DP), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* dp_dead_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
