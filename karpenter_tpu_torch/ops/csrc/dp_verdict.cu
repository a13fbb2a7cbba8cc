// H13 dp_verdict — the packed commit verdict of a dp merge round,
// replacing the rest of the JAX package's `_dp_verdict_word`
// (ops/solver.py:2100-2153) with the family terms it takes: the touched
// bits (`fill_touched_below` :2170 for fill, more pods below the base's
// w_open for the kind scan and per-pod families), `_exist_conflict_ok`
// (:2076, over `_exist_touched` :2055), the vg / hg record-vs-apply bits,
// `_budget_res_conflict` (:3534), kernels.py `pairwise_commit_ok` (:315)
// and `pack_bool` (:265).
//
// One launch per round, after H12 (whose [DP, 1 + DP] deadness matrix it
// reads). Block q reads dp row q's state against the round base: its
// touched bit, its leftover sum (fill), which existing nodes it changed
// (any field of the node: usage as floats, ports, volumes and the six
// requirement components as bytes), which templates' budgets or node
// counts it changed and whether any reservation capacity moved. It writes
// them to scratch, fences and takes a ticket; the block that draws the
// last ticket folds the word: each existing node's viability for row r
// (valid, r's existing-node gate, and count_cell.cuh's count at the
// base's usage and r_min[r] > 0 — the ±1-verified count of
// `_count_cap_seq`, rounded the same way), the pairwise conflicts of
// every earlier row q < r (debits, records into groups r applies, budget
// and reservation touches), then per row: base dead, every earlier row's
// opens dead, not touched, no conflict, no leftover, no new spill, and the
// cumulative window / claims-axis offsets in bounds; the prefix-AND, into
// ceil(DP / 32) 32-bit lanes.
//
// Bound on an H100: bytes — each row's fill grid below the base's
// w_open (or its pods column), its existing-node, budget and reservation
// fields, the base's, and the small per-row masks: a few hundred KB at
// most on the main path. The work is a chain of small dependent steps,
// latency-bound: a block per row and a last-block fold after a ticket (the
// H11 objective_verdict pattern), no second launch. Determinism: no
// float arithmetic but count_cell.cuh's; integer sums in int64.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "count_cell.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kExist = 9;  // exist_used, exist_ports, exist_vols, the six requirement components
// the row table's columns
enum { kWOpen, kNOpen, kSpills, kTouch, kB, kLeftover, kExist0, kBudget = kExist0 + kExist, kNodesBudget, kResCap,
       kRowF };

struct Args {
  const int64_t* rows;          // [DP, kRowF]: device pointers (kB a count)
  const int32_t* base_w_open;   // []
  const int32_t* base_n_open;   // []
  const int32_t* base_spills;   // []
  const int32_t* base_pods;     // [W]
  const uint8_t* base_exist[kExist];  // [E, ...] each
  int64_t exist_bytes[kExist];  // bytes per node of each existing-node field
  const float* base_budget;     // [G, R]
  const float* base_nodes_budget;  // [G]
  const int32_t* base_res_cap;  // [RID]
  const uint8_t* dead;          // [DP, 1 + DP] (H12)
  const float* r_min;           // [DP, R]
  const uint8_t* exist_ok_rows; // [DP, E]
  const uint8_t* rec_v;         // [DP, NGv]
  const uint8_t* app_v;
  const uint8_t* rec_h;         // [DP, NGh]
  const uint8_t* app_h;
  const uint8_t* apply_tmpl;    // [DP, G] or null (no budget bit)
  const uint8_t* exist_valid;   // [E]
  const float* exist_avail;     // [E, R]
  uint8_t* touch_e;             // [DP, E] scratch
  uint8_t* touch_b;             // [DP, G] scratch
  uint8_t* viable;              // [DP, E] scratch
  int32_t* rowbits;             // [DP, 4] scratch: touched, leftover, reservation touched, extra ok
  int32_t* ticket;              // [1], 0 at launch
  int32_t* word;                // [lanes] out
  int DP, W, E, R, NGv, NGh, G, RID, n_claims, fill;
};

template <class T>
__device__ __forceinline__ T ld(const T* p) {
  return *(const volatile T*)p;
}

__device__ bool any_block(bool x, int* flag) {
  if (threadIdx.x == 0) *flag = 0;
  __syncthreads();
  if (x) *flag = 1;
  __syncthreads();
  const bool r = *flag != 0;
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kThreads) dp_verdict_kernel(const __grid_constant__ Args a) {
  __shared__ int flag;
  __shared__ int last;
  const int q = blockIdx.x, tid = threadIdx.x;
  const int64_t* row = a.rows + (int64_t)q * kRowF;
  const int bw = min(*a.base_w_open, a.W);

  // ---- row q against the base ---------------------------------------------
  bool touched = false;
  if (a.fill) {
    const int32_t* fc = (const int32_t*)row[kTouch];
    const int64_t B = row[kB];
    for (int64_t c = tid; c < B * bw; c += kThreads) touched = touched || fc[(c / bw) * a.W + c % bw] > 0;
  } else {
    const int32_t* pods = (const int32_t*)row[kTouch];
    for (int i = tid; i < bw; i += kThreads) touched = touched || pods[i] > a.base_pods[i];
  }
  touched = any_block(touched, &flag);
  bool left = false;
  if (a.fill) {
    const int32_t* lo = (const int32_t*)row[kLeftover];
    int64_t sum = 0;
    if (tid == 0)
      for (int64_t b = 0; b < row[kB]; ++b) sum += lo[b];
    left = sum != 0;
  }
  left = any_block(left, &flag);
  // existing nodes the row changed
  for (int e = tid; e < a.E; e += kThreads) {
    bool d = false;
    const float* su = (const float*)row[kExist0] + (int64_t)e * a.R;
    const float* bu = (const float*)a.base_exist[0] + (int64_t)e * a.R;
    for (int r = 0; r < a.R; ++r) d = d || su[r] != bu[r];
    for (int f = 1; f < kExist; ++f) {
      const uint8_t* s = (const uint8_t*)row[kExist0 + f] + e * a.exist_bytes[f];
      const uint8_t* b = a.base_exist[f] + e * a.exist_bytes[f];
      for (int64_t k = 0; k < a.exist_bytes[f]; ++k) d = d || s[k] != b[k];
    }
    a.touch_e[(int64_t)q * a.E + e] = d;
  }
  // budgets, node counts and reservation capacities the row changed
  bool res = false;
  if (a.apply_tmpl) {
    const float* sb = (const float*)row[kBudget];
    const float* sn = (const float*)row[kNodesBudget];
    for (int g = tid; g < a.G; g += kThreads) {
      bool d = sn[g] != a.base_nodes_budget[g];
      for (int r = 0; r < a.R; ++r) d = d || sb[(int64_t)g * a.R + r] != a.base_budget[(int64_t)g * a.R + r];
      a.touch_b[(int64_t)q * a.G + g] = d;
    }
    const int32_t* sr = (const int32_t*)row[kResCap];
    for (int i = tid; i < a.RID; i += kThreads) res = res || sr[i] != a.base_res_cap[i];
  }
  __threadfence();  // every thread's touch bytes before the ticket
  res = any_block(res, &flag);
  if (tid == 0) {
    a.rowbits[q * 4 + 0] = touched;
    a.rowbits[q * 4 + 1] = left;
    a.rowbits[q * 4 + 2] = res;
    __threadfence();
    last = atomicAdd(a.ticket, 1) == a.DP - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // ---- the last block: viability, conflicts, the word ----------------------
  for (int64_t c = tid; c < (int64_t)a.DP * a.E; c += kThreads) {
    const int r = (int)(c / a.E), e = (int)(c % a.E);
    bool v = a.exist_valid[e] && a.exist_ok_rows[c];
    if (v) v = ktpu::cell_count((const float*)a.base_exist[0] + (int64_t)e * a.R, a.r_min + (int64_t)r * a.R,
                                a.exist_avail + (int64_t)e * a.R, a.R) > 0;
    a.viable[c] = v;
  }
  __syncthreads();
  for (int r = tid; r < a.DP; r += kThreads) {
    bool conflict = false;
    for (int qq = 0; qq < r && !conflict; ++qq) {
      for (int e = 0; e < a.E && !conflict; ++e)
        conflict = ld(a.touch_e + (int64_t)qq * a.E + e) && a.viable[(int64_t)r * a.E + e];
      for (int g = 0; g < a.NGv && !conflict; ++g)
        conflict = a.rec_v[(int64_t)qq * a.NGv + g] && a.app_v[(int64_t)r * a.NGv + g];
      for (int g = 0; g < a.NGh && !conflict; ++g)
        conflict = a.rec_h[(int64_t)qq * a.NGh + g] && a.app_h[(int64_t)r * a.NGh + g];
      if (a.apply_tmpl) {
        conflict = conflict || ld(a.rowbits + qq * 4 + 2);
        for (int g = 0; g < a.G && !conflict; ++g)
          conflict = ld(a.touch_b + (int64_t)qq * a.G + g) && a.apply_tmpl[(int64_t)r * a.G + g];
      }
    }
    a.rowbits[r * 4 + 3] = !conflict;
  }
  __syncthreads();
  if (tid == 0) {
    const int bw0 = *a.base_w_open, bn = *a.base_n_open, bs = *a.base_spills;
    int64_t cw = 0, cn = 0;
    bool prefix = true;
    uint32_t lane = 0;
    for (int r = 0; r < a.DP; ++r) {
      const int64_t* rr = a.rows + (int64_t)r * kRowF;
      const int32_t w = *(const int32_t*)rr[kWOpen], n = *(const int32_t*)rr[kNOpen];
      const int32_t sp = *(const int32_t*)rr[kSpills];
      cw += (int64_t)w - bw0;
      cn += (int64_t)n - bn;
      const uint8_t* dr = a.dead + (int64_t)r * (1 + a.DP);
      bool ok = dr[0] != 0;
      for (int qq = 0; qq < r; ++qq) ok = ok && dr[1 + qq] != 0;
      ok = ok && !ld(a.rowbits + r * 4 + 0) && !ld(a.rowbits + r * 4 + 1) && a.rowbits[r * 4 + 3] && sp == bs &&
           bw0 + cw <= a.W && bn + cn <= a.n_claims;
      prefix = prefix && ok;
      if (prefix) lane |= 1u << (r & 31);
      if ((r & 31) == 31 || r == a.DP - 1) {
        a.word[r >> 5] = (int32_t)lane;
        lane = 0;
      }
    }
  }
}

}  // namespace

// ptrs: the row table, base w_open, n_open, spills, pods, the 9 base
// existing-node fields, base budget, nodes_budget, res_cap, dead, r_min,
// exist_ok_rows, rec_v, app_v, rec_h, app_h, apply_tmpl (0: none),
// exist_valid, exist_avail, touch_e, touch_b, viable, rowbits, ticket,
// word. dims: DP, W, E, R, NGv, NGh, G, RID, n_claims, fill, then the 9
// existing-node fields' bytes per node.
extern "C" int dp_verdict(const int64_t* ptrs, int n_ptrs, const int64_t* dims, void* stream) {
  if (n_ptrs != 33) return (int)cudaErrorInvalidValue;
  Args a;
  memset(&a, 0, sizeof(a));
  int i = 0;
  a.rows = (const int64_t*)ptrs[i++];
  a.base_w_open = (const int32_t*)ptrs[i++];
  a.base_n_open = (const int32_t*)ptrs[i++];
  a.base_spills = (const int32_t*)ptrs[i++];
  a.base_pods = (const int32_t*)ptrs[i++];
  for (int f = 0; f < kExist; ++f) a.base_exist[f] = (const uint8_t*)ptrs[i++];
  a.base_budget = (const float*)ptrs[i++];
  a.base_nodes_budget = (const float*)ptrs[i++];
  a.base_res_cap = (const int32_t*)ptrs[i++];
  a.dead = (const uint8_t*)ptrs[i++];
  a.r_min = (const float*)ptrs[i++];
  a.exist_ok_rows = (const uint8_t*)ptrs[i++];
  a.rec_v = (const uint8_t*)ptrs[i++];
  a.app_v = (const uint8_t*)ptrs[i++];
  a.rec_h = (const uint8_t*)ptrs[i++];
  a.app_h = (const uint8_t*)ptrs[i++];
  a.apply_tmpl = (const uint8_t*)ptrs[i++];
  a.exist_valid = (const uint8_t*)ptrs[i++];
  a.exist_avail = (const float*)ptrs[i++];
  a.touch_e = (uint8_t*)ptrs[i++];
  a.touch_b = (uint8_t*)ptrs[i++];
  a.viable = (uint8_t*)ptrs[i++];
  a.rowbits = (int32_t*)ptrs[i++];
  a.ticket = (int32_t*)ptrs[i++];
  a.word = (int32_t*)ptrs[i++];
  int* f[] = {&a.DP, &a.W, &a.E, &a.R, &a.NGv, &a.NGh, &a.G, &a.RID, &a.n_claims, &a.fill};
  for (int k = 0; k < 10; ++k) *f[k] = (int)dims[k];
  for (int k = 0; k < kExist; ++k) a.exist_bytes[k] = dims[10 + k];
  if (a.DP < 1 || a.exist_bytes[0] != 4 * (int64_t)a.R) return (int)cudaErrorInvalidValue;
  dp_verdict_kernel<<<a.DP, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* dp_verdict_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
