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
// reads). Row r's bit is set iff r and every row before it pass: base dead
// and every earlier row's opens dead for r, nothing touched below the
// base's w_open, no leftover (fill), no conflict with an earlier row q < r
// (q changed an existing node r may use — valid, r's existing-node gate,
// and count_cell.cuh's count at the base's usage and r_min[r] > 0, the
// ±1-verified count of `_count_cap_seq`; q records into a vg / hg group r
// applies; q changed a budget or node count of a template r's pods may
// consider, or any reservation capacity), no new spill, and the
// cumulative window / claims-axis offsets in bounds; packed into
// ceil(DP / 32) 32-bit lanes.
//
// Work items spread over the card. Block b is (row q = b / S, item
// b % S) of S = nT + nE + 1 items a row:
//   touch   a 2-D slab of the row's fill grid below the base's w_open
//           (kBH segments x kCols columns, 16-byte loads where the row
//           stride allows, no division per cell), or a kCols slab of its
//           pods column against the base's;
//   exist   32 existing nodes, a warp a field: the field's span over the
//           32 nodes compared in 16-, 4- or 1-byte words (usage as
//           floats), a lane a word; and row q's viability of the 32
//           nodes as a ballot;
//   misc    the leftover sum (an integer warp reduce), the vg / hg record
//           and apply masks, the budget / node-count touches and the apply
//           mask as bit words (a ballot per 32 groups or templates), any
//           reservation change.
// Findings become per-row bit words — flags (touched, leftover,
// reservation) and, per row, `mine` (touched nodes | vg / hg records |
// touched templates) and `theirs` (viable nodes | vg / hg applies |
// templates the row's pods consider) — by integer atomicOr, which is
// order-free, so the result is deterministic. A touch item whose row is
// already known touched skips its slab.
//
// The last-ticket block folds in bit words: a warp a row r, its lanes over
// the (q < r, word) pairs, ORs mine[q] & theirs[r] (and q's reservation
// bit), all loads at once; a thread a row loads the row's scalars and its
// deadness AND; thread 0 runs the prefix-AND and the offsets and writes
// the word;
// the block resets the workspace's words and the ticket, so no memset
// launch is needed.
//
// Bound on an H100: bytes — each row's fill grid below the base's
// w_open (or its pods column), its existing-node, budget and reservation
// fields, the base's, and the small per-row masks: a few hundred KB at
// most on the main path, a few KB on the cells'. At these sizes the
// launch is latency: every row's terms are found in parallel items, the
// last block only ORs bit words. Determinism: no float arithmetic but
// count_cell.cuh's and float compares; sums are integers.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "count_cell.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDP = 16;     // rows whose pointers ride the kernel's parameters (ops/cuda.py DP_VERDICT_ROWS)
constexpr int kExist = 9;      // exist_used, exist_ports, exist_vols, the six requirement components
constexpr int kCols = 4 * kThreads;  // columns of a touch slab, 4 a thread
constexpr int kBH = 4;         // fill-grid segments of a touch slab
constexpr unsigned kFull = 0xffffffffu;
enum { kTouched = 1u, kLeft = 2u, kRes = 4u };

struct Row {
  const int32_t* w_open;      // []
  const int32_t* n_open;      // []
  const int32_t* spills;      // []
  const int32_t* touch;       // fill: fill_c [B, W]; else pods [W]
  const int32_t* leftover;    // fill: [B]
  const uint8_t* exist[kExist];  // [E, ...] each
  const float* budget;        // [G, R]
  const float* nodes_budget;  // [G]
  const int32_t* res_cap;     // [RID]
  int B;                      // fill: the row's segments
};

struct Args {
  Row base;                     // touch = the base's pods
  Row rows[kMaxDP];
  int64_t exist_bytes[kExist];  // bytes per node of each existing-node field
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
  // the workspace, one per (device, stream), 0 between launches: flags
  // [DP], mine [DP, NW], theirs [DP, NW]; and the ticket
  uint32_t* ws;
  unsigned* ticket;
  int32_t* word;                // [ceil(DP / 32)] out
  int DP, W, E, R, NGv, NGh, G, RID, n_claims, fill, apply;
  int NWE, NWV, NWH, NWG, NW;   // bit words: nodes, vg groups, hg groups, templates (apply), their sum
  int nCol, nT, nE, S;          // touch slabs' columns, touch and exist items a row, items a row
};

// the cross-block protocol: bits ORed in before the ticket, loaded by the
// last block after it through L2 (the emulated suite swaps these three for
// tests/cuda_emu.h's checked versions)
__device__ __forceinline__ void xor_bits(uint32_t* p, uint32_t v) { atomicOr(p, v); }
__device__ __forceinline__ uint32_t xload(const uint32_t* p) { return __ldcg(p); }
__device__ __forceinline__ unsigned take_ticket(unsigned* t) { return atomicAdd(t, 1u); }

__device__ __forceinline__ bool aligned(const void* p, int n) { return ((uintptr_t)p & (n - 1)) == 0; }

__device__ __forceinline__ long long warp_sum(long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// 4 int32 from column c of a row (columns at or past n read as 0)
__device__ __forceinline__ int4 ints4(const int32_t* p, int c, int n) {
  if (c + 4 <= n && aligned(p + c, 16)) return *reinterpret_cast<const int4*>(p + c);
  int4 v = make_int4(0, 0, 0, 0);
  if (c < n) v.x = p[c];
  if (c + 1 < n) v.y = p[c + 1];
  if (c + 2 < n) v.z = p[c + 2];
  if (c + 3 < n) v.w = p[c + 3];
  return v;
}

// the nodes of a warp's span (n nodes of nb bytes from s and b) whose
// bytes differ: word w of the span (ws bytes) belongs to node w / k
template <class Word>
__device__ __forceinline__ uint32_t span_diff(const uint8_t* s, const uint8_t* b, int n, int k, int lane) {
  const Word* sw = reinterpret_cast<const Word*>(s);
  const Word* bw = reinterpret_cast<const Word*>(b);
  uint32_t m = 0;
  for (int w = lane; w < n * k; w += 32)
    if (!(sw[w] == bw[w])) m |= 1u << (w / k);
  return m;
}

struct U4 {
  uint4 v;
  __device__ bool operator==(const U4& o) const {
    return v.x == o.v.x && v.y == o.v.y && v.z == o.v.z && v.w == o.v.w;
  }
};

// the usage field: R floats a node, compared as floats (4 at a time
// where the span allows)
__device__ __forceinline__ uint32_t usage_diff(const float* s, const float* b, int n, int R, int lane) {
  uint32_t m = 0;
  if ((R & 3) == 0 && aligned(s, 16) && aligned(b, 16)) {
    const int k = R >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(s);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    for (int w = lane; w < n * k; w += 32) {
      const float4 x = s4[w], y = b4[w];
      if (x.x != y.x || x.y != y.y || x.z != y.z || x.w != y.w) m |= 1u << (w / k);
    }
  } else {
    for (int w = lane; w < n * R; w += 32)
      if (s[w] != b[w]) m |= 1u << (w / R);
  }
  return m;
}

__global__ void __launch_bounds__(kThreads) dp_verdict_kernel(const __grid_constant__ Args a) {
  __shared__ int s_last;
  __shared__ int s_conf[kMaxDP];
  __shared__ int s_ok[kMaxDP];
  __shared__ int s_w[kMaxDP], s_n[kMaxDP];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = blockIdx.x / a.S, t = blockIdx.x % a.S;
  const Row& row = a.rows[q];
  uint32_t* flags = a.ws;
  uint32_t* mine = a.ws + a.DP + (int64_t)q * a.NW;
  uint32_t* theirs = a.ws + a.DP + (int64_t)(a.DP + q) * a.NW;

  if (t < a.nT) {
    // ---- touch: a slab below the base's w_open
    const int bw = min(*a.base.w_open, a.W);
    const int c = (t % a.nCol) * kCols + 4 * tid;
    const int b0 = (t / a.nCol) * kBH;
    bool hit = false;
    if ((t % a.nCol) * kCols < bw && !(xload(&flags[q]) & kTouched)) {
      if (a.fill) {
        for (int b = b0; b < min(b0 + kBH, row.B); ++b) {
          const int4 x = ints4(row.touch + (int64_t)b * a.W, c, bw);
          hit = hit || x.x > 0 || x.y > 0 || x.z > 0 || x.w > 0;
        }
      } else {
        const int4 x = ints4(row.touch, c, bw), y = ints4(a.base.touch, c, bw);
        hit = x.x > y.x || x.y > y.y || x.z > y.z || x.w > y.w;
      }
    }
    if (__any_sync(kFull, hit) && lane == 0) xor_bits(&flags[q], kTouched);
  } else if (t < a.nT + a.nE) {
    // ---- exist: 32 nodes, a warp a field, and row q's viability of them
    __shared__ uint32_t s_m;
    const int e0 = (t - a.nT) * 32;
    const int n = min(32, a.E - e0);
    if (tid == 0) s_m = 0u;
    __syncthreads();
    uint32_t m = 0;
    for (int f = warp; f < kExist; f += kWarps) {
      const int nb = (int)a.exist_bytes[f];
      const uint8_t* s = row.exist[f] + (int64_t)e0 * nb;
      const uint8_t* b = a.base.exist[f] + (int64_t)e0 * nb;
      if (f == 0) m |= usage_diff((const float*)s, (const float*)b, n, a.R, lane);
      else if ((nb & 15) == 0 && aligned(s, 16) && aligned(b, 16)) m |= span_diff<U4>(s, b, n, nb >> 4, lane);
      else if ((nb & 3) == 0 && aligned(s, 4) && aligned(b, 4)) m |= span_diff<uint32_t>(s, b, n, nb >> 2, lane);
      else m |= span_diff<uint8_t>(s, b, n, nb, lane);
    }
    m = __reduce_or_sync(kFull, m);
    if (m && lane == 0) atomicOr(&s_m, m);
    if (warp == kWarps - 1) {
      const int e = e0 + lane;
      bool v = lane < n && a.exist_valid[e] && a.exist_ok_rows[(int64_t)q * a.E + e];
      if (v) v = ktpu::cell_count((const float*)a.base.exist[0] + (int64_t)e * a.R, a.r_min + (int64_t)q * a.R,
                                  a.exist_avail + (int64_t)e * a.R, a.R) > 0;
      const uint32_t via = __ballot_sync(kFull, v);
      if (via && lane == 0) xor_bits(&theirs[e0 >> 5], via);
    }
    __syncthreads();
    if (tid == 0 && s_m) xor_bits(&mine[e0 >> 5], s_m);
  } else {
    // ---- misc: leftovers, the group and template masks, reservations
    if (a.fill && warp == 0) {
      long long left = 0;
      for (int b = lane; b < row.B; b += 32) left += row.leftover[b];
      if (warp_sum(left) != 0 && lane == 0) xor_bits(&flags[q], kLeft);
    }
    const int jobs = a.NWV + a.NWH + a.NWG;
    for (int j = warp; j < jobs; j += kWarps) {
      bool x = false, y = false;
      if (j < a.NWV) {
        const int g = 32 * j + lane;
        x = g < a.NGv && a.rec_v[(int64_t)q * a.NGv + g];
        y = g < a.NGv && a.app_v[(int64_t)q * a.NGv + g];
      } else if (j < a.NWV + a.NWH) {
        const int g = 32 * (j - a.NWV) + lane;
        x = g < a.NGh && a.rec_h[(int64_t)q * a.NGh + g];
        y = g < a.NGh && a.app_h[(int64_t)q * a.NGh + g];
      } else {
        const int g = 32 * (j - a.NWV - a.NWH) + lane;
        if (g < a.G) {
          x = row.nodes_budget[g] != a.base.nodes_budget[g];
          for (int k = 0; k < a.R && !x; ++k) x = row.budget[(int64_t)g * a.R + k] != a.base.budget[(int64_t)g * a.R + k];
          y = a.apply_tmpl[(int64_t)q * a.G + g];
        }
      }
      const uint32_t bx = __ballot_sync(kFull, x), by = __ballot_sync(kFull, y);
      if (lane == 0) {
        if (bx) xor_bits(&mine[a.NWE + j], bx);
        if (by) xor_bits(&theirs[a.NWE + j], by);
      }
    }
    if (a.apply) {
      bool res = false;
      for (int i = tid; i < a.RID; i += kThreads) res = res || row.res_cap[i] != a.base.res_cap[i];
      if (__any_sync(kFull, res) && lane == 0) xor_bits(&flags[q], kRes);
    }
  }

  // ---- the ticket: every warp's bits are published before it is taken
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = take_ticket(a.ticket) == (unsigned)(a.DP * a.S - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // ---- the last block: conflicts a warp a row, the rows' terms a thread a row
  for (int r = warp; r < a.DP; r += kWarps) {
    const uint32_t* th = a.ws + a.DP + (int64_t)(a.DP + r) * a.NW;
    bool x = false;
    for (int i = lane; i < r * a.NW; i += 32) {
      const int qq = i / a.NW, j = i - qq * a.NW;
      x = x || (xload(a.ws + a.DP + (int64_t)qq * a.NW + j) & xload(&th[j])) != 0;
    }
    if (a.apply)
      for (int qq = lane; qq < r; qq += 32) x = x || (xload(&a.ws[qq]) & kRes) != 0;
    const bool c = __any_sync(kFull, x);
    if (lane == 0) s_conf[r] = c;
  }
  if (tid < a.DP) {
    const Row& rr = a.rows[tid];
    const uint8_t* dr = a.dead + (int64_t)tid * (1 + a.DP);
    const uint32_t fl = xload(&a.ws[tid]);
    const int sp = *rr.spills, bsp = *a.base.spills;
    s_w[tid] = *rr.w_open;
    s_n[tid] = *rr.n_open;
    bool ok = dr[0] != 0;
    for (int qq = 0; qq < tid; ++qq) ok &= dr[1 + qq] != 0;
    s_ok[tid] = ok && !(fl & (kTouched | kLeft)) && sp == bsp;
  }
  __syncthreads();
  if (tid == 0) {
    const int bw0 = *a.base.w_open, bn = *a.base.n_open;
    int64_t cw = 0, cn = 0;
    bool prefix = true;
    uint32_t lanes = 0;
    for (int r = 0; r < a.DP; ++r) {
      cw += (int64_t)s_w[r] - bw0;
      cn += (int64_t)s_n[r] - bn;
      prefix = prefix && s_ok[r] && !s_conf[r] && bw0 + cw <= a.W && bn + cn <= a.n_claims;
      if (prefix) lanes |= 1u << (r & 31);
      if ((r & 31) == 31 || r == a.DP - 1) {
        a.word[r >> 5] = (int32_t)lanes;
        lanes = 0;
      }
    }
    *a.ticket = 0u;
  }
  for (int i = tid; i < a.DP * (1 + 2 * a.NW); i += kThreads) a.ws[i] = 0u;
}

}  // namespace

// ptrs, in ops/cuda.py dp_verdict's order: base w_open, n_open, spills,
// pods, the 9 existing-node fields, (apply) budget, nodes_budget, res_cap;
// dead, r_min, exist_ok_rows, rec_v, app_v, rec_h, app_h, (apply)
// apply_tmpl, exist_valid, exist_avail; per dp row: w_open, n_open,
// spills, fill_c (fill) or pods, (fill) leftover, the 9 existing-node
// fields, (apply) budget, nodes_budget, res_cap; then the workspace's
// words and ticket and the word. dims: DP, W, E, R, NGv, NGh, G, RID,
// n_claims, fill, apply, the workspace words the caller holds, the 9
// existing-node fields' bytes per node, then each row's segments (fill;
// else 0). At most kMaxDP rows: their pointers ride the kernel's
// parameters.
extern "C" int dp_verdict(const int64_t* ptrs, int n_ptrs, const int64_t* dims, void* stream) {
  Args a;
  memset(&a, 0, sizeof(a));
  int* f[] = {&a.DP, &a.W, &a.E, &a.R, &a.NGv, &a.NGh, &a.G, &a.RID, &a.n_claims, &a.fill, &a.apply};
  for (int k = 0; k < 11; ++k) *f[k] = (int)dims[k];
  const int per_row = 3 + 1 + (a.fill ? 1 : 0) + kExist + (a.apply ? 3 : 0);
  const int n_base = 4 + kExist + (a.apply ? 3 : 0), n_shared = 9 + (a.apply ? 1 : 0);
  if (a.DP < 1 || a.DP > kMaxDP || n_ptrs != n_base + n_shared + per_row * a.DP + 3 || a.W < 0 || a.E < 0 ||
      a.R < 0 || a.NGv < 0 || a.NGh < 0 || a.G < 0 || a.RID < 0)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < kExist; ++k) a.exist_bytes[k] = dims[12 + k];
  if (a.exist_bytes[0] != 4 * (int64_t)a.R) return (int)cudaErrorInvalidValue;
  int i = 0;
  auto take_row = [&](Row& r, bool leftover) {
    r.w_open = (const int32_t*)ptrs[i++];
    r.n_open = (const int32_t*)ptrs[i++];
    r.spills = (const int32_t*)ptrs[i++];
    r.touch = (const int32_t*)ptrs[i++];
    if (leftover) r.leftover = (const int32_t*)ptrs[i++];
    for (int k = 0; k < kExist; ++k) r.exist[k] = (const uint8_t*)ptrs[i++];
    if (a.apply) {
      r.budget = (const float*)ptrs[i++];
      r.nodes_budget = (const float*)ptrs[i++];
      r.res_cap = (const int32_t*)ptrs[i++];
    }
  };
  take_row(a.base, false);
  a.dead = (const uint8_t*)ptrs[i++];
  a.r_min = (const float*)ptrs[i++];
  a.exist_ok_rows = (const uint8_t*)ptrs[i++];
  a.rec_v = (const uint8_t*)ptrs[i++];
  a.app_v = (const uint8_t*)ptrs[i++];
  a.rec_h = (const uint8_t*)ptrs[i++];
  a.app_h = (const uint8_t*)ptrs[i++];
  if (a.apply) a.apply_tmpl = (const uint8_t*)ptrs[i++];
  a.exist_valid = (const uint8_t*)ptrs[i++];
  a.exist_avail = (const float*)ptrs[i++];
  int Bmax = 0;
  for (int q = 0; q < a.DP; ++q) {
    take_row(a.rows[q], a.fill != 0);
    a.rows[q].B = (int)dims[21 + q];
    if (a.rows[q].B < 0) return (int)cudaErrorInvalidValue;
    Bmax = max(Bmax, a.rows[q].B);
  }
  a.ws = (uint32_t*)ptrs[i++];
  a.ticket = (unsigned*)ptrs[i++];
  a.word = (int32_t*)ptrs[i++];
  a.NWE = (a.E + 31) / 32;
  a.NWV = (a.NGv + 31) / 32;
  a.NWH = (a.NGh + 31) / 32;
  a.NWG = a.apply ? (a.G + 31) / 32 : 0;
  a.NW = a.NWE + a.NWV + a.NWH + a.NWG;
  if (dims[11] < (int64_t)a.DP * (1 + 2 * a.NW)) return (int)cudaErrorInvalidValue;
  a.nCol = (max(a.W, 1) + kCols - 1) / kCols;
  a.nT = a.nCol * (a.fill ? max((Bmax + kBH - 1) / kBH, 1) : 1);
  a.nE = a.NWE;
  a.S = a.nT + a.nE + 1;
  dp_verdict_kernel<<<a.DP * a.S, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* dp_verdict_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
