// H14 merge_shard — one dp commit, out of place, replacing the JAX
// package's `merge_shard_fill` (ops/solver.py:2287, with
// `_graft_window_fields` :2191, `_graft_exist_fields` :2239 and
// `_merge_hg_delta` :2263) and `merge_shard_kscan` (:3666).
//
// One launch per committed row. Every output is a fresh buffer:
//   window rows: row i takes the speculative row's window row
//     src = base_w_open + (i - committed.w_open) when 0 <= i -
//     committed.w_open < k = spec.w_open - base_w_open (a grabbed row),
//     else the committed row i, column by column (requirement components,
//     used, its, template, pods, claim ports, held); open = committed.open
//     | grabbed; slot_of of a grabbed row is the spec's shifted by delta =
//     committed.n_open - base_n_open where base_n_open <= slot < NB (the
//     shifted slot map, [W], is an output too);
//   existing nodes: a node the row touched (any field differs from the
//     round base: usage as floats, the others as bytes) takes the row's
//     fields whole, else the committed node's;
//   hostname-group counts: columns [0, E) add the row's delta in place,
//     fresh-claim columns add it shifted by delta;
//   kscan / per-pod mode: vg counts add the row's delta; finite base
//     budgets and node counts add (spec - base), one IEEE subtraction and
//     one addition (infinite ones add 0); reservation capacities add the
//     int delta; assignment slots >= E + base_n_open move by delta;
//   n_open, w_open = committed.w_open + k, w_hw = max(committed w_hw, w_open).
//
// Window columns as byte ranges. A contiguous [W, b] column is at most
// three byte ranges, found on the device from cw = committed.w_open and k:
// [0, cw*b) from committed, [cw*b, (cw+k)*b) from the spec's [bw*b,
// (bw+k)*b) (bw = base_w_open), the rest from committed (a state keeps 0
// <= w_open <= W, so the grabbed rows' sources lie in the window; where
// they would not, the plain version's clamped source row is copied row by
// row). The columns' bytes are cut into chunks of kChunk, balanced over
// the blocks by bytes (the C entry's prefix over the columns): a block
// copies its chunk's pieces as 16-byte vectors (4-byte words where the
// source and destination differ in alignment mod 16, bytes mod 4), heads
// and tails apart. Existing nodes: a warp a node compares the spec's
// fields with the base's in words and decides with __any_sync, then copies
// the node whole from the spec or committed. The elementwise outputs
// (open, slot_of and the shifted map, the count, debit and reservation
// deltas, the assignment shift) are grid-stride loops over every block,
// with the plain version's IEEE steps.
//
// Bound on an H100: bytes — every window column read once (committed or
// row) and written once, the existing-node fields of three states, the
// count and debit arrays: ~10 MB at W = 4096 over 1000 types, ~3 µs at
// 3.35 TB/s; a few hundred KB on the dp cells', where the launch is
// latency and the chunks spread it over the SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWin = 16;       // window columns (the six requirement components + the rest)
constexpr int kExist = 9;      // existing-node fields; field 0 is the [E, R] f32 usage
constexpr int kChunk = 16 * kThreads;  // window bytes a block copies at a time
constexpr int kMaxGrid = 2048;

struct Col {
  const uint8_t* c;  // committed
  const uint8_t* s;  // the speculative row
  const uint8_t* b;  // the round base (existing-node fields)
  uint8_t* d;        // out
  int64_t bytes;     // per window row / per node
  int64_t first;     // window columns: the column's first chunk
};

struct Args {
  Col win[kWin];
  Col exist[kExist];
  const uint8_t* c_open;
  uint8_t* d_open;
  const int32_t *c_slot, *s_slot;
  int32_t *d_slot, *shifted;
  const int32_t *c_hg, *s_hg, *b_hg;
  int32_t* d_hg;
  const int32_t *c_vg, *s_vg, *b_vg;
  int32_t* d_vg;
  const float *c_budget, *s_budget, *b_budget;
  float* d_budget;
  const float *c_nodes, *s_nodes, *b_nodes;
  float* d_nodes;
  const int32_t *c_res, *s_res, *b_res;
  int32_t* d_res;
  const int32_t* assign_in;
  int32_t* assign_out;
  const int32_t *c_n_open, *c_w_open, *c_w_hw, *s_n_open, *s_w_open, *b_n_open, *b_w_open;
  int32_t *d_n_open, *d_w_open, *d_w_hw;
  int n_win, W, NB, E, R, NGh, S, NGv, V, G, RID, NA, kscan;
  int64_t chunks;  // window chunks over every column
  int exist_blocks;
  int grid;        // blocks in the launch
};

// n bytes from src to dst by the block's threads: 16-byte vectors where
// the two agree mod 16, 4-byte words where they agree mod 4, else bytes;
// the head bytes up to the first aligned destination and the tail apart
__device__ void copy_bytes(uint8_t* dst, const uint8_t* src, int64_t n, int tid, int nthreads) {
  const uintptr_t mis = ((uintptr_t)dst ^ (uintptr_t)src);
  const int w = (mis & 15) == 0 ? 16 : (mis & 3) == 0 ? 4 : 1;
  int64_t head = w == 1 ? n : (int64_t)((w - ((uintptr_t)dst & (w - 1))) & (w - 1));
  if (head > n) head = n;
  const int64_t body = (n - head) / w;
  for (int64_t x = tid; x < head; x += nthreads) dst[x] = src[x];
  if (w == 16) {
    uint4* d4 = reinterpret_cast<uint4*>(dst + head);
    const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
    for (int64_t x = tid; x < body; x += nthreads) d4[x] = s4[x];
  } else if (w == 4) {
    uint32_t* d4 = reinterpret_cast<uint32_t*>(dst + head);
    const uint32_t* s4 = reinterpret_cast<const uint32_t*>(src + head);
    for (int64_t x = tid; x < body; x += nthreads) d4[x] = s4[x];
  }
  for (int64_t x = head + body * w + tid; x < n; x += nthreads) dst[x] = src[x];
}

__device__ __forceinline__ int32_t shift_slot(int32_t so, int32_t bn, int NB, int32_t delta) {
  return so >= bn && so < NB ? so + delta : so;
}

__global__ void __launch_bounds__(kThreads) merge_shard_kernel(const __grid_constant__ Args a) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t cw = *a.c_w_open, bw = *a.b_w_open, bn = *a.b_n_open;
  const int32_t k = *a.s_w_open - bw;
  const int32_t delta = *a.c_n_open - bn;
  // grabbed rows [g0, g1), their sources from bw + g0 - cw
  const int64_t g0 = min(max(cw, 0), a.W);
  const int64_t g1 = k > 0 ? min(max((int64_t)cw + k, g0), (int64_t)a.W) : g0;
  const int64_t src0 = (int64_t)bw + g0 - cw;
  const bool inside = g1 == g0 || (src0 >= 0 && src0 + (g1 - g0) <= a.W);

  // ---- window columns: chunks of bytes, each at most three pieces
  for (int64_t j = blockIdx.x; j < a.chunks; j += a.grid) {
    int c = 0;
    while (c + 1 < a.n_win && a.win[c + 1].first <= j) ++c;
    const Col& col = a.win[c];
    const int64_t x0 = (j - col.first) * kChunk, x1 = min(x0 + kChunk, (int64_t)a.W * col.bytes);
    const int64_t ga = g0 * col.bytes, gb = g1 * col.bytes;
    // committed before the grabbed rows, the grabbed rows, committed after
    if (x0 < min(x1, ga)) copy_bytes(col.d + x0, col.c + x0, min(x1, ga) - x0, tid, kThreads);
    const int64_t m0 = max(x0, ga), m1 = min(x1, gb);
    if (m0 < m1) {
      if (inside) {
        copy_bytes(col.d + m0, col.s + m0 + (src0 - g0) * col.bytes, m1 - m0, tid, kThreads);
      } else {
        for (int64_t x = m0 + tid; x < m1; x += kThreads) {
          const int64_t i = x / col.bytes;
          const int64_t sr = min(max((int64_t)bw + i - cw, (int64_t)0), (int64_t)a.W - 1);
          col.d[x] = col.s[sr * col.bytes + (x - i * col.bytes)];
        }
      }
    }
    const int64_t t0 = max(x0, gb);
    if (t0 < x1) copy_bytes(col.d + t0, col.c + t0, x1 - t0, tid, kThreads);
  }

  // ---- existing nodes: a warp a node, whole-field graft of the touched ones
  if (blockIdx.x >= a.grid - a.exist_blocks) {
    for (int e = (blockIdx.x - (a.grid - a.exist_blocks)) * kWarps + warp; e < a.E; e += a.exist_blocks * kWarps) {
      bool d = false;
      const float* su = (const float*)a.exist[0].s + (int64_t)e * a.R;
      const float* bu = (const float*)a.exist[0].b + (int64_t)e * a.R;
      for (int r = lane; r < a.R; r += 32) d = d || su[r] != bu[r];
      for (int f = 1; f < kExist; ++f) {
        const Col& col = a.exist[f];
        const uint8_t* s = col.s + e * col.bytes;
        const uint8_t* b = col.b + e * col.bytes;
        if ((col.bytes & 3) == 0 && (((uintptr_t)s | (uintptr_t)b) & 3) == 0) {
          const uint32_t* s4 = reinterpret_cast<const uint32_t*>(s);
          const uint32_t* b4 = reinterpret_cast<const uint32_t*>(b);
          for (int64_t x = lane; x < col.bytes / 4; x += 32) d = d || s4[x] != b4[x];
        } else {
          for (int64_t x = lane; x < col.bytes; x += 32) d = d || s[x] != b[x];
        }
      }
      const bool t = __any_sync(0xffffffffu, d);
      for (int f = 0; f < kExist; ++f) {
        const Col& col = a.exist[f];
        copy_bytes(col.d + e * col.bytes, (t ? col.s : col.c) + e * col.bytes, col.bytes, lane, 32);
      }
    }
  }

  // ---- open, slot_of and the shifted map; counts and debits, elementwise
  const int64_t gid = (int64_t)blockIdx.x * kThreads + tid, stride = (int64_t)a.grid * kThreads;
  for (int64_t i = gid; i < a.W; i += stride) {
    const bool grab = i >= g0 && i < g1;
    a.shifted[i] = shift_slot(a.s_slot[i], bn, a.NB, delta);
    if (grab) {
      const int64_t sr = min(max((int64_t)bw + i - cw, (int64_t)0), (int64_t)a.W - 1);
      a.d_slot[i] = shift_slot(a.s_slot[sr], bn, a.NB, delta);
    } else {
      a.d_slot[i] = a.c_slot[i];
    }
    a.d_open[i] = a.c_open[i] || grab;
  }
  const int32_t sn = *a.s_n_open;
  for (int64_t x = gid; x < (int64_t)a.NGh * a.S; x += stride) {
    const int g = (int)(x / a.S), col = (int)(x % a.S);
    const int64_t j = (int64_t)col - delta;
    int32_t v = a.c_hg[x];
    if (j >= a.E + bn && j < a.E + sn) {
      const int64_t y = (int64_t)g * a.S + j;
      v += a.s_hg[y] - a.b_hg[y];
    }
    if (col < a.E) v += a.s_hg[x] - a.b_hg[x];
    a.d_hg[x] = v;
  }
  if (a.kscan) {
    for (int64_t x = gid; x < (int64_t)a.NGv * a.V; x += stride) a.d_vg[x] = a.c_vg[x] + (a.s_vg[x] - a.b_vg[x]);
    for (int64_t x = gid; x < (int64_t)a.G * a.R; x += stride) {
      const float b = a.b_budget[x];
      a.d_budget[x] = __fadd_rn(a.c_budget[x], isfinite(b) ? __fsub_rn(a.s_budget[x], b) : 0.0f);
    }
    for (int64_t x = gid; x < a.G; x += stride) {
      const float b = a.b_nodes[x];
      a.d_nodes[x] = __fadd_rn(a.c_nodes[x], isfinite(b) ? __fsub_rn(a.s_nodes[x], b) : 0.0f);
    }
    for (int64_t x = gid; x < a.RID; x += stride) a.d_res[x] = a.c_res[x] + (a.s_res[x] - a.b_res[x]);
    for (int64_t x = gid; x < a.NA; x += stride) {
      const int32_t v = a.assign_in[x];
      a.assign_out[x] = v >= a.E + bn ? v + delta : v;
    }
  }
  if (blockIdx.x == 0 && tid == 0) {
    const int32_t w = cw + k;
    *a.d_n_open = *a.c_n_open + (sn - bn);
    *a.d_w_open = w;
    *a.d_w_hw = max(*a.c_w_hw, w);
  }
}

}  // namespace

// ptrs, in ops/cuda.py _merge_sources' order, then the outputs: the n_win
// window columns (committed, row); the 9 existing-node fields (committed,
// row, base); committed open; slot_of (committed, row); the mode's counts
// and debits (committed, row, base): hg, and in kscan mode vg, budget,
// nodes_budget, res_cap; (kscan) the assignment; the scalars committed
// n_open, w_open, w_hw, row n_open, w_open, base n_open, w_open. Then the
// outputs: the window columns, the existing-node fields, open, slot_of,
// the shifted map, the mode's counts and debits, (kscan) the assignment,
// n_open, w_open, w_hw. dims: n_win, W, NB, E, R, NGh, S, NGv, V, G, RID,
// NA, kscan, then n_win window row bytes and 9 existing-node bytes per
// node.
extern "C" int merge_shard(const int64_t* ptrs, int n_ptrs, const int64_t* dims, void* stream) {
  Args a;
  memset(&a, 0, sizeof(a));
  int* f[] = {&a.n_win, &a.W, &a.NB, &a.E, &a.R, &a.NGh, &a.S, &a.NGv, &a.V, &a.G, &a.RID, &a.NA, &a.kscan};
  for (int i = 0; i < 13; ++i) *f[i] = (int)dims[i];
  const int nq = a.kscan ? 5 : 1, ka = a.kscan ? 1 : 0;
  if (a.n_win < 1 || a.n_win > kWin || a.W < 0 || a.E < 0 ||
      n_ptrs != 2 * a.n_win + 3 * kExist + 3 + 3 * nq + ka + 7 + a.n_win + kExist + 3 + nq + ka + 3)
    return (int)cudaErrorInvalidValue;
  int p = 0;
  for (int c = 0; c < a.n_win; ++c) {
    a.win[c].c = (const uint8_t*)ptrs[p++];
    a.win[c].s = (const uint8_t*)ptrs[p++];
    a.win[c].bytes = dims[13 + c];
    a.win[c].first = a.chunks;
    a.chunks += ((int64_t)a.W * a.win[c].bytes + kChunk - 1) / kChunk;
  }
  for (int c = 0; c < kExist; ++c) {
    a.exist[c].c = (const uint8_t*)ptrs[p++];
    a.exist[c].s = (const uint8_t*)ptrs[p++];
    a.exist[c].b = (const uint8_t*)ptrs[p++];
    a.exist[c].bytes = dims[13 + a.n_win + c];
  }
  if (a.exist[0].bytes != 4 * (int64_t)a.R) return (int)cudaErrorInvalidValue;
  a.c_open = (const uint8_t*)ptrs[p++];
  a.c_slot = (const int32_t*)ptrs[p++];
  a.s_slot = (const int32_t*)ptrs[p++];
  const int32_t** c4[] = {&a.c_hg, &a.c_vg, (const int32_t**)&a.c_budget, (const int32_t**)&a.c_nodes, &a.c_res};
  const int32_t** s4[] = {&a.s_hg, &a.s_vg, (const int32_t**)&a.s_budget, (const int32_t**)&a.s_nodes, &a.s_res};
  const int32_t** b4[] = {&a.b_hg, &a.b_vg, (const int32_t**)&a.b_budget, (const int32_t**)&a.b_nodes, &a.b_res};
  int32_t** d4[] = {&a.d_hg, &a.d_vg, (int32_t**)&a.d_budget, (int32_t**)&a.d_nodes, &a.d_res};
  for (int c = 0; c < nq; ++c) {
    *c4[c] = (const int32_t*)ptrs[p++];
    *s4[c] = (const int32_t*)ptrs[p++];
    *b4[c] = (const int32_t*)ptrs[p++];
  }
  if (ka) a.assign_in = (const int32_t*)ptrs[p++];
  const int32_t** sc[] = {&a.c_n_open, &a.c_w_open, &a.c_w_hw, &a.s_n_open, &a.s_w_open, &a.b_n_open, &a.b_w_open};
  for (int c = 0; c < 7; ++c) *sc[c] = (const int32_t*)ptrs[p++];
  for (int c = 0; c < a.n_win; ++c) a.win[c].d = (uint8_t*)ptrs[p++];
  for (int c = 0; c < kExist; ++c) a.exist[c].d = (uint8_t*)ptrs[p++];
  a.d_open = (uint8_t*)ptrs[p++];
  a.d_slot = (int32_t*)ptrs[p++];
  a.shifted = (int32_t*)ptrs[p++];
  for (int c = 0; c < nq; ++c) *d4[c] = (int32_t*)ptrs[p++];
  if (ka) a.assign_out = (int32_t*)ptrs[p++];
  a.d_n_open = (int32_t*)ptrs[p++];
  a.d_w_open = (int32_t*)ptrs[p++];
  a.d_w_hw = (int32_t*)ptrs[p++];
  // blocks: the window's chunks, then the existing nodes' (a warp a node);
  // the elementwise loops stride over all of them
  a.exist_blocks = (a.E + kWarps - 1) / kWarps;
  int64_t work = a.chunks + a.exist_blocks;
  const int64_t hg = (int64_t)a.NGh * a.S;
  const int64_t elems = hg > a.W ? hg : (int64_t)a.W;
  if ((elems + kThreads - 1) / kThreads > work) work = (elems + kThreads - 1) / kThreads;
  a.grid = (int)(work < 1 ? 1 : work > kMaxGrid ? kMaxGrid : work);
  if (a.exist_blocks > a.grid) a.exist_blocks = a.grid;
  merge_shard_kernel<<<a.grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* merge_shard_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }
