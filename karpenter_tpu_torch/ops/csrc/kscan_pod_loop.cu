// H6 kscan_pod_loop — replaces the pod loop of the JAX package's
// ops/solver.py `_make_kind_step` (solver.py:3093-3223: pod_step under
// lax.while_loop), with `_vg_eval` (:2882), ops/topology.py `hg_evaluate`
// (:511) and `hg_commit` (:531) inlined.
//
// One launch per kind-scan segment, one thread block: the pods of a
// segment place one after another (each pod's choice moves the counts the
// next one reads), so the block loops over the segment's `count` pods.
// Per pod:
//   1. threads j < NGv recompute the per-group spread / affinity terms
//      from the counts cnt [NGv, D] (shared memory): min count over the
//      pod's supported domains (0 under minDomains), skew-valid domains,
//      affinity options, the bootstrap flag, zero-count domains;
//   2. threads stride over the E + W + G candidate rows (existing nodes,
//      window claims, templates), evaluate the vocab-key groups on the
//      row's domain set (a D-bit mask) and the hostname groups at the
//      row's slot, and keep three running minimums: tier 1 the earliest
//      feasible node, tier 2 the feasible claim with the least
//      (pods + placed) * W + row, tier 3 the first feasible template in
//      the try order (weight order, or the rank's: t_order lists the
//      templates by rank, ties to the lowest index, and the key is a
//      template's position in it; 0 when none is feasible);
//   3. block reductions give the three picks; thread 0 commits the winner
//      (assignment, narrowed domain set, capacity row, counters, vg and
//      hg counts) and the block syncs before the next pod.
// Ties go to the lowest index everywhere (the spread pick keys on
// eff * 2^16 + rank, the bootstrap on rank); all integers are int32.
//
// State: cnt and the scalars live in shared memory for the launch; the
// [W, D] / [E, D] domain sets, capacity rows, per-row counters and the
// hostname counts [NGh, S] live in device memory (read by every thread,
// written by thread 0 before a __syncthreads, which makes them visible
// to the block).
//
// Bound on an H100: a latency chain, not bytes or operations — each pod
// is one pass over the candidate rows (a few KB of domain masks and
// counters, all L2-resident) followed by three dependent block
// reductions and a single-thread commit; the pods of a segment cannot
// overlap. Rows past the window's open claims are never feasible, so the
// pass skips them after one load.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxD = 16;   // KSCAN_D
constexpr int kMaxG = 32;   // vocab-key / hostname groups per family
constexpr int32_t kBig = 0x7fffffff;
constexpr int32_t kRankBase = 1 << 16;
constexpr int32_t kNoRoom = -2;
constexpr int32_t kNoClaim = -1;
constexpr int kSpread = 0, kAffinity = 1, kAnti = 2;

struct Loop {
  // segment invariants
  const int32_t* cap_e;       // [E]
  const uint8_t* zie0;        // [E]
  const uint8_t* open0;       // [W]
  const uint8_t* static_n0;   // [W]
  const int32_t* pods0;       // [W]
  const uint8_t* zin0;        // [W]
  const uint8_t* static_g;    // [G]
  const int32_t* capd_g;      // [G, D]
  const uint8_t* z0_g;        // [G, D]
  const uint8_t* zinf_g;      // [G]
  const int32_t* w_open0;     // []
  const uint8_t* self_conf;   // []
  const uint8_t* key_touched; // []
  const uint8_t* gate;        // [NGv]
  const uint8_t* recs;        // [NGv]
  const uint8_t* vg_self;     // [NGv]
  const uint8_t* pd;          // [D]
  const uint8_t* hg_applies;  // [NGh]
  const uint8_t* hg_records;  // [NGh]
  const uint8_t* hg_self;     // [NGh]
  const int32_t* vg_type;     // [NGv]
  const int32_t* vg_skew;     // [NGv]
  const int32_t* vg_mind;     // [NGv]
  const uint8_t* vg_domains;  // [NGv, V]
  const int32_t* vg_rank;     // [NGv, V]
  const int32_t* hg_type;     // [NGh]
  const int32_t* hg_skew;     // [NGh]
  const uint8_t* hg_valid;    // [NGh]
  const uint8_t* hg_extra;    // [NGh]
  // carry, updated in place
  uint8_t* zn;                // [W, D]
  uint8_t* ze;                // [E, D]
  int32_t* capd;              // [W, D]
  int32_t* pl_n;              // [W]
  int32_t* pl_e;              // [E]
  int32_t* tmpl_n;            // [W]
  int32_t* cnt;               // [NGv, D]
  int32_t* hgc;               // [NGh, S]
  int32_t* n_open;            // []
  int32_t* w_open;            // []
  int32_t* slot_of;           // [W]
  int32_t* spills;            // []
  int32_t* assignment;        // [maxc]
  const int32_t* t_order;     // [G] templates in rank order; null = index order
  int E, W, G, D, NGv, NGh, S, V, NCAP, count;
};

struct Shared {
  // per-group constants
  uint32_t dom[kMaxG];        // domain bits of each vg group
  int32_t rank[kMaxG][kMaxD];
  int32_t vtype[kMaxG];
  int32_t vgate[kMaxG];
  int32_t vrec[kMaxG];
  int32_t vself[kMaxG];
  int32_t htype[kMaxG];
  int32_t hskew[kMaxG];
  int32_t hgate[kMaxG];
  int32_t hrec[kMaxG];
  int32_t hself[kMaxG];
  int32_t hnonempty[kMaxG];   // any count > 0 in the slot space, or outside it
  uint32_t pd;
  // per-pod terms of each vg group
  int32_t cnt[kMaxG][kMaxD];
  int32_t eff[kMaxG][kMaxD];
  uint32_t okskew[kMaxG];
  uint32_t opts[kMaxG];
  uint32_t zero[kMaxG];
  int32_t boot[kMaxG];
  // scalars
  int32_t n_open, w_open, spills, w_open0, self_conf, key_touched;
  // reductions
  int32_t red[3][32];
};

__device__ __forceinline__ uint32_t load_bits(const uint8_t* row, int D) {
  uint32_t b = 0;
  for (int d = 0; d < D; ++d)
    if (row[d]) b |= 1u << d;
  return b;
}

__device__ __forceinline__ void store_bits(uint8_t* row, uint32_t b, int D) {
  for (int d = 0; d < D; ++d) row[d] = (b >> d) & 1u;
}

// first set bit's index among `space` minimizing key[d] (ties: lowest d);
// returns the one-hot mask, 0 when space is empty
__device__ __forceinline__ uint32_t argmin_onehot(uint32_t space, const int32_t* key, int D) {
  int best = -1;
  int32_t bk = kBig;
  for (int d = 0; d < D; ++d) {
    if (!((space >> d) & 1u)) continue;
    if (best < 0 || key[d] < bk) {
      bk = key[d];
      best = d;
    }
  }
  return best < 0 ? 0u : (1u << best);
}

// the vocab-key groups on one candidate's domain set zs: feasibility and
// the narrowed set (zs & the AND of every gated group's choice)
__device__ bool vg_eval(const Shared& sh, const Loop& p, uint32_t zs, uint32_t* newz) {
  uint32_t upd = 0xffffffffu;
  bool feasible = true;
  for (int j = 0; j < p.NGv; ++j) {
    if (!sh.vgate[j]) continue;
    uint32_t narrowed;
    if (sh.vtype[j] == kSpread) {
      const uint32_t valid = sh.dom[j] & zs & sh.okskew[j];
      int32_t key[kMaxD];
      // (count + self) * 2^16 + rank in uint32, wrapping past a count of
      // 2^15 - 1 as the reference's int32 arithmetic does
      for (int d = 0; d < p.D; ++d)
        key[d] = (int32_t)((uint32_t)sh.eff[j][d] * (uint32_t)kRankBase + (uint32_t)sh.rank[j][d]);
      narrowed = argmin_onehot(valid, key, p.D);
    } else {
      const uint32_t boot_space = sh.dom[j] & sh.pd & zs;
      if (sh.vtype[j] == kAffinity) {
        const uint32_t opts_c = sh.opts[j] & zs;
        narrowed = opts_c ? opts_c
                          : (sh.boot[j] ? argmin_onehot(boot_space, sh.rank[j], p.D) : 0u);
      } else {
        narrowed = boot_space & sh.zero[j];
      }
    }
    feasible = feasible && narrowed != 0u;
    upd &= narrowed;
  }
  *newz = zs & upd;
  return feasible;
}

__device__ bool hg_ok(const Shared& sh, const Loop& p, int slot) {
  for (int h = 0; h < p.NGh; ++h) {
    if (!sh.hgate[h]) continue;
    const int32_t c = p.hgc[(int64_t)h * p.S + slot];
    bool ok;
    if (sh.htype[h] == kSpread) {
      ok = c + sh.hself[h] <= sh.hskew[h];
    } else if (sh.htype[h] == kAffinity) {
      ok = c > 0 || (sh.hself[h] && !sh.hnonempty[h]);
    } else {
      ok = c == 0;
    }
    if (!ok) return false;
  }
  return true;
}

// block-wide minimum of three values, left in sh.red[k][0]
__device__ __forceinline__ void block_min3(Shared& sh, int32_t v0, int32_t v1, int32_t v2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    v0 = min(v0, __shfl_down_sync(0xffffffffu, v0, off));
    v1 = min(v1, __shfl_down_sync(0xffffffffu, v1, off));
    v2 = min(v2, __shfl_down_sync(0xffffffffu, v2, off));
  }
  if (lane == 0) {
    sh.red[0][warp] = v0;
    sh.red[1][warp] = v1;
    sh.red[2][warp] = v2;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int32_t a = lane < nw ? sh.red[0][lane] : kBig;
    int32_t b = lane < nw ? sh.red[1][lane] : kBig;
    int32_t c = lane < nw ? sh.red[2][lane] : kBig;
    for (int off = 16; off > 0; off >>= 1) {
      a = min(a, __shfl_down_sync(0xffffffffu, a, off));
      b = min(b, __shfl_down_sync(0xffffffffu, b, off));
      c = min(c, __shfl_down_sync(0xffffffffu, c, off));
    }
    if (lane == 0) {
      sh.red[0][0] = a;
      sh.red[1][0] = b;
      sh.red[2][0] = c;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) pod_loop_kernel(Loop p) {
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int D = p.D;
  // ---- segment constants ----------------------------------------------
  if (tid < p.NGv) {
    const int j = tid;
    sh.dom[j] = load_bits(p.vg_domains + (int64_t)j * p.V, D);
    for (int d = 0; d < D; ++d) {
      sh.rank[j][d] = p.vg_rank[(int64_t)j * p.V + d];
      sh.cnt[j][d] = p.cnt[j * D + d];
    }
    sh.vtype[j] = p.vg_type[j];
    sh.vgate[j] = p.gate[j];
    sh.vrec[j] = p.recs[j];
    sh.vself[j] = p.vg_self[j];
  }
  if (tid < p.NGh) {
    const int h = tid;
    sh.htype[h] = p.hg_type[h];
    sh.hskew[h] = p.hg_skew[h];
    sh.hgate[h] = p.hg_applies[h] && p.hg_valid[h];
    sh.hrec[h] = p.hg_records[h] && p.hg_valid[h];
    sh.hself[h] = p.hg_self[h];
    sh.hnonempty[h] = p.hg_extra[h];
  }
  if (tid == 0) {
    sh.pd = load_bits(p.pd, D);
    sh.n_open = *p.n_open;
    sh.w_open = *p.w_open;
    sh.spills = *p.spills;
    sh.w_open0 = *p.w_open0;
    sh.self_conf = *p.self_conf;
    sh.key_touched = *p.key_touched;
  }
  __syncthreads();
  // hostname groups with counts anywhere (group_empty = ~(this | extra))
  for (int h = 0; h < p.NGh; ++h) {
    int any = 0;
    for (int s = tid; s < p.S; s += blockDim.x) any |= p.hgc[(int64_t)h * p.S + s] > 0;
    any = __syncthreads_or(any);
    if (tid == 0 && any) sh.hnonempty[h] = 1;
  }
  __syncthreads();

  const int E = p.E, W = p.W, G = p.G;
  for (int i = 0; i < p.count; ++i) {
    // ---- 1. per-pod group terms --------------------------------------
    if (tid < p.NGv) {
      const int j = tid;
      const uint32_t in_universe = sh.dom[j] & sh.pd;
      int32_t minc = kBig;
      int supported = 0;
      uint32_t pos = 0, zero = 0;
      for (int d = 0; d < D; ++d) {
        const int32_t c = sh.cnt[j][d];
        if ((in_universe >> d) & 1u) {
          ++supported;
          minc = min(minc, c);
        }
        if (c > 0) pos |= 1u << d;
        if (c == 0) zero |= 1u << d;
      }
      const int32_t mind = p.vg_mind[j];
      if (mind > 0 && supported < mind) minc = 0;
      if (minc == kBig) minc = 0;
      uint32_t okskew = 0;
      for (int d = 0; d < D; ++d) {
        const int32_t e = sh.cnt[j][d] + sh.vself[j];
        sh.eff[j][d] = e;
        if (e - minc <= p.vg_skew[j]) okskew |= 1u << d;
      }
      sh.okskew[j] = okskew;
      sh.opts[j] = sh.dom[j] & sh.pd & pos;
      sh.zero[j] = zero;
      const bool group_empty = pos == 0;
      const bool no_compat = (sh.pd & pos) == 0;
      sh.boot[j] = sh.vself[j] && (group_empty || no_compat);
    }
    __syncthreads();
    const int32_t n_open = sh.n_open, w_open = sh.w_open;

    // ---- 2. one pass over the candidate rows --------------------------
    int32_t best_e = kBig, best_n = kBig, best_g = kBig;
    for (int c = tid; c < E + W + G; c += blockDim.x) {
      uint32_t zs, newz;
      int slot;
      if (c < E) {
        if (p.pl_e[c] >= p.cap_e[c]) continue;
        zs = load_bits(p.ze + (int64_t)c * D, D);
        slot = c;
        if (!vg_eval(sh, p, zs, &newz) || !hg_ok(sh, p, slot)) continue;
        best_e = min(best_e, c);
      } else if (c < E + W) {
        const int r = c - E;
        const bool fresh = r >= sh.w_open0 && r < w_open;
        if (!((p.open0[r] || fresh) && (p.static_n0[r] || fresh))) continue;
        zs = load_bits(p.zn + (int64_t)r * D, D);
        if (!vg_eval(sh, p, zs, &newz)) continue;
        const int32_t placed = p.pl_n[r];
        bool fits = false;
        for (int d = 0; d < D && !fits; ++d) {
          if (!((newz >> d) & 1u)) continue;
          int32_t lim = p.capd[(int64_t)r * D + d];
          if (sh.self_conf) lim = min(lim, 1);
          fits = lim > placed;
        }
        if (!fits || !hg_ok(sh, p, E + p.slot_of[r])) continue;
        best_n = min(best_n, (p.pods0[r] + placed) * W + r);
      } else {
        const int pos = c - E - W;  // the tier-3 key: position in the try order
        const int g = p.t_order ? p.t_order[pos] : pos;
        if (!p.static_g[g]) continue;
        zs = load_bits(p.z0_g + (int64_t)g * D, D);
        if (!vg_eval(sh, p, zs, &newz)) continue;
        bool fits = false;
        for (int d = 0; d < D && !fits; ++d)
          fits = ((newz >> d) & 1u) && p.capd_g[(int64_t)g * D + d] >= 1;
        if (!fits || !hg_ok(sh, p, E + n_open)) continue;
        best_g = min(best_g, pos);
      }
    }
    block_min3(sh, best_e, best_n, best_g);

    // ---- 3. commit ------------------------------------------------------
    if (tid == 0) {
      const bool found_e = sh.red[0][0] < kBig;
      const int pick_e = found_e ? sh.red[0][0] : 0;
      const bool found = !found_e && sh.red[1][0] < kBig;
      const int pick = found ? sh.red[1][0] % W : 0;
      const bool any_tf = sh.red[2][0] < kBig;
      const int g = any_tf ? (p.t_order ? p.t_order[sh.red[2][0]] : sh.red[2][0]) : 0;
      const bool any_t = any_tf && !found_e && !found;
      const bool can_open = any_t && w_open < W && n_open < p.NCAP;
      const bool spilled = any_t && !can_open && n_open < p.NCAP;
      const bool place = found_e || found || can_open;
      const int cslot = found ? pick : w_open;
      const int gslot = found ? p.slot_of[pick] : n_open;
      const int slot = found_e ? pick_e : E + gslot;
      p.assignment[i] = place ? slot : (any_t ? kNoRoom : kNoClaim);
      if (place) {
        uint32_t zs, win_z;
        bool zinf_old;
        if (found_e) {
          zs = load_bits(p.ze + (int64_t)pick_e * D, D);
          zinf_old = p.zie0[pick_e];
        } else if (found) {
          zs = load_bits(p.zn + (int64_t)pick * D, D);
          zinf_old = p.zin0[pick];
        } else {
          zs = load_bits(p.z0_g + (int64_t)g * D, D);
          zinf_old = p.zinf_g[g];
        }
        vg_eval(sh, p, zs, &win_z);
        const bool win_zinf = zinf_old && !sh.key_touched;
        const bool single = __popc(win_z) == 1;
        for (int j = 0; j < p.NGv; ++j) {
          if (sh.vrec[j] && !win_zinf && (sh.vtype[j] == kAnti || single))
            for (int d = 0; d < D; ++d)
              if ((win_z >> d) & 1u) sh.cnt[j][d] += 1;
        }
        for (int h = 0; h < p.NGh; ++h) {
          if (!sh.hrec[h]) continue;
          p.hgc[(int64_t)h * p.S + slot] += 1;
          sh.hnonempty[h] = 1;
        }
        if (found_e) {
          store_bits(p.ze + (int64_t)pick_e * D, win_z, D);
          p.pl_e[pick_e] += 1;
        } else {
          store_bits(p.zn + (int64_t)cslot * D, win_z, D);
          p.pl_n[cslot] += 1;
          if (!found) {  // opened a fresh claim
            for (int d = 0; d < D; ++d)
              p.capd[(int64_t)cslot * D + d] = p.capd_g[(int64_t)g * D + d];
            p.tmpl_n[cslot] = g;
            p.slot_of[cslot] = n_open;
            sh.n_open = n_open + 1;
            sh.w_open = w_open + 1;
          }
        }
      }
      if (spilled) sh.spills += 1;
    }
    __syncthreads();
  }
  // ---- write back the shared carry --------------------------------------
  if (tid < p.NGv)
    for (int d = 0; d < D; ++d) p.cnt[tid * D + d] = sh.cnt[tid][d];
  if (tid == 0) {
    *p.n_open = sh.n_open;
    *p.w_open = sh.w_open;
    *p.spills = sh.spills;
  }
}

}  // namespace

// ptrs: a host array of the 43 device pointers in Loop's field order
// (t_order null for weight order);
// dims: E, W, G, D, NGv, NGh, S, V, NCAP, count.
extern "C" int kscan_pod_loop(const int64_t* ptrs, int n_ptrs, const int64_t* dims,
                              void* stream) {
  constexpr int kPtrs = 43;
  static_assert(offsetof(Loop, E) == kPtrs * sizeof(void*), "Loop: pointers first");
  if (n_ptrs != kPtrs) return (int)cudaErrorInvalidValue;
  Loop p;
  memcpy(&p, ptrs, kPtrs * sizeof(void*));
  p.E = (int)dims[0];
  p.W = (int)dims[1];
  p.G = (int)dims[2];
  p.D = (int)dims[3];
  p.NGv = (int)dims[4];
  p.NGh = (int)dims[5];
  p.S = (int)dims[6];
  p.V = (int)dims[7];
  p.NCAP = (int)dims[8];
  p.count = (int)dims[9];
  if (p.D < 1 || p.D > kMaxD || p.NGv > kMaxG || p.NGh > kMaxG)
    return (int)cudaErrorInvalidValue;
  if (p.count <= 0) return 0;
  pod_loop_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* kscan_pod_loop_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
