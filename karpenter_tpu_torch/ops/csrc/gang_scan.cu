// H9 gang_scan — replaces the scan body of the JAX package's
// ops/solver.py `solve_gang` + `_make_gang_step` (solver.py:2657 / 2361),
// with `_claim_fill_caps` (:1355), `_fits_off_counted` (:1333),
// `_cap_res_grid` (:2751), `_kscan_admit` (:2787), `_vg_eval` (:2882) and
// ops/topology.py `hg_evaluate` (:511) inlined.
//
// One launch per gang run, one thread block: the run's B segments (one
// gang each, in rank order) are sequential through n_open, the pool
// budgets, the vocab-key and hostname counts, so the block walks them in
// order. The state-free terms (template ∩ pod, the type compatibility
// through H1, the template gates, the offering rows) arrive precomputed
// for all B segments (ops/solver.py gang_precompute). Per segment:
//   1. the slice template: templates in order (or by rank), each feasible
//      when it passes its gates and some type survives — it_compat, the
//      offering-gated fit of one pod over the daemon usage, and
//      cap <= budget on every resource (a block-wide OR per template);
//   2. the slice shape: f = the largest +/-1-verified cell count over the
//      chosen template's viable (type, group) cells with an offering
//      (count_cell.cuh, a block max), then want = ceil(count / f) hosts,
//      the claims-axis and nodes-budget gates; under a key the [T, D]
//      per-domain caps are kept in a scratch for the blocks;
//   3. the rank blocks j < want: thread 0 evaluates the hostname groups at
//      the fresh slot E + n_open + j and, under a key, the group rules on
//      the template's domain set against the block-local counts (counts
//      fixed within a block); the threads filter the types at the block's
//      pod count c_j (a block-wide OR); a block that fails spills the
//      whole gang; a block that passes debits max cap over its remaining
//      types (one f32 sum per resource, in block order) and records its
//      counts;
//   4. all or nothing: a placed gang writes bank rows n_open + j (frozen,
//      template, its, used = daemon + c_j * req rounded once by
//      __fmaf_rn as XLA fuses it, the key's row), then budget[g] -= the
//      summed debit once, nodes_budget[g] -= want, the counts, n_open; the
//      segment's six GangYs scalars are written whatever happened.
// Ties go to the lowest index; all integers are int32, the spread rank
// key (count + self) * 2^16 + rank is formed in uint32 and wraps as the
// reference's int32 does.
//
// State: the chosen template's viable types, the per-segment group terms,
// the tentative counts, the block domain sets and the debit live in
// shared memory (sized from the dims at launch); the blocks' type rows and
// the [T, D] caps in a device scratch; the carry in device memory (read
// by every thread, written before a __syncthreads, which makes it visible
// to the block).
//
// Bound on an H100: a latency chain, not bytes or operations — each
// segment is a few passes over the T x GR cells (a few hundred KB of
// L2-resident tables) separated by block barriers, and the segments and
// the blocks of a segment cannot overlap. One block on one SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "count_cell.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 16;  // KSCAN_D
constexpr int32_t kBig = 0x7fffffff;
constexpr uint32_t kRankBase = 1u << 16;
constexpr int32_t kNoClaim = -1, kNoRoom = -2, kGangSpill = -3;
constexpr int kSpread = 0, kAffinity = 1, kAnti = 2;
constexpr size_t kSmemMax = 232448;  // a block's shared memory on an H100

struct Gang {
  // per segment (B rows), state-free
  const uint8_t* its_base;     // [B, G, T]
  const uint8_t* tmpl_base;    // [B, G]
  const uint8_t* zmask;        // [B, G, Z]
  const uint8_t* cmask;        // [B, G, C]
  const float* requests;       // [B, R]
  const int32_t* count;        // [B]
  const uint8_t* self_conf;    // [B]
  const uint8_t* zinf;         // [B, G]
  const uint8_t* zdef;         // [B, G]
  const uint8_t* kmask;        // [B, G, V] the key's row (its first D values: the domains)
  const uint8_t* pd;           // [B, D]
  const uint8_t* key_touched;  // [B]
  const uint8_t* gate;         // [B, NGv]
  const uint8_t* recs;         // [B, NGv]
  const uint8_t* vg_self;      // [B, NGv]
  const uint8_t* hg_applies;   // [B, NGh]
  const uint8_t* hg_rec;       // [B, NGh]
  const uint8_t* hg_self;      // [B, NGh]
  // tables
  const float* alloc;          // [T, GR, R]
  const uint8_t* group_valid;  // [T, GR]
  const uint8_t* zc_avail;     // [T, GR, Z, C]
  const float* cap;            // [T, R]
  const uint8_t* admit;        // [T, D]
  const float* daemon;         // [G, R]
  const int32_t* rank;         // [G], or null: lexical order
  const int32_t* vg_type;      // [NGv]
  const int32_t* vg_skew;      // [NGv]
  const int32_t* vg_mind;      // [NGv]
  const uint8_t* vg_domains;   // [NGv, V]
  const int32_t* vg_rank;      // [NGv, V]
  const int32_t* hg_type;      // [NGh]
  const int32_t* hg_skew;      // [NGh]
  const uint8_t* hg_valid;     // [NGh]
  const uint8_t* hg_extra;     // [NGh]
  // carry, updated in place
  int32_t* n_open;             // []
  float* budget;               // [G, R]
  float* nodes_budget;         // [G]
  int32_t* vg_counts;          // [NGv, V]
  int32_t* hg_counts;          // [NGh, S]
  uint8_t* bank_frozen;        // [NCAP]
  int32_t* bank_template;      // [NCAP]
  uint8_t* bank_its;           // [NCAP, T]
  float* bank_used;            // [NCAP, R]
  uint8_t* bank_tk_mask;       // [NCAP, TK, V]
  uint8_t* bank_tk_inf;        // [NCAP, TK]
  uint8_t* bank_tk_def;        // [NCAP, TK]
  // outputs and scratch
  int32_t* ys;                 // [6, B]: open_g, n_opened, fill, tmpl, leftover, status
  uint8_t* its_b;              // [maxg, T] the blocks' type rows
  int32_t* capTd;              // [T, D] per-domain caps (key runs)
  int B, G, T, GR, R, Z, C, V, D, NGv, NGh, S, E, NCAP, maxg, TK, tk_idx, has_key, key_is_zone;
};

// the shared-memory workspace, each field rounded up to 16 bytes
struct Work {
  uint8_t* its0;    // [T] the chosen template's viable types
  float* rq;        // [R] the segment's request
  float* dg;        // [R] the chosen template's daemon usage
  float* debit;     // [R]
  int32_t* cnt;     // [NGv, D] tentative vocab-key counts
  int32_t* vrank;   // [NGv, D]
  uint32_t* vdom;   // [NGv] domain bits
  int32_t* vi;      // [6, NGv] type, skew, minDomains, gate, records, self
  int32_t* hi;      // [6, NGh] type, skew, gate, records, self, nonempty
  uint32_t* zb;     // [maxg] the blocks' narrowed domain sets
  int32_t* red;     // [kThreads] reductions
};

__host__ __device__ inline char* take(char* base, size_t* off, size_t bytes) {
  char* r = base ? base + *off : nullptr;
  *off += (bytes + 15) & ~(size_t)15;
  return r;
}

__host__ __device__ inline size_t carve(const Gang& p, char* base, Work* w) {
  size_t off = 0;
  w->its0 = (uint8_t*)take(base, &off, (size_t)p.T);
  w->rq = (float*)take(base, &off, 4 * (size_t)p.R);
  w->dg = (float*)take(base, &off, 4 * (size_t)p.R);
  w->debit = (float*)take(base, &off, 4 * (size_t)p.R);
  w->cnt = (int32_t*)take(base, &off, 4 * (size_t)p.NGv * p.D);
  w->vrank = (int32_t*)take(base, &off, 4 * (size_t)p.NGv * p.D);
  w->vdom = (uint32_t*)take(base, &off, 4 * (size_t)p.NGv);
  w->vi = (int32_t*)take(base, &off, 4 * 6 * (size_t)p.NGv);
  w->hi = (int32_t*)take(base, &off, 4 * 6 * (size_t)p.NGh);
  w->zb = (uint32_t*)take(base, &off, 4 * (size_t)p.maxg);
  w->red = (int32_t*)take(base, &off, 4 * (size_t)kThreads);
  return off;
}

// an available offering of (t, gr) in a zone of zm and a capacity type of cm
__device__ __forceinline__ bool off_at(const Gang& p, const uint8_t* zm, const uint8_t* cm, int t, int gr) {
  const uint8_t* zc = p.zc_avail + ((int64_t)t * p.GR + gr) * p.Z * p.C;
  for (int z = 0; z < p.Z; ++z) {
    if (!zm[z]) continue;
    for (int c = 0; c < p.C; ++c)
      if (cm[c] && zc[z * p.C + c]) return true;
  }
  return false;
}

// its0[g, t]: the state-free gates, cap <= budget on every resource, and
// one pod over the daemon usage fitting an offered allocatable group
__device__ bool its0_at(const Gang& p, int b, int g, int t, const float* rq) {
  const int64_t bg = (int64_t)b * p.G + g;
  if (!p.its_base[bg * p.T + t]) return false;
  const float* cap = p.cap + (int64_t)t * p.R;
  const float* bud = p.budget + (int64_t)g * p.R;
  for (int r = 0; r < p.R; ++r)
    if (!(cap[r] <= bud[r])) return false;
  const float* dg = p.daemon + (int64_t)g * p.R;
  const uint8_t* zm = p.zmask + bg * p.Z;
  const uint8_t* cm = p.cmask + bg * p.C;
  for (int gr = 0; gr < p.GR; ++gr) {
    if (!p.group_valid[(int64_t)t * p.GR + gr] || !off_at(p, zm, cm, t, gr)) continue;
    if (ktpu::fits_at(dg, rq, p.alloc + ((int64_t)t * p.GR + gr) * p.R, p.R, 1)) return true;
  }
  return false;
}

// first index among `space` minimizing key[d]; the one-hot mask, 0 when empty
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

// the vocab-key groups on the domain set zs against the tentative counts:
// feasibility and the narrowed set (the reference's _vg_eval, one row)
__device__ bool vg_eval(const Gang& p, const Work& w, uint32_t zs, uint32_t pd, uint32_t* newz) {
  const int D = p.D, NGv = p.NGv;
  uint32_t upd = 0xffffffffu;
  bool feasible = true;
  for (int j = 0; j < NGv; ++j) {
    if (!w.vi[3 * NGv + j]) continue;
    const int32_t* cnt = w.cnt + j * D;
    const int32_t self = w.vi[5 * NGv + j];
    const uint32_t dom = w.vdom[j];
    const uint32_t in_universe = dom & pd;
    int32_t minc = kBig;
    int supported = 0;
    uint32_t pos = 0, zero = 0;
    for (int d = 0; d < D; ++d) {
      if ((in_universe >> d) & 1u) {
        ++supported;
        minc = min(minc, cnt[d]);
      }
      if (cnt[d] > 0) pos |= 1u << d;
      if (cnt[d] == 0) zero |= 1u << d;
    }
    const int32_t mind = w.vi[2 * NGv + j];
    if (mind > 0 && supported < mind) minc = 0;
    if (minc == kBig) minc = 0;
    uint32_t narrowed;
    const int type = w.vi[j];
    if (type == kSpread) {
      uint32_t okskew = 0;
      int32_t key[kMaxD];
      for (int d = 0; d < D; ++d) {
        const int32_t e = cnt[d] + self;
        if (e - minc <= w.vi[NGv + j]) okskew |= 1u << d;
        key[d] = (int32_t)((uint32_t)e * kRankBase + (uint32_t)w.vrank[j * D + d]);
      }
      narrowed = argmin_onehot(dom & zs & okskew, key, D);
    } else if (type == kAffinity) {
      const uint32_t opts_c = dom & pd & pos & zs;
      const bool boot = self && (pos == 0 || (pd & pos) == 0);
      narrowed = opts_c ? opts_c : (boot ? argmin_onehot(dom & pd & zs, w.vrank + j * D, D) : 0u);
    } else {
      narrowed = dom & pd & zs & zero;
    }
    feasible = feasible && narrowed != 0u;
    upd &= narrowed;
  }
  *newz = zs & upd;
  return feasible;
}

// the hostname groups at one slot (the reference's hg_evaluate, one row)
__device__ bool hg_ok_at(const Gang& p, const Work& w, int slot) {
  const int NGh = p.NGh;
  for (int h = 0; h < NGh; ++h) {
    if (!w.hi[2 * NGh + h]) continue;
    const int32_t c = p.hg_counts[(int64_t)h * p.S + slot];
    const int type = w.hi[h];
    bool ok;
    if (type == kSpread) {
      ok = c + w.hi[4 * NGh + h] <= w.hi[NGh + h];
    } else if (type == kAffinity) {
      ok = c > 0 || (w.hi[4 * NGh + h] && !w.hi[5 * NGh + h]);
    } else {
      ok = c == 0;
    }
    if (!ok) return false;
  }
  return true;
}

// block-wide max of v, returned to every thread
__device__ int32_t block_max(const Work& w, int32_t v) {
  const int tid = threadIdx.x;
  w.red[tid] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) w.red[tid] = max(w.red[tid], w.red[tid + s]);
    __syncthreads();
  }
  const int32_t r = w.red[0];
  __syncthreads();
  return r;
}

struct Scal {
  int32_t n_open, count, g, f, want, try_place, shaped, budget_ok, key_touched, win_zinf, vg_ok, hg_ok;
  uint32_t z0, pd, zj;
};

__global__ void __launch_bounds__(kThreads) gang_scan_kernel(Gang p) {
  extern __shared__ __align__(16) char smem[];
  __shared__ Scal sc;
  Work w;
  carve(p, smem, &w);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int T = p.T, GR = p.GR, R = p.R, D = p.D, G = p.G, NGv = p.NGv, NGh = p.NGh;

  // ---- launch constants ---------------------------------------------------
  for (int j = tid; j < NGv; j += nt) {
    uint32_t dom = 0;
    for (int d = 0; d < D; ++d) {
      if (p.vg_domains[(int64_t)j * p.V + d]) dom |= 1u << d;
      w.vrank[j * D + d] = p.vg_rank[(int64_t)j * p.V + d];
    }
    w.vdom[j] = dom;
    w.vi[j] = p.vg_type[j];
    w.vi[NGv + j] = p.vg_skew[j];
    w.vi[2 * NGv + j] = p.vg_mind[j];
  }
  for (int h = tid; h < NGh; h += nt) {
    w.hi[h] = p.hg_type[h];
    w.hi[NGh + h] = p.hg_skew[h];
  }
  if (tid == 0) sc.n_open = *p.n_open;
  __syncthreads();

  for (int b = 0; b < p.B; ++b) {
    // ---- the segment's rows -----------------------------------------------
    for (int r = tid; r < R; r += nt) {
      w.rq[r] = p.requests[(int64_t)b * R + r];
      w.debit[r] = 0.0f;
    }
    for (int j = tid; j < NGv; j += nt) {
      w.vi[3 * NGv + j] = p.gate[(int64_t)b * NGv + j];
      w.vi[4 * NGv + j] = p.recs[(int64_t)b * NGv + j];
      w.vi[5 * NGv + j] = p.vg_self[(int64_t)b * NGv + j];
      for (int d = 0; d < D; ++d) w.cnt[j * D + d] = p.vg_counts[(int64_t)j * p.V + d];
    }
    for (int h = tid; h < NGh; h += nt) {
      w.hi[2 * NGh + h] = p.hg_applies[(int64_t)b * NGh + h] && p.hg_valid[h];
      w.hi[3 * NGh + h] = p.hg_rec[(int64_t)b * NGh + h];
      w.hi[4 * NGh + h] = p.hg_self[(int64_t)b * NGh + h];
      w.hi[5 * NGh + h] = p.hg_extra[h];
    }
    if (tid == 0) {
      sc.count = p.count[b];
      sc.key_touched = p.key_touched[b];
      uint32_t pd = 0;
      if (p.has_key)
        for (int d = 0; d < D; ++d)
          if (p.pd[(int64_t)b * D + d]) pd |= 1u << d;
      sc.pd = pd;
    }
    __syncthreads();
    // an affinity group the gang applies to reads whether its group holds
    // a count anywhere
    for (int h = 0; h < NGh; ++h) {
      if (!w.hi[2 * NGh + h] || w.hi[h] != kAffinity) continue;
      int any = 0;
      for (int x = tid; x < p.S; x += nt) any |= p.hg_counts[(int64_t)h * p.S + x] > 0;
      any = __syncthreads_or(any);
      if (tid == 0 && any) w.hi[5 * NGh + h] = 1;
    }
    const int32_t count = sc.count;
    // thread 0 moves n_open only at the segment's end
    const int32_t n_open = sc.n_open;

    // ---- 1. the slice template ----------------------------------------------
    int pick = -1;
    int32_t best_rank = kBig;
    for (int g = 0; g < G; ++g) {
      if (!p.tmpl_base[(int64_t)b * G + g] || !(p.nodes_budget[g] >= 1.0f)) continue;
      int any = 0;
      for (int t = tid; t < T && !any; t += nt) any = its0_at(p, b, g, t, w.rq);
      if (!__syncthreads_or(any)) continue;
      if (!p.rank) {
        pick = g;
        break;
      }
      if (p.rank[g] < best_rank) {
        best_rank = p.rank[g];
        pick = g;
      }
    }
    const int g = pick >= 0 ? pick : 0;
    const bool any_t = pick >= 0 && count > 0;
    const int64_t bg = (int64_t)b * G + g;

    // ---- 2. the slice shape on template g -----------------------------------
    for (int r = tid; r < R; r += nt) w.dg[r] = p.daemon[(int64_t)g * R + r];
    __syncthreads();
    const uint8_t* zm = p.zmask + bg * p.Z;
    const uint8_t* cm = p.cmask + bg * p.C;
    int32_t fbest = 0;
    for (int t = tid; t < T; t += nt) {
      const bool v = its0_at(p, b, g, t, w.rq);
      w.its0[t] = v;
      int32_t* capd = p.capTd + (int64_t)t * D;
      if (p.has_key)
        for (int d = 0; d < D; ++d) capd[d] = 0;
      for (int gr = 0; gr < GR; ++gr) {
        if (!p.group_valid[(int64_t)t * GR + gr]) continue;
        const int32_t c = ktpu::cell_count(w.dg, w.rq, p.alloc + ((int64_t)t * GR + gr) * R, R);
        const bool off = off_at(p, zm, cm, t, gr);
        if (v && off) fbest = max(fbest, c);
        if (!p.has_key) continue;
        const uint8_t* zc = p.zc_avail + ((int64_t)t * GR + gr) * p.Z * p.C;
        for (int d = 0; d < D; ++d) {
          bool offd = off;
          if (p.key_is_zone) {
            offd = false;
            for (int cc = 0; cc < p.C && !offd; ++cc) offd = cm[cc] && zc[d * p.C + cc];
          }
          if (offd) capd[d] = max(capd[d], c);
        }
      }
    }
    const int32_t f0 = block_max(w, fbest);
    if (tid == 0) {
      int32_t f = p.self_conf[b] ? min(f0, 1) : f0;
      f = any_t ? max(f, 0) : 0;
      const int32_t want = f > 0 ? (count + f - 1) / f : 0;
      const int32_t avail = max(p.NCAP - n_open, 0);
      sc.g = g;
      sc.f = f;
      sc.want = want;
      sc.budget_ok = p.nodes_budget[g] >= (float)want;
      sc.shaped = any_t && f > 0;
      sc.try_place = sc.shaped && want <= avail && sc.budget_ok;
      uint32_t z0 = 0;
      if (p.has_key)
        for (int d = 0; d < D; ++d)
          if (p.kmask[bg * p.V + d]) z0 |= 1u << d;
      sc.z0 = z0;
      sc.win_zinf = p.zinf[bg] && !sc.key_touched;
    }
    __syncthreads();
    const int32_t f = sc.f, want = sc.want;
    const bool try_place = sc.try_place;

    // ---- 3. the rank blocks -------------------------------------------------
    int j = 0;
    if (try_place) {
      for (; j < want; ++j) {
        const int32_t cj = min(max(count - j * f, 0), f);
        if (tid == 0) {
          sc.hg_ok = hg_ok_at(p, w, p.E + n_open + j);
          uint32_t zj = 0;
          sc.vg_ok = p.has_key ? vg_eval(p, w, sc.z0, sc.pd, &zj) : 1;
          sc.zj = zj;
        }
        __syncthreads();
        const uint32_t zj = sc.zj;
        int any = 0;
        for (int t = tid; t < T; t += nt) {
          bool v = w.its0[t];
          if (v && p.has_key) {
            bool compat = !sc.key_touched, fits = false;
            for (int d = 0; d < D; ++d) {
              if (!((zj >> d) & 1u)) continue;
              compat = compat || p.admit[(int64_t)t * D + d];
              fits = fits || p.capTd[(int64_t)t * D + d] >= cj;
            }
            v = compat && fits;
          } else if (v) {
            bool fits = false;
            for (int gr = 0; gr < GR && !fits; ++gr)
              fits = p.group_valid[(int64_t)t * GR + gr] && off_at(p, zm, cm, t, gr) &&
                     ktpu::fits_at(w.dg, w.rq, p.alloc + ((int64_t)t * GR + gr) * R, R, cj);
            v = fits;
          }
          p.its_b[(int64_t)j * T + t] = v;
          any |= v;
        }
        any = __syncthreads_or(any);
        if (!(sc.vg_ok && sc.hg_ok && any)) break;  // the whole gang spills
        // the block's debit: max cap over its remaining types (subtractMax)
        for (int r = tid; r < R; r += nt) {
          float m = -INFINITY;
          for (int t = 0; t < T; ++t)
            if (p.its_b[(int64_t)j * T + t]) m = fmaxf(m, p.cap[(int64_t)t * R + r]);
          if (!isfinite(m)) m = 0.0f;
          w.debit[r] = w.debit[r] + m;
        }
        // records land after the block's add loop: its c_j pods count once
        if (tid == 0) {
          if (p.has_key) {
            const bool single = __popc(zj) == 1;
            for (int v = 0; v < NGv; ++v) {
              if (!w.vi[4 * NGv + v] || sc.win_zinf || !(w.vi[v] == kAnti || single)) continue;
              for (int d = 0; d < D; ++d)
                if ((zj >> d) & 1u) w.cnt[v * D + d] += cj;
            }
          }
          for (int h = 0; h < NGh; ++h)
            if (w.hi[3 * NGh + h] && cj > 0) w.hi[5 * NGh + h] = 1;
          w.zb[j] = zj;
        }
        __syncthreads();
      }
    }
    const bool placed = try_place && j == want;

    // ---- 4. all or nothing ----------------------------------------------------
    if (placed) {
      const int64_t row0 = n_open;
      for (int64_t x = tid; x < (int64_t)want * T; x += nt)
        p.bank_its[(row0 + x / T) * T + x % T] = p.its_b[x];
      for (int x = tid; x < want * R; x += nt) {
        const int jj = x / R, r = x % R;
        const int32_t cj = min(max(count - jj * f, 0), f);
        p.bank_used[(row0 + jj) * R + r] = __fmaf_rn((float)cj, w.rq[r], w.dg[r]);
      }
      for (int jj = tid; jj < want; jj += nt) {
        p.bank_frozen[row0 + jj] = 1;
        p.bank_template[row0 + jj] = g;
        if (p.tk_idx >= 0) {
          p.bank_tk_inf[(row0 + jj) * p.TK + p.tk_idx] = sc.win_zinf;
          p.bank_tk_def[(row0 + jj) * p.TK + p.tk_idx] = p.zdef[bg] || sc.key_touched;
        }
      }
      if (p.tk_idx >= 0)
        for (int64_t x = tid; x < (int64_t)want * p.V; x += nt) {
          const int jj = (int)(x / p.V), v = (int)(x % p.V);
          p.bank_tk_mask[((row0 + jj) * p.TK + p.tk_idx) * p.V + v] =
              v < D ? (uint8_t)((w.zb[jj] >> v) & 1u) : p.kmask[bg * p.V + v];
        }
      for (int r = tid; r < R; r += nt) p.budget[(int64_t)g * R + r] = p.budget[(int64_t)g * R + r] + -w.debit[r];
      if (tid == 0) p.nodes_budget[g] = p.nodes_budget[g] + -(float)want;
      for (int x = tid; x < NGv * D; x += nt) p.vg_counts[(int64_t)(x / D) * p.V + x % D] = w.cnt[x];
      for (int x = tid; x < NGh * want; x += nt) {
        const int h = x / want, jj = x % want;
        if (w.hi[3 * NGh + h])
          p.hg_counts[(int64_t)h * p.S + p.E + n_open + jj] += min(max(count - jj * f, 0), f);
      }
    }
    if (tid == 0) {
      const int B = p.B;
      p.ys[b] = n_open;
      p.ys[B + b] = placed ? want : 0;
      p.ys[2 * B + b] = f;
      p.ys[3 * B + b] = placed ? g : -1;
      p.ys[4 * B + b] = placed ? 0 : count;
      p.ys[5 * B + b] = (sc.shaped && !sc.budget_ok) || (try_place && !placed) ? kGangSpill
                        : sc.shaped                                             ? kNoRoom
                                                                                : kNoClaim;
      sc.n_open = n_open + (placed ? want : 0);
    }
    __syncthreads();
  }
  if (tid == 0) *p.n_open = sc.n_open;
}

}  // namespace

// ptrs: a host array of the 49 device pointers in Gang's field order (0
// for rank in lexical order); dims: B, G, T, GR, R, Z, C, V, D, NGv, NGh,
// S, E, NCAP, maxg, TK, tk_idx, has_key, key_is_zone.
extern "C" int gang_scan(const int64_t* ptrs, int n_ptrs, const int64_t* dims, void* stream) {
  constexpr int kPtrs = 49;
  static_assert(offsetof(Gang, B) == kPtrs * sizeof(void*), "Gang: pointers first");
  if (n_ptrs != kPtrs) return (int)cudaErrorInvalidValue;
  Gang p;
  memcpy(&p, ptrs, kPtrs * sizeof(void*));
  int* const fields[] = {&p.B, &p.G, &p.T, &p.GR, &p.R, &p.Z, &p.C, &p.V, &p.D, &p.NGv, &p.NGh, &p.S, &p.E,
                         &p.NCAP, &p.maxg, &p.TK, &p.tk_idx, &p.has_key, &p.key_is_zone};
  for (int i = 0; i < 19; ++i) *fields[i] = (int)dims[i];
  if (p.D < 1 || p.D > kMaxD || (p.has_key && p.key_is_zone && p.D > p.Z) || p.B < 1 || p.maxg < 1)
    return (int)cudaErrorInvalidValue;
  Work w;
  const size_t smem = carve(p, nullptr, &w);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(gang_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gang_scan_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* gang_scan_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
