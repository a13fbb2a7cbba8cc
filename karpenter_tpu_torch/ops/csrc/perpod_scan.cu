// H7 perpod_eval and H8 perpod_commit — replace the per-pod step of the
// JAX package's ops/solver.py `_make_step` (solver.py:373-748), traced by
// `solve` (:1024) and `solve_from` (:1069), with ops/topology.py
// `vg_pod_precompute` (:383), `vg_evaluate` (:441), `vg_commit` (:492),
// `hg_evaluate` (:511) and `hg_commit` (:531) inlined.
//
// Per pod, two launches on the caller's stream:
//   H7 perpod_eval, one block per candidate row (E existing nodes, then W
//      window claims, then G templates). A block whose row cannot take the
//      pod (pod padding, a node that is not valid or not allowed, a window
//      row that is not open, a template that is not valid, not tolerated or
//      out of nodes budget) writes BIG after a few loads. Otherwise it
//      recomputes the pod's vocab-key group terms from the counts, forms
//      the combined requirements row ∩ pod in shared memory, tests
//      Compatible (strict, without the well-known allowance, in tier 1),
//      the resources (tier 1), the vocab-key groups (feasibility and the
//      narrowed domains ANDed into the row), the hostname groups at the
//      row's slot (e, E + slot_of[w], E + n_open), host ports and volumes,
//      then strides its threads over the T instance types for
//      its & it_compat & fits_off & it_allow (& cap_ok in tier 3). It
//      writes one int32 key: BIG when infeasible, else the row index
//      (tier 1), pods·W + w (tier 2) or the template index (tier 3).
//   H8 perpod_commit, one block: three block-wide minimum reductions over
//      the keys (tier 1 beats tier 2 beats tier 3; the least key wins, so
//      ties go to the lowest index), then the winner's combined
//      requirements, narrowing and viable types are recomputed by the same
//      device code as H7's and the carry is updated IN PLACE (the JAX
//      package cannot: its scan threads a new carry): assignment, the
//      node's or claim's requirements / usage / types / ports, template,
//      open, pods, slot_of, n_open, w_open, w_hw, spills, budget,
//      nodes_budget, vocab-key and hostname counts.
// `perpod_chunk` enqueues H7 and H8 for each of a chunk's pods from the
// host side of this file: one ctypes call per chunk, no host sync.
//
// Scenario mode (`perpod_whatif`) replaces `solve_whatif` (solver.py:1120-
// 1205): jax.vmap of `initial_state` + the scan of `_make_step` over S
// consolidation scenarios, each its own per-pod scan over its own pod list
// against its own surviving nodes and topology seeds. H7 runs on a grid of
// (E + W + G, S) blocks, blockIdx.y the scenario; H8 on S blocks, one per
// scenario, each exactly the single-scenario block. Every carry field H8
// writes, exist.valid, the validity row, the keys, the assignment and
// pod_idx carry a per-scenario byte stride; the catalog, template and
// topology tables are shared (stride 0). Step i of scenario s reads the
// union's pod row pod_idx[s, i] instead of a materialised [S, L, ...]
// copy. Each block first moves its scenario's pointers into shared
// memory. The single-scenario entries pass the same 89 pointers with
// pod_idx null (step i reads row i), S = 1 and no strides; they run the
// kernels' other instantiation, which reads its parameter in place and
// skips that prologue. One C call enqueues H7 + H8 for every step of all
// S scenarios, with no host sync.
//
// The it-compat term. The reference classifies each (claim, key) of the
// narrowed row: equal to the stored claim row -> implied by state.its
// (which certified that row when it was stored), else tested exactly,
// falling back to the full pairwise intersects when a pickable claim has
// a key equal to neither the pod's nor the stored row; both branches AND
// with state.its. H7 tests, per type, exactly the keys where the narrowed
// row differs from the stored row: equal to either branch whenever the
// stored rows satisfy that invariant, which every writer of the carry
// keeps (tests/test_torch_perpod.py drives the fallback branch).
//
// Numerics: charges are used + req as one f32 add; every count and key is
// int32; set tests are exact boolean reductions where the reference uses
// bf16 einsums; the spread pick keys on eff·2^16 + rank, the affinity
// bootstrap on rank, ties to the lowest index.
//
// Bound on an H100: a latency chain. Each pod is one H7 pass over the
// candidate rows' requirement rows and the type tables (L2-resident) and
// one single-block H8; the pods of a chunk cannot overlap, and most of
// the W blocks of H7 exit after one load.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int32_t kBig = 0x7fffffff;
constexpr int32_t kIntMin = -2147483647;  // INT_MIN of the encoding (-(2^31) + 1)
constexpr int32_t kIntMax = 0x7fffffff;
constexpr int32_t kRankBase = 1 << 16;
constexpr int32_t kNoRoom = -2;
constexpr int32_t kNoClaim = -1;
constexpr int kSpread = 0, kAffinity = 1, kAnti = 2;
constexpr int kEvalThreads = 128;
constexpr int kCommitThreads = 1024;

struct Set {
  uint8_t* mask;   // [n, K, V]
  uint8_t* inf;    // [n, K]
  uint8_t* excl;   // [n, K]
  int32_t* gte;    // [n, K]
  int32_t* lte;    // [n, K]
  uint8_t* def;    // [n, K]
};

// Field order = the pointer array's order (ops/cuda.py _PERPOD_FIELDS).
struct P {
  // carry, written by H8
  Set exist_reqs;          // [E]
  float* exist_used;       // [E, R]
  Set reqs;                // [W]
  float* used;             // [W, R]
  uint8_t* its;            // [W, T]
  int32_t* tmpl;           // [W]
  uint8_t* open;           // [W]
  int32_t* pods;           // [W]
  int32_t* n_open;         // []
  int32_t* slot_of;        // [W]
  int32_t* w_open;         // []
  int32_t* w_hw;           // []
  int32_t* spills;         // []
  float* budget;           // [G, R]
  float* nodes_budget;     // [G]
  int32_t* vg_counts;      // [NGv, V]
  int32_t* hg_counts;      // [NGh, S]
  int32_t* exist_ports;    // [E, NPp]
  int32_t* claim_ports;    // [W, NPp]
  int32_t* exist_vols;     // [E, NVp]
  // problem, read only
  float* avail;            // [E, R]
  uint8_t* exist_valid;    // [E]
  float* vol_limits;       // [E, ND]
  int32_t* vol_driver;     // [ND, NVp]
  Set it;                  // [T]
  float* alloc;            // [T, GR, R]
  uint8_t* group_valid;    // [T, GR]
  uint8_t* zc_avail;       // [T, GR, Z, C]
  float* cap;              // [T, R]
  Set tr;                  // [G] template requirements
  uint8_t* t_its;          // [G, T]
  float* daemon;           // [G, R]
  uint8_t* t_valid;        // [G]
  uint8_t* well_known;     // [K]
  int32_t* vg_key;         // [NGv]
  int32_t* vg_type;
  int32_t* vg_skew;
  int32_t* vg_mind;
  uint8_t* vg_domains;     // [NGv, V]
  int32_t* vg_rank;        // [NGv, V]
  uint8_t* vg_valid;       // [NGv]
  int32_t* hg_type;        // [NGh]
  int32_t* hg_skew;
  uint8_t* hg_extra;
  uint8_t* hg_valid;
  // the chunk's pod rows
  Set pr;                  // [L]
  float* requests;         // [L, R]
  uint8_t* tmpl_ok;        // [L, G]
  uint8_t* it_allow;       // [L, T]
  uint8_t* exist_ok;       // [L, E]
  int32_t* ports;          // [L, NPp]
  int32_t* port_conf;      // [L, NPp]
  int32_t* vols;           // [L, NVp]
  uint8_t* pvalid;         // [L]
  uint8_t* vg_applies;     // [L, NGv]
  uint8_t* vg_records;
  uint8_t* vg_self;
  uint8_t* hg_applies;     // [L, NGh]
  uint8_t* hg_records;
  uint8_t* hg_self;
  uint8_t* strict_mask;    // [L, K, V]
  // scratch and output
  int32_t* keys;           // [E + W + G]
  int32_t* assignment;     // [L]
  // the union pod row of each step; null in the single-scenario entries
  int32_t* pod_idx;        // [L]
  int E, W, G, T, K, V, R, GR, Z, C, NGv, NGh, S, NPp, NVp, ND, NCAP, L, zone_kid, ct_kid;
};
constexpr int kPtrs = 89;
constexpr int kDims = 20;

// The kernels' parameter: the block of scenario 0 and each pointer's byte
// stride from one scenario to the next (0 for what the scenarios share).
struct PS {
  P p;
  int64_t stride[kPtrs];
};

// the per-block workspace in dynamic shared memory
struct WS {
  uint8_t *pm, *cm;                                   // [K*V] pod / combined masks
  uint8_t *cinf, *cexcl, *cdef, *clen, *touched, *changed;  // [K]
  int32_t *cgte, *clte;                               // [K]
  uint8_t *pd, *okskew, *opts, *czero, *dom, *narrowed;  // [NGv*V]
  int32_t *eff, *rank;                                // [NGv*V]
  int32_t *gate, *boot, *gok;                         // [NGv]
  float* total;                                       // [R]
  int32_t* flag;                                      // [8]
};

__host__ __device__ inline char* take(char* base, size_t* off, size_t bytes) {
  char* p = base ? base + *off : nullptr;
  *off += (bytes + 15) & ~(size_t)15;
  return p;
}

// lays the workspace out from `base` (nullptr: only sizes it); returns bytes
__host__ __device__ inline size_t carve(WS* ws, char* base, int K, int V, int NGv, int R) {
  size_t off = 0;
  const size_t KV = (size_t)K * V, GV = (size_t)NGv * V;
  WS w;
  w.pm = (uint8_t*)take(base, &off, KV);
  w.cm = (uint8_t*)take(base, &off, KV);
  uint8_t** k8[] = {&w.cinf, &w.cexcl, &w.cdef, &w.clen, &w.touched, &w.changed};
  for (uint8_t** f : k8) *f = (uint8_t*)take(base, &off, K);
  int32_t** k32[] = {&w.cgte, &w.clte};
  for (int32_t** f : k32) *f = (int32_t*)take(base, &off, 4 * (size_t)K);
  uint8_t** g8[] = {&w.pd, &w.okskew, &w.opts, &w.czero, &w.dom, &w.narrowed};
  for (uint8_t** f : g8) *f = (uint8_t*)take(base, &off, GV);
  w.eff = (int32_t*)take(base, &off, 4 * GV);
  w.rank = (int32_t*)take(base, &off, 4 * GV);
  int32_t** n32[] = {&w.gate, &w.boot, &w.gok};
  for (int32_t** f : n32) *f = (int32_t*)take(base, &off, 4 * (size_t)NGv);
  w.total = (float*)take(base, &off, 4 * (size_t)R);
  w.flag = (int32_t*)take(base, &off, 4 * 8);
  if (ws) *ws = w;
  return off;
}

enum { F_OK = 0 };

// lenient(): NotIn (complement with exclusions) or DoesNotExist (an empty
// concrete set), on a defined key
__device__ __forceinline__ bool lenient_of(bool def, bool inf, bool excl, bool any_mask) {
  return def && ((inf && excl) || (!inf && !any_mask));
}

// Evaluate candidate (tier, idx) for pod `pod` into the workspace: the
// combined requirements (narrowed by the vocab-key groups) in ws.c*, the
// candidate's total usage in ws.total, and ws.flag[F_OK] = every test but
// the instance-type filter. Called by every thread of the block.
__device__ void eval_row(const P& p, WS& ws, int pod, int tier, int idx) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int K = p.K, V = p.V, KV = K * V, NGv = p.NGv;
  const Set& rs = tier == 1 ? p.exist_reqs : (tier == 2 ? p.reqs : p.tr);
  const int64_t ro = (int64_t)idx * KV, po = (int64_t)pod * KV;
  // ---- pod row and combined row (requirements.Add) -----------------------
  for (int i = tid; i < KV; i += nt) {
    const uint8_t pm = p.pr.mask[po + i];
    ws.pm[i] = pm;
    ws.cm[i] = pm & rs.mask[ro + i];
  }
  if (tid == 0) ws.flag[F_OK] = 1;
  __syncthreads();
  for (int k = tid; k < K; k += nt) {
    const int64_t pk = (int64_t)pod * K + k, rk = (int64_t)idx * K + k;
    const bool pinf = p.pr.inf[pk], pexcl = p.pr.excl[pk], pdef = p.pr.def[pk];
    const int32_t pgte = p.pr.gte[pk], plte = p.pr.lte[pk];
    const bool rinf = rs.inf[rk], rexcl = rs.excl[rk], rdef = rs.def[rk];
    const int32_t rgte = rs.gte[rk], rlte = rs.lte[rk];
    bool pany = false, rany = false, hit = false;
    for (int v = 0; v < V; ++v) {
      pany |= ws.pm[k * V + v] != 0;
      rany |= rs.mask[ro + k * V + v] != 0;
      hit |= ws.cm[k * V + v] != 0;
    }
    const bool plen = lenient_of(pdef, pinf, pexcl, pany);
    const bool rlen = lenient_of(rdef, rinf, rexcl, rany);
    const int32_t gte0 = max(rgte, pgte), lte0 = min(rlte, plte);
    const bool inf = rinf && pinf && gte0 <= lte0;
    ws.cinf[k] = inf;
    ws.cexcl[k] = (rexcl || pexcl) && inf;
    ws.cgte[k] = inf ? gte0 : kIntMin;
    ws.clte[k] = inf ? lte0 : kIntMax;
    ws.cdef[k] = rdef || pdef;
    // Compatible(row, pod): custom keys of the pod must be defined on the
    // row (well-known keys excused outside tier 1), shared keys intersect
    const bool wk = tier != 1 && p.well_known[k];
    const bool custom_ok = !pdef || wk || rdef || plen;
    const bool inter = !(rdef && pdef) || hit || inf || (rlen && plen);
    if (!(custom_ok && inter)) ws.flag[F_OK] = 0;
  }
  // ---- candidate usage ---------------------------------------------------
  for (int r = tid; r < p.R; r += nt) {
    const float req = p.requests[(int64_t)pod * p.R + r];
    const float base = tier == 1 ? p.exist_used[(int64_t)idx * p.R + r]
                       : tier == 2 ? p.used[(int64_t)idx * p.R + r]
                                   : p.daemon[(int64_t)idx * p.R + r];
    const float t = base + req;
    ws.total[r] = t;
    if (tier == 1 && !(t <= p.avail[(int64_t)idx * p.R + r] || t == 0.0f)) ws.flag[F_OK] = 0;
  }
  // ---- the pod's vocab-key group terms (vg_pod_precompute) ----------------
  for (int j = tid; j < NGv; j += nt) {
    const int key = p.vg_key[j];
    const int64_t gv = (int64_t)j * V;
    int32_t minc = kBig;
    int supported = 0;
    bool any_pos = false, any_pdpos = false;
    for (int v = 0; v < V; ++v) {
      const bool dom = p.vg_domains[gv + v];
      const bool pd = p.strict_mask[po + (int64_t)key * V + v];
      const int32_t c = p.vg_counts[gv + v];
      ws.dom[gv + v] = dom;
      ws.pd[gv + v] = pd;
      ws.rank[gv + v] = p.vg_rank[gv + v];
      ws.czero[gv + v] = c == 0;
      ws.opts[gv + v] = dom && pd && c > 0;
      if (dom && pd) {
        ++supported;
        minc = min(minc, c);
      }
      any_pos |= c > 0;
      any_pdpos |= pd && c > 0;
    }
    const int32_t mind = p.vg_mind[j];
    if (mind > 0 && supported < mind) minc = 0;
    if (minc == kBig) minc = 0;
    const int32_t self_add = p.vg_self[(int64_t)pod * NGv + j] ? 1 : 0;
    for (int v = 0; v < V; ++v) {
      const int32_t e = p.vg_counts[gv + v] + self_add;
      ws.eff[gv + v] = e;
      ws.okskew[gv + v] = (e - minc) <= p.vg_skew[j];
    }
    ws.boot[j] = self_add && (!any_pos || !any_pdpos);
    ws.gate[j] = p.vg_applies[(int64_t)pod * NGv + j] && p.vg_valid[j];
  }
  __syncthreads();
  for (int k = tid; k < K; k += nt) {
    bool t = false;
    for (int j = 0; j < NGv; ++j) t |= ws.gate[j] && p.vg_key[j] == k;
    ws.touched[k] = t;
  }
  // ---- vg_evaluate on the combined mask -------------------------------------
  for (int j = tid; j < NGv; j += nt) {
    const int64_t gv = (int64_t)j * V;
    const int64_t kv = (int64_t)p.vg_key[j] * V;
    const int type = p.vg_type[j];
    bool ok = false;
    if (type == kSpread) {
      int best = -1;
      int32_t bk = kBig;
      for (int v = 0; v < V; ++v) {
        if (!(ws.dom[gv + v] && ws.cm[kv + v] && ws.okskew[gv + v])) continue;
        const int32_t key = ws.eff[gv + v] * kRankBase + ws.rank[gv + v];
        if (best < 0 || key < bk) {
          bk = key;
          best = v;
        }
      }
      for (int v = 0; v < V; ++v) ws.narrowed[gv + v] = v == best;
      ok = best >= 0;
    } else if (type == kAffinity) {
      bool any_opts = false;
      for (int v = 0; v < V; ++v) any_opts |= ws.opts[gv + v] && ws.cm[kv + v];
      if (any_opts) {
        for (int v = 0; v < V; ++v) ws.narrowed[gv + v] = ws.opts[gv + v] && ws.cm[kv + v];
        ok = true;
      } else {
        int best = -1;
        int32_t bk = kBig;
        for (int v = 0; v < V; ++v) {
          if (!(ws.dom[gv + v] && ws.pd[gv + v] && ws.cm[kv + v])) continue;
          if (best < 0 || ws.rank[gv + v] < bk) {
            bk = ws.rank[gv + v];
            best = v;
          }
        }
        if (!ws.boot[j]) best = -1;
        for (int v = 0; v < V; ++v) ws.narrowed[gv + v] = v == best;
        ok = best >= 0;
      }
    } else {
      for (int v = 0; v < V; ++v) {
        const bool n = ws.dom[gv + v] && ws.pd[gv + v] && ws.cm[kv + v] && ws.czero[gv + v];
        ws.narrowed[gv + v] = n;
        ok |= n;
      }
    }
    ws.gok[j] = !ws.gate[j] || ok;
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < NGv; ++j)
      if (!ws.gok[j]) ws.flag[F_OK] = 0;
  // ---- _apply_topo: AND each applying group's choice into its key ---------
  for (int i = tid; i < KV; i += nt) {
    const int k = i / V, v = i - k * V;
    bool upd = true;
    for (int j = 0; j < NGv; ++j)
      if (ws.gate[j] && p.vg_key[j] == k) upd = upd && ws.narrowed[(int64_t)j * V + v];
    ws.cm[i] = ws.cm[i] && upd;
  }
  for (int k = tid; k < K; k += nt) {
    if (!ws.touched[k]) continue;
    ws.cinf[k] = 0;
    ws.cexcl[k] = 0;
    ws.cgte[k] = kIntMin;
    ws.clte[k] = kIntMax;
    ws.cdef[k] = 1;
  }
  // ---- hostname groups at the candidate's slot --------------------------------
  const int slot = tier == 1 ? idx : (tier == 2 ? p.E + p.slot_of[idx] : p.E + *p.n_open);
  for (int h = 0; h < p.NGh; ++h) {
    const bool gate = p.hg_applies[(int64_t)pod * p.NGh + h] && p.hg_valid[h];
    if (!gate) continue;
    const int32_t c = p.hg_counts[(int64_t)h * p.S + slot];
    const bool self = p.hg_self[(int64_t)pod * p.NGh + h];
    const int type = p.hg_type[h];
    bool ok;
    if (type == kSpread) {
      ok = c + (self ? 1 : 0) <= p.hg_skew[h];
    } else if (type == kAffinity) {
      ok = c > 0;
      if (!ok && self) {  // the bootstrap: the group is empty everywhere
        int any = p.hg_extra[h] != 0;
        for (int s = tid; s < p.S && !any; s += nt) any = p.hg_counts[(int64_t)h * p.S + s] > 0;
        ok = !__syncthreads_or(any);
      }
    } else {
      ok = c == 0;
    }
    if (!ok && tid == 0) ws.flag[F_OK] = 0;
  }
  // ---- host ports, volumes, toleration ------------------------------------------
  if (tid == 0) {
    bool ok = true;
    if (tier != 3) {
      const int32_t* used_ports = tier == 1 ? p.exist_ports : p.claim_ports;
      for (int l = 0; l < p.NPp; ++l)
        if (p.port_conf[(int64_t)pod * p.NPp + l] & used_ports[(int64_t)idx * p.NPp + l]) ok = false;
    }
    if (tier == 1) {
      bool pod_vols = false;
      for (int l = 0; l < p.NVp; ++l) pod_vols |= p.vols[(int64_t)pod * p.NVp + l] != 0;
      if (pod_vols) {
        for (int d = 0; d < p.ND; ++d) {
          int cnt = 0;
          for (int l = 0; l < p.NVp; ++l)
            cnt += __popc((uint32_t)((p.exist_vols[(int64_t)idx * p.NVp + l] | p.vols[(int64_t)pod * p.NVp + l])
                                     & p.vol_driver[(int64_t)d * p.NVp + l]));
          if (!((float)cnt <= p.vol_limits[(int64_t)idx * p.ND + d])) ok = false;
        }
      }
    }
    if (tier == 2 && !p.tmpl_ok[(int64_t)pod * p.G + p.tmpl[idx]]) ok = false;
    if (!ok) ws.flag[F_OK] = 0;
  }
  __syncthreads();
  // lenient() of the narrowed row, and (tier 2) the keys where it differs
  // from the stored claim row
  for (int k = tid; k < K; k += nt) {
    bool any = false, same = true;
    const int64_t rk = (int64_t)idx * K + k;
    for (int v = 0; v < V; ++v) {
      any |= ws.cm[k * V + v] != 0;
      if (tier == 2) same = same && ws.cm[k * V + v] == rs.mask[ro + k * V + v];
    }
    ws.clen[k] = lenient_of(ws.cdef[k], ws.cinf[k], ws.cexcl[k], any);
    if (tier == 2)
      same = same && ws.cinf[k] == rs.inf[rk] && ws.cexcl[k] == rs.excl[rk] && ws.cgte[k] == rs.gte[rk]
             && ws.clte[k] == rs.lte[rk] && ws.cdef[k] == rs.def[rk];
    ws.changed[k] = tier == 3 || !same;
  }
  __syncthreads();
}

// the per-key term of intersects(it[t], combined row) at key k
__device__ __forceinline__ bool key_ok(const P& p, const WS& ws, int t, int k) {
  const int64_t tk = (int64_t)t * p.K + k;
  const bool idef = p.it.def[tk];
  if (!(idef && ws.cdef[k])) return true;
  const uint8_t* im = p.it.mask + tk * p.V;
  const uint8_t* cm = ws.cm + (int64_t)k * p.V;
  bool any = false;
  for (int v = 0; v < p.V; ++v) {
    const bool m = im[v];
    if (m && cm[v]) return true;
    any |= m;
  }
  const bool iinf = p.it.inf[tk];
  if (iinf && ws.cinf[k] && max(p.it.gte[tk], ws.cgte[k]) <= min(p.it.lte[tk], ws.clte[k])) return true;
  return lenient_of(idef, iinf, p.it.excl[tk], any) && ws.clen[k];
}

// instance type t survives on the candidate: (its) & it_compat & fits_off
// & it_allow (& cap_ok, tier 3); fits_off tests the groups where the
// candidate's total fits and an offering sits in an admitted zone and
// capacity type
__device__ bool type_ok(const P& p, const WS& ws, int pod, int tier, int idx, int t) {
  const int64_t T = p.T;
  if (!p.it_allow[(int64_t)pod * T + t]) return false;
  if (tier == 2 ? !p.its[(int64_t)idx * T + t] : !p.t_its[(int64_t)idx * T + t]) return false;
  if (tier == 3)
    for (int r = 0; r < p.R; ++r)
      if (!(p.cap[(int64_t)t * p.R + r] <= p.budget[(int64_t)idx * p.R + r])) return false;
  for (int k = 0; k < p.K; ++k)
    if (ws.changed[k] && !key_ok(p, ws, t, k)) return false;
  const uint8_t* zm = ws.cm + (int64_t)p.zone_kid * p.V;
  const uint8_t* cmk = ws.cm + (int64_t)p.ct_kid * p.V;
  for (int gr = 0; gr < p.GR; ++gr) {
    const int64_t tg = (int64_t)t * p.GR + gr;
    if (!p.group_valid[tg]) continue;
    bool fit = true;
    for (int r = 0; r < p.R && fit; ++r) {
      const float tot = ws.total[r];
      fit = tot <= p.alloc[tg * p.R + r] || tot == 0.0f;
    }
    if (!fit) continue;
    const uint8_t* zc = p.zc_avail + tg * p.Z * p.C;
    for (int z = 0; z < p.Z; ++z) {
      if (!zm[z]) continue;
      for (int c = 0; c < p.C; ++c)
        if (cmk[c] && zc[z * p.C + c]) return true;
    }
  }
  return false;
}

// the block's parameters: in scenario mode, scenario s's block in shared
// memory, every pointer moved by s strides (needs blockDim.x >= kPtrs +
// kDims); the single-scenario entries read the kernel parameter itself
template <bool kScen>
__device__ __forceinline__ const P& block_params(const PS& ps, int s, P* sp) {
  if constexpr (!kScen) return ps.p;
  const int tid = threadIdx.x;
  const int64_t* src = reinterpret_cast<const int64_t*>(&ps.p);
  if (tid < kPtrs)
    reinterpret_cast<int64_t*>(sp)[tid] = src[tid] + (src[tid] ? (int64_t)s * ps.stride[tid] : 0);
  else if (tid < kPtrs + kDims)
    (&sp->E)[tid - kPtrs] = (&ps.p.E)[tid - kPtrs];
  __syncthreads();
  return *sp;
}

// the union pod row of step `step`
__device__ __forceinline__ int pod_row(const P& p, int step) { return p.pod_idx ? p.pod_idx[step] : step; }

// the candidate's live gates that need no workspace (block-uniform)
__device__ __forceinline__ bool row_live(const P& p, int step, int pod, int tier, int idx) {
  if (!p.pvalid[step]) return false;
  if (tier == 1) return p.exist_valid[idx] && p.exist_ok[(int64_t)pod * p.E + idx];
  if (tier == 2) return p.open[idx];
  return p.t_valid[idx] && p.tmpl_ok[(int64_t)pod * p.G + idx] && p.nodes_budget[idx] >= 1.0f;
}

template <bool kScen>
__global__ void __launch_bounds__(kEvalThreads) perpod_eval_kernel(const __grid_constant__ PS ps, int step) {
  extern __shared__ __align__(16) char smem[];
  __shared__ P sp;
  const P& p = block_params<kScen>(ps, blockIdx.y, &sp);
  const int pod = pod_row(p, step);
  const int row = blockIdx.x;
  const int tier = row < p.E ? 1 : (row < p.E + p.W ? 2 : 3);
  const int idx = tier == 1 ? row : (tier == 2 ? row - p.E : row - p.E - p.W);
  if (!row_live(p, step, pod, tier, idx)) {
    if (threadIdx.x == 0) p.keys[row] = kBig;
    return;
  }
  WS ws;
  carve(&ws, smem, p.K, p.V, p.NGv, p.R);
  eval_row(p, ws, pod, tier, idx);
  bool ok = ws.flag[F_OK] != 0;
  if (ok && tier != 1) {
    int any = 0;
    for (int t = threadIdx.x; t < p.T && !any; t += blockDim.x) any = type_ok(p, ws, pod, tier, idx, t);
    ok = __syncthreads_or(any) != 0;
  }
  if (threadIdx.x == 0)
    p.keys[row] = !ok ? kBig : (tier == 1 ? idx : (tier == 2 ? p.pods[idx] * p.W + idx : idx));
}

// block-wide minimum of three values, left in red[k][0]
__device__ __forceinline__ void block_min3(int32_t (*red)[32], int32_t v0, int32_t v1, int32_t v2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    v0 = min(v0, __shfl_down_sync(0xffffffffu, v0, off));
    v1 = min(v1, __shfl_down_sync(0xffffffffu, v1, off));
    v2 = min(v2, __shfl_down_sync(0xffffffffu, v2, off));
  }
  if (lane == 0) {
    red[0][warp] = v0;
    red[1][warp] = v1;
    red[2][warp] = v2;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int32_t a = lane < nw ? red[0][lane] : kBig;
    int32_t b = lane < nw ? red[1][lane] : kBig;
    int32_t c = lane < nw ? red[2][lane] : kBig;
    for (int off = 16; off > 0; off >>= 1) {
      a = min(a, __shfl_down_sync(0xffffffffu, a, off));
      b = min(b, __shfl_down_sync(0xffffffffu, b, off));
      c = min(c, __shfl_down_sync(0xffffffffu, c, off));
    }
    if (lane == 0) {
      red[0][0] = a;
      red[1][0] = b;
      red[2][0] = c;
    }
  }
  __syncthreads();
}

struct Pick {
  int place, found_e, found, opened, tier, idx, cslot, slot, assign, spilled;
};

template <bool kScen>
__global__ void __launch_bounds__(kCommitThreads) perpod_commit_kernel(const __grid_constant__ PS ps, int step) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int32_t red[3][32];
  __shared__ Pick pk;
  __shared__ P sp;
  const P& p = block_params<kScen>(ps, blockIdx.x, &sp);
  const int pod = pod_row(p, step);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int E = p.E, W = p.W, G = p.G;
  // ---- the three tiers' least keys -------------------------------------------
  int32_t b0 = kBig, b1 = kBig, b2 = kBig;
  for (int i = tid; i < E; i += nt) b0 = min(b0, p.keys[i]);
  for (int i = tid; i < W; i += nt) b1 = min(b1, p.keys[E + i]);
  for (int i = tid; i < G; i += nt) b2 = min(b2, p.keys[E + W + i]);
  block_min3(red, b0, b1, b2);
  if (tid == 0) {
    const int32_t n_open = *p.n_open, w_open = *p.w_open;
    const bool valid = p.pvalid[step];
    const bool found_e = red[0][0] < kBig;
    const int pick_e = found_e ? red[0][0] : 0;
    const bool found = !found_e && red[1][0] < kBig;
    const int pick = found ? red[1][0] % W : 0;
    const bool any_tf = red[2][0] < kBig;
    int g = 0;  // the first feasible template (index 0 when none is)
    if (any_tf)
      for (int i = 0; i < G; ++i)
        if (p.keys[E + W + i] == red[2][0]) {
          g = i;
          break;
        }
    const bool any_t = any_tf && valid && !found_e && !found;
    const bool can_open = any_t && w_open < W && n_open < p.NCAP;
    pk.spilled = any_t && !can_open && n_open < p.NCAP;
    pk.place = found_e || found || can_open;
    pk.found_e = found_e;
    pk.found = found;
    pk.opened = can_open && !found;
    pk.tier = found_e ? 1 : (found ? 2 : 3);
    pk.idx = found_e ? pick_e : (found ? pick : g);
    pk.cslot = found ? pick : w_open;
    pk.slot = found_e ? pick_e : E + (found ? p.slot_of[pick] : n_open);
    pk.assign = pk.place ? pk.slot : (any_t ? kNoRoom : kNoClaim);
  }
  __syncthreads();
  const Pick w = pk;
  if (!w.place) {
    if (tid == 0) {
      p.assignment[step] = w.assign;
      *p.spills += w.spilled;
    }
    return;
  }
  // ---- the winner, recomputed with the pre-commit counts --------------------------
  WS ws;
  carve(&ws, smem, p.K, p.V, p.NGv, p.R);
  eval_row(p, ws, pod, w.tier, w.idx);
  const int T = p.T;
  if (w.tier != 1) {
    // the claim row's viable types: tier 2 narrows its own row in place
    // (each thread reads and writes its own types), tier 3 fills the fresh row
    uint8_t* out = p.its + (int64_t)w.cslot * T;
    for (int t = tid; t < T; t += nt) out[t] = type_ok(p, ws, pod, w.tier, w.idx, t);
  }
  __syncthreads();
  // ---- commit -----------------------------------------------------------------------
  const int K = p.K, V = p.V, KV = K * V;
  const Set& dst = w.tier == 1 ? p.exist_reqs : p.reqs;
  const int drow = w.tier == 1 ? w.idx : w.cslot;
  for (int i = tid; i < KV; i += nt) dst.mask[(int64_t)drow * KV + i] = ws.cm[i];
  for (int k = tid; k < K; k += nt) {
    const int64_t dk = (int64_t)drow * K + k;
    dst.inf[dk] = ws.cinf[k];
    dst.excl[dk] = ws.cexcl[k];
    dst.gte[dk] = ws.cgte[k];
    dst.lte[dk] = ws.clte[k];
    dst.def[dk] = ws.cdef[k];
  }
  float* used_row = (w.tier == 1 ? p.exist_used : p.used) + (int64_t)drow * p.R;
  for (int r = tid; r < p.R; r += nt) used_row[r] = ws.total[r];
  int32_t* port_row = (w.tier == 1 ? p.exist_ports : p.claim_ports) + (int64_t)drow * p.NPp;
  for (int l = tid; l < p.NPp; l += nt) port_row[l] |= p.ports[(int64_t)pod * p.NPp + l];
  if (w.tier == 1)
    for (int l = tid; l < p.NVp; l += nt)
      p.exist_vols[(int64_t)drow * p.NVp + l] |= p.vols[(int64_t)pod * p.NVp + l];
  // vocab-key counts: the final values of each recording group's key, all
  // of them for anti-affinity, a single value otherwise, never a complement
  for (int j = tid; j < p.NGv; j += nt) {
    const int key = p.vg_key[j];
    int n = 0;
    for (int v = 0; v < V; ++v) n += ws.cm[key * V + v] != 0;
    const bool rec = p.vg_records[(int64_t)pod * p.NGv + j] && p.vg_valid[j];
    if (rec && !ws.cinf[key] && (p.vg_type[j] == kAnti || n == 1))
      for (int v = 0; v < V; ++v)
        if (ws.cm[key * V + v]) p.vg_counts[(int64_t)j * V + v] += 1;
  }
  for (int h = tid; h < p.NGh; h += nt)
    if (p.hg_records[(int64_t)pod * p.NGh + h] && p.hg_valid[h]) p.hg_counts[(int64_t)h * p.S + w.slot] += 1;
  // limits on open: the max capacity over the fresh claim's viable types
  if (w.opened)
    for (int r = tid; r < p.R; r += nt) {
      float m = -INFINITY;
      const uint8_t* row = p.its + (int64_t)w.cslot * T;
      for (int t = 0; t < T; ++t)
        if (row[t]) m = fmaxf(m, p.cap[(int64_t)t * p.R + r]);
      if (!isfinite(m)) m = 0.0f;
      p.budget[(int64_t)w.idx * p.R + r] += -m;
    }
  if (tid == 0) {
    if (w.tier != 1) {
      if (w.opened) {
        p.tmpl[w.cslot] = w.idx;
        p.slot_of[w.cslot] = *p.n_open;
        *p.n_open += 1;
        *p.w_open += 1;
        p.nodes_budget[w.idx] += -1.0f;
      }
      p.open[w.cslot] = 1;
      p.pods[w.cslot] += 1;
    }
    *p.w_hw = max(*p.w_hw, *p.w_open);
    p.assignment[step] = w.assign;
  }
}

struct Launch {
  PS ps;
  int S;
  bool scen;  // scenario mode (the scenario entries), else one scenario read in place
  size_t smem;
};

// strides: nullptr for the single-scenario entries (S = 1, stride 0)
int setup(const int64_t* ptrs, int n_ptrs, const int64_t* dims, const int64_t* strides, int S, Launch* out) {
  static_assert(offsetof(P, E) == kPtrs * sizeof(void*), "P: pointers first");
  static_assert(kEvalThreads >= kPtrs + kDims, "scenario_block needs a thread per field");
  if (n_ptrs != kPtrs || S < 1 || S > 65535) return (int)cudaErrorInvalidValue;
  PS ps;
  memset(&ps, 0, sizeof(ps));
  P& p = ps.p;
  memcpy(&p, ptrs, kPtrs * sizeof(void*));
  if (strides) memcpy(ps.stride, strides, kPtrs * sizeof(int64_t));
  int* d = &p.E;
  for (int i = 0; i < kDims; ++i) d[i] = (int)dims[i];
  if (p.K < 1 || p.V < 1 || p.R < 1 || p.NGv < 1 || p.NGh < 1 || p.Z > p.V || p.C > p.V)
    return (int)cudaErrorInvalidValue;
  const size_t smem = carve(nullptr, nullptr, p.K, p.V, p.NGv, p.R);
  const size_t static_smem = 4096;  // the scenario block, the reductions, the pick
  if (smem + static_smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  static size_t granted = 48 * 1024 - static_smem;
  if (smem > granted) {
    const void* fns[] = {(const void*)perpod_eval_kernel<false>, (const void*)perpod_eval_kernel<true>,
                         (const void*)perpod_commit_kernel<false>, (const void*)perpod_commit_kernel<true>};
    for (const void* fn : fns) {
      const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    granted = smem;
  }
  out->ps = ps;
  out->S = S;
  out->scen = strides != nullptr;
  out->smem = smem;
  return 0;
}

int launch_eval(const Launch& l, int step, cudaStream_t s) {
  const P& p = l.ps.p;
  const dim3 grid(p.E + p.W + p.G, l.S);
  if (l.scen)
    perpod_eval_kernel<true><<<grid, kEvalThreads, l.smem, s>>>(l.ps, step);
  else
    perpod_eval_kernel<false><<<grid, kEvalThreads, l.smem, s>>>(l.ps, step);
  return (int)cudaGetLastError();
}

int launch_commit(const Launch& l, int step, cudaStream_t s) {
  if (l.scen)
    perpod_commit_kernel<true><<<l.S, kCommitThreads, l.smem, s>>>(l.ps, step);
  else
    perpod_commit_kernel<false><<<l.S, kCommitThreads, l.smem, s>>>(l.ps, step);
  return (int)cudaGetLastError();
}

int run_steps(const Launch& l, int n_steps, cudaStream_t s) {
  int rc;
  for (int i = 0; i < n_steps; ++i) {
    if ((rc = launch_eval(l, i, s))) return rc;
    if ((rc = launch_commit(l, i, s))) return rc;
  }
  return 0;
}

}  // namespace

// ptrs: a host array of the 89 device pointers in P's field order (pod_idx
// null in the single-scenario entries); dims: E, W, G, T, K, V, R, GR, Z, C, NGv, NGh, S, NPp, NVp, ND, NCAP, L,
// zone_kid, ct_kid; strides: 89 byte strides per scenario. Each entry
// returns cudaGetLastError() of its launches.

// H7 alone, for pod `pod` of the chunk: keys[E + W + G]
extern "C" int perpod_eval(const int64_t* ptrs, int n_ptrs, const int64_t* dims, int pod, void* stream) {
  Launch l;
  const int rc = setup(ptrs, n_ptrs, dims, nullptr, 1, &l);
  return rc ? rc : launch_eval(l, pod, (cudaStream_t)stream);
}

// H8 alone, for pod `pod`, from the keys in the scratch buffer
extern "C" int perpod_commit(const int64_t* ptrs, int n_ptrs, const int64_t* dims, int pod, void* stream) {
  Launch l;
  const int rc = setup(ptrs, n_ptrs, dims, nullptr, 1, &l);
  return rc ? rc : launch_commit(l, pod, (cudaStream_t)stream);
}

// the chunk: H7 then H8 for pods 0 .. n_pods - 1, in order
extern "C" int perpod_chunk(const int64_t* ptrs, int n_ptrs, const int64_t* dims, int n_pods, void* stream) {
  Launch l;
  const int rc = setup(ptrs, n_ptrs, dims, nullptr, 1, &l);
  return rc ? rc : run_steps(l, n_pods, (cudaStream_t)stream);
}

// scenario mode: H7 then H8 for steps 0 .. n_steps - 1 of all S scenarios
extern "C" int perpod_whatif(const int64_t* ptrs, int n_ptrs, const int64_t* dims, const int64_t* strides, int S,
                             int n_steps, void* stream) {
  Launch l;
  const int rc = setup(ptrs, n_ptrs, dims, strides, S, &l);
  return rc ? rc : run_steps(l, n_steps, (cudaStream_t)stream);
}

// scenario mode, H7 alone for step `step`: keys[S, E + W + G]
extern "C" int perpod_whatif_eval(const int64_t* ptrs, int n_ptrs, const int64_t* dims, const int64_t* strides,
                                  int S, int step, void* stream) {
  Launch l;
  const int rc = setup(ptrs, n_ptrs, dims, strides, S, &l);
  return rc ? rc : launch_eval(l, step, (cudaStream_t)stream);
}

// scenario mode, H8 alone for step `step`, from the keys in the scratch buffer
extern "C" int perpod_whatif_commit(const int64_t* ptrs, int n_ptrs, const int64_t* dims, const int64_t* strides,
                                    int S, int step, void* stream) {
  Launch l;
  const int rc = setup(ptrs, n_ptrs, dims, strides, S, &l);
  return rc ? rc : launch_commit(l, step, (cudaStream_t)stream);
}

extern "C" const char* perpod_scan_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
