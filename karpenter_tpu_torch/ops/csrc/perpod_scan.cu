// perpod_scan_persistent — replaces the per-pod step of the JAX package's
// ops/solver.py `_make_step` (solver.py:373-748), traced by `solve`
// (:1024) and `solve_from` (:1069) and vmapped over consolidation
// scenarios by `solve_whatif` (:1120-1205), with ops/topology.py
// `vg_pod_precompute` (:383), `vg_evaluate` (:441), `vg_commit` (:492),
// `hg_evaluate` (:511) and `hg_commit` (:531) inlined, and the step's
// minValues and reservation branches (solver.py:513-531, 580-589, 683-700;
// `_min_values_ok` :289, `_reserve_options` :352). It takes the place
// of the port's earlier kernels H7 (a block per candidate row, a launch
// per pod) and H8 (a block to pick and commit, a launch per pod).
//
// One launch runs steps lo .. hi - 1 of a per-pod chunk (one block) or of
// every scenario of a what-if batch (one block per scenario, S blocks). A
// block owns its scenario's whole carry and loops over its steps; the
// scenarios are independent, so there is no grid-wide barrier. The carry's
// vocab-key counts and scalars (n_open, w_open, w_hw, spills) live in
// shared memory for the launch. Per step:
//   1. the pod-only terms, once, into shared memory: the pod row (its
//      masks as words of value bits), its vocab-key group terms (czero,
//      opts, okskew as words of value bits), the groups that apply and
//      the keys they touch, the hostname-group gates;
//   2. the candidates, tier by tier in precedence order, each tier only if
//      no earlier tier has a feasible row (the pick never reads a later
//      tier then). One thread per candidate row runs the row's scalar
//      tests (row_cheap: live gates, a node's free resources, host ports
//      and volumes, a claim's template and resource ceilings, the hostname
//      groups at the row's slot) and the block ballots the rows that pass
//      into a list in shared memory, with their keys. Each warp takes rows
//      from the list (every warp, or fewer when a wide vocabulary leaves
//      shared memory for fewer row scratches: the launch picks the most
//      that fit) and evaluates one at a time into its own scratch
//      (eval_row: the row's data loaded at once, the combined requirements
//      as value bits, Compatible, the vocab-key groups' narrowing over the
//      set bits only, then its lanes over the instance types with a vote
//      at the first surviving type), keeping the scratch of its best row.
//      A warp skips a row whose key is not below the least key found so
//      far (a shared hint, read through one lane so the warp agrees). The
//      least key is a minimum over the warps' slots in shared memory; keys
//      are distinct, so no tie can arise. Tier 1's key is the node index
//      and tier 3's the template index, so those tiers stop at the first
//      list chunk with a feasible row; tier 2's key (pods·W + row) needs
//      every live row;
//   3. the pick (the reference's merge of the tiers); the winner's row is
//      in its warp's kept scratch, computed with the pre-commit counts.
//      The block writes its viable types (tier 2 narrows its own row in
//      place) and commits the carry IN PLACE (the JAX package's scan
//      threads a new carry): assignment, the node's or claim's
//      requirements / usage / types / ports, template, open, pods,
//      slot_of, n_open, w_open, w_hw, spills, budget, nodes_budget,
//      vocab-key and hostname counts, and the claim's resource ceilings.
// A claim row's resource ceilings (row_max) are the most any of its viable
// types allocates; a pod whose total exceeds them fits no type, so
// row_cheap drops a full claim without its T-wide type scan.
// The read-only type tables come packed (ops/cuda.py `perpod_tables`: each
// table [.., T] with the type axis innermost, so the lanes of a warp read
// neighbouring bytes, the requirement masks as 32-bit words of value bits,
// the offerings as words of (zone, capacity type) bits, each field padded
// to 16 bytes). Each block stages the longest prefix of them that fits its
// shared memory with one bulk asynchronous copy (cp.async.bulk completing
// on an mbarrier) at the start of the launch; the rest it reads from the
// packed buffer in device memory.
//
// Scenario mode: every carry field the step writes, exist.valid, the
// validity row, the scratch, the assignment and pod_idx carry a
// per-scenario byte stride; the catalog, template and topology tables are
// shared (stride 0). Step i of scenario s reads the union's pod row
// pod_idx[s, i]. Each block first moves its scenario's pointers into shared
// memory; the single-scenario instantiation reads its parameter in place.
//
// The it-compat term. The reference classifies each (claim, key) of the
// narrowed row: equal to the stored claim row -> implied by state.its
// (which certified that row when it was stored), else tested exactly,
// falling back to the full pairwise intersects when a pickable claim has
// a key equal to neither the pod's nor the stored row; both branches AND
// with state.its. The kernel tests, per type, exactly the keys where the
// narrowed row differs from the stored row: equal to either branch
// whenever the stored rows satisfy that invariant, which every writer of
// the carry keeps (tests/test_torch_perpod.py drives the fallback branch).
//
// minValues and reservations (the launch's mv_active / res_active). A row's
// feasibility then depends on its whole viable type set, so eval_row
// tests all T types instead of stopping at the first survivor: each chunk
// of 32 types ballots its survivors, and lanes over words OR the
// survivors' value-bit words of the J min-keyed keys (table kMv) and
// their reserved-offering bits (kRes, bit r·RZ + z) into the row scratch.
// The floors are popcounts of those words against the template's mv_min
// (key -1: the survivors counted); the reservable options (to_res: an
// offering on a survivor in an admitted zone, capacity type and id, held
// already or with capacity left) stay in the scratch for the commit,
// which reserves the newly held ids and releases the dropped ones. The
// reservation capacities are the launch's, in shared memory, like the
// vocab-key counts; held rows take the carry's per-scenario stride.
//
// Numerics: charges are used + req as one f32 add; every count and key is
// int32; set tests are exact boolean reductions where the reference uses
// bf16 einsums; the spread pick keys on (count + self)·2^16 + rank, formed
// in uint32 so that it wraps as the reference's int32 arithmetic does, the
// affinity bootstrap on rank, ties to the lowest value index (set bits are
// visited lowest first).
//
// Bound on an H100: a latency chain. A step depends on the step before
// through the counts and the claim rows, so a block's steps cannot
// overlap; the work of a step is a few hundred live rows at most, each
// row's requirement row, usage and (claims) viable-type row read once, far
// under what the memory could move in the time. The design removes what
// is not that chain: no launch per step, no block per dead row, no
// per-row recomputation of the pod's terms, the cheap tests a thread per
// row, the rest a warp per row with its loads in flight together, and the
// type tables in shared memory.

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
constexpr int kThreads = 512;
enum { kNOpen, kWOpen, kWHw, kSpills };  // Pod::sc
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemMax = 232448;       // a block's shared memory on an H100
constexpr uint32_t kCopyChunk = 32768;  // bytes per bulk copy instruction

struct Set {
  uint8_t* mask;   // [n, K, V]
  uint8_t* inf;    // [n, K]
  uint8_t* excl;   // [n, K]
  int32_t* gte;    // [n, K]
  int32_t* lte;    // [n, K]
  uint8_t* def;    // [n, K]
};

// Field order = the pointer array's order (ops/cuda.py _perpod_fields).
struct P {
  // carry, written by the commit
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
  int32_t* hg_counts;      // [NGh, Sl]
  int32_t* exist_ports;    // [E, NPp]
  int32_t* claim_ports;    // [W, NPp]
  int32_t* exist_vols;     // [E, NVp]
  int32_t* res_cap;        // [RID] reservation capacity left
  uint8_t* held;           // [W, RID] the reservations each claim holds
  // problem, read only (the type tables come packed, see Tab)
  float* avail;            // [E, R]
  uint8_t* exist_valid;    // [E]
  float* vol_limits;       // [E, ND]
  int32_t* vol_driver;     // [ND, NVp]
  Set tr;                  // [G] template requirements
  float* daemon;           // [G, R]
  uint8_t* t_valid;        // [G]
  int32_t* mv_key;         // [G, M] minValues keys: -1 names, j >= 0 min-keyed key j, -2 none
  int32_t* mv_min;         // [G, M] their floors
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
  // scratch: each open claim row's resource ceilings, the most any of its
  // viable types allocates in a valid group (a necessary condition of the
  // type test, so row_cheap can drop a full claim); set for the open rows
  // at the start of a launch and for a claim row at its commit
  float* row_max;          // [W, R]
  // output
  int32_t* assignment;     // [L]
  // the union pod row of each step; null in the single-scenario entry
  int32_t* pod_idx;        // [L]
  // Sl: hostname slots (E + NCAP + 1), the second axis of hg_counts; J
  // min-keyed keys, M minValues entries per template; RID reservation ids
  // over RZ zones; the flags of the minValues and reservation branches
  int E, W, G, T, K, V, R, GR, Z, C, NGv, NGh, Sl, NPp, NVp, ND, NCAP, L, zone_kid, ct_kid;
  int J, M, RID, RZ, rid_kid, res_vid, mv_active, res_active, res_strict;
};
constexpr int kPtrs = 82;
constexpr int kDims = 29;

// The kernel's parameter: the block of scenario 0 and each pointer's byte
// stride from one scenario to the next (0 for what the scenarios share).
struct PS {
  P p;
  int64_t stride[kPtrs];
};

// The packed type tables (ops/cuda.py _TABLES), in staging order.
enum Tab { kTIts, kGv, kAlloc, kZc, kCap, kDef, kInf, kExcl, kMbits, kGte, kLte, kMv, kRes, kTabs };

struct TabArgs {
  const char* base;              // the packed buffer in device memory
  int64_t off[kTabs + 1];        // byte offset of each table, then the total
  uint32_t staged;               // bytes of the prefix staged in shared memory
};

struct Tabs {
  const uint8_t* t_its;   // [G, T]
  const uint8_t* gv;      // [GR, T]
  const float* alloc;     // [GR, R, T]
  const uint32_t* zc;     // [GR, NZW, T] (zone, capacity type) bits z*C + c
  const float* cap;       // [R, T]
  const uint8_t* def;     // [K, T]
  const uint8_t* inf;     // [K, T]
  const uint8_t* excl;    // [K, T]
  const uint32_t* mbits;  // [K, NW, T] value bits
  const int32_t* gte;     // [K, T]
  const int32_t* lte;     // [K, T]
  const uint32_t* mv;     // [J, NW, T] each type's value bits of the min-keyed keys
  const uint32_t* res;    // [NRW, T] each type's reserved offerings, bit r*RZ + z
};

// The pod-only terms of a step, and copies of the small read-only tables
// made once per launch (every row reads them). A requirement mask is kept
// as 32-bit words of value bits: NW = ceil(V / 32) words per key.
struct Pod {
  // once per launch; vgc and sc are the carry's vocab-key counts and its
  // scalars (n_open, w_open, w_hw, spills), kept here and written back at
  // the end of the launch
  uint32_t* domb;                                       // [NGv*NW] group domains
  uint8_t *vvalid, *wk, *hvalid, *hnonempty;            // [NGv], [K], [NGh], [NGh]
  int32_t *rank, *vkey, *vtype, *vskew, *vmind;         // [NGv*V], [NGv] x 4
  int32_t *htype, *hskew;                               // [NGh]
  int32_t *vgc, *sc;                                    // [NGv*V], [4]
  int32_t* rescap;                                      // [RID] the carry's reservation capacity
  // per step
  uint32_t *pmb, *smb;                                  // [K*NW] the pod mask's bits, its strict mask's
  uint8_t *pinf, *pexcl, *pdef, *plen, *touched;        // [K]
  int32_t *pgte, *plte;                                 // [K]
  uint32_t *czerob, *optsb, *okskewb;                   // [NGv*NW]
  uint8_t *vgate, *vself, *boot;                        // [NGv]
  int32_t* glist;                                       // [NGv] the groups that apply, in order
  uint8_t *hgate, *hself;                               // [NGh]
  float* req;                                           // [R]
  uint8_t *allow, *tok, *nits;                          // [T] it_allow row, [G] tmpl_ok row,
                                                        // [T] the committed claim's viable types
  int32_t *pconf, *pvols;                               // [NPp], [NVp]
  int32_t *list, *lkey;                                 // [kThreads] live rows, their keys
  uint8_t* rm;                                          // [nev][K*V, 16-byte rounded] each evaluating
                                                        // warp's byte copy of its row's mask
  int32_t* flags;                                       // [4]: 0 the pod has volumes, 1 the least key
                                                        // found, 2 the groups that apply, 3 the valid
                                                        // existing nodes (once per launch)
};

// One row's scratch. Each warp has two: it evaluates into one while the
// other holds its best row so far, which the commit then reads.
struct WS {
  uint32_t *rmb, *cmb, *narb;                      // [K*NW] the candidate's mask bits, the combined row's,
                                                   // [NGv*NW] each applying group's choice
  uint8_t *rinf, *rexcl, *rdef;                    // [K] the stored row
  int32_t *rgte, *rlte;                            // [K]
  uint8_t *cinf, *cexcl, *cdef, *clen, *changed;   // [K] the combined row
  int32_t *cgte, *clte;                            // [K]
  uint32_t* zcm;                                   // [NZW] admitted (zone, capacity type) bits
  float *total, *bud;                              // [R] usage with the pod, (tier 3) the budget
  uint32_t *mvb, *resb, *tores;                    // [J*NW] the viable types' min-keyed values,
                                                   // [NRW] their reserved offerings, [NTW] the
                                                   // reservable ids (to_res)
};

__host__ __device__ inline int words(int bits) { return (bits + 31) / 32; }

__host__ __device__ inline char* take(char* base, size_t* off, size_t bytes) {
  char* p = base ? base + *off : nullptr;
  *off += (bytes + 15) & ~(size_t)15;
  return p;
}

// Lays the workspace out from `base` (nullptr: only sizes it) after the
// staged tables: the pod terms and a mask buffer for each of the `nev`
// warps that evaluate rows, then two row scratches for each of them. Returns bytes. Mirrored by ops/cuda.py
// `perpod_workspace` (tests/test_torch_perpod_emulated.py holds the two
// equal).
__host__ __device__ inline size_t carve(char* base, const P& p, int nev, Pod* pod, WS (*ws)[2]) {
  size_t off = 0;
  const size_t K = p.K, GV = (size_t)p.NGv * p.V, NGv = p.NGv, NGh = p.NGh;
  const size_t NW = words(p.V), NZW = words(p.Z * p.C);
  const size_t JW = (size_t)p.J * NW, NRW = words(p.RID * p.RZ), NTW = words(p.RID);
  Pod d;
  d.domb = (uint32_t*)take(base, &off, 4 * NGv * NW);
  d.vvalid = (uint8_t*)take(base, &off, NGv);
  d.wk = (uint8_t*)take(base, &off, K);
  d.hvalid = (uint8_t*)take(base, &off, NGh);
  d.hnonempty = (uint8_t*)take(base, &off, NGh);
  d.rank = (int32_t*)take(base, &off, 4 * GV);
  int32_t** v32[] = {&d.vkey, &d.vtype, &d.vskew, &d.vmind};
  for (int32_t** f : v32) *f = (int32_t*)take(base, &off, 4 * NGv);
  d.htype = (int32_t*)take(base, &off, 4 * NGh);
  d.hskew = (int32_t*)take(base, &off, 4 * NGh);
  d.vgc = (int32_t*)take(base, &off, 4 * GV);
  d.sc = (int32_t*)take(base, &off, 16);
  d.rescap = (int32_t*)take(base, &off, 4 * (size_t)p.RID);
  d.pmb = (uint32_t*)take(base, &off, 4 * K * NW);
  d.smb = (uint32_t*)take(base, &off, 4 * K * NW);
  uint8_t** k8[] = {&d.pinf, &d.pexcl, &d.pdef, &d.plen, &d.touched};
  for (uint8_t** f : k8) *f = (uint8_t*)take(base, &off, K);
  d.pgte = (int32_t*)take(base, &off, 4 * K);
  d.plte = (int32_t*)take(base, &off, 4 * K);
  uint32_t** gb[] = {&d.czerob, &d.optsb, &d.okskewb};
  for (uint32_t** f : gb) *f = (uint32_t*)take(base, &off, 4 * NGv * NW);
  uint8_t** g8[] = {&d.vgate, &d.vself, &d.boot};
  for (uint8_t** f : g8) *f = (uint8_t*)take(base, &off, NGv);
  d.glist = (int32_t*)take(base, &off, 4 * NGv);
  d.hgate = (uint8_t*)take(base, &off, NGh);
  d.hself = (uint8_t*)take(base, &off, NGh);
  d.req = (float*)take(base, &off, 4 * (size_t)p.R);
  d.allow = (uint8_t*)take(base, &off, p.T);
  d.tok = (uint8_t*)take(base, &off, p.G);
  d.nits = (uint8_t*)take(base, &off, p.T);
  d.pconf = (int32_t*)take(base, &off, 4 * (size_t)p.NPp);
  d.pvols = (int32_t*)take(base, &off, 4 * (size_t)p.NVp);
  d.list = (int32_t*)take(base, &off, 4 * (size_t)kThreads);
  d.lkey = (int32_t*)take(base, &off, 4 * (size_t)kThreads);
  d.flags = (int32_t*)take(base, &off, 16);
  d.rm = (uint8_t*)take(base, &off, nev * (((size_t)p.K * p.V + 15) & ~(size_t)15));
  if (pod) *pod = d;
  for (int w = 0; w < 2 * nev; ++w) {
    WS s;
    uint32_t** wb[] = {&s.rmb, &s.cmb};
    for (uint32_t** f : wb) *f = (uint32_t*)take(base, &off, 4 * K * NW);
    s.narb = (uint32_t*)take(base, &off, 4 * NGv * NW);
    uint8_t** w8[] = {&s.rinf, &s.rexcl, &s.rdef, &s.cinf, &s.cexcl, &s.cdef, &s.clen, &s.changed};
    for (uint8_t** f : w8) *f = (uint8_t*)take(base, &off, K);
    int32_t** w32[] = {&s.rgte, &s.rlte, &s.cgte, &s.clte};
    for (int32_t** f : w32) *f = (int32_t*)take(base, &off, 4 * K);
    s.zcm = (uint32_t*)take(base, &off, 4 * NZW);
    s.total = (float*)take(base, &off, 4 * (size_t)p.R);
    s.bud = (float*)take(base, &off, 4 * (size_t)p.R);
    s.mvb = (uint32_t*)take(base, &off, 4 * JW);
    s.resb = (uint32_t*)take(base, &off, 4 * NRW);
    s.tores = (uint32_t*)take(base, &off, 4 * NTW);
    if (ws) ws[w / 2][w % 2] = s;
  }
  return off;
}

// lenient(): NotIn (complement with exclusions) or DoesNotExist (an empty
// concrete set), on a defined key
__device__ __forceinline__ bool lenient_of(bool def, bool inf, bool excl, bool any_mask) {
  return def && ((inf && excl) || (!inf && !any_mask));
}

__device__ __forceinline__ const Set& tier_set(const P& p, int tier) {
  return tier == 1 ? p.exist_reqs : (tier == 2 ? p.reqs : p.tr);
}

__device__ __forceinline__ bool bit(const uint32_t* b, int v) { return (b[v >> 5] >> (v & 31)) & 1u; }

// the per-key term of intersects(it[t], combined row) at key k
__device__ __forceinline__ bool key_ok(const P& p, const Tabs& tb, const WS& ws, int t, int k) {
  const int T = p.T;
  const bool idef = tb.def[k * T + t];
  if (!(idef && ws.cdef[k])) return true;
  const int NW = words(p.V);
  bool any = false;
  for (int w = 0; w < NW; ++w) {
    const uint32_t m = tb.mbits[(k * NW + w) * T + t];
    if (m & ws.cmb[k * NW + w]) return true;
    any |= m != 0;
  }
  const bool iinf = tb.inf[k * T + t];
  if (iinf && ws.cinf[k] && max(tb.gte[k * T + t], ws.cgte[k]) <= min(tb.lte[k * T + t], ws.clte[k])) return true;
  return lenient_of(idef, iinf, tb.excl[k * T + t], any) && ws.clen[k];
}

// the candidate's total fits allocatable group gr of instance type t
__device__ __forceinline__ bool group_fits(const P& p, const Tabs& tb, const WS& ws, int t, int gr) {
  const int T = p.T, R = p.R;
  bool fit = tb.gv[gr * T + t];
  for (int r = 0; r < R && fit; ++r) {
    const float tot = ws.total[r];
    fit = tot <= tb.alloc[(gr * R + r) * T + t] || tot == 0.0f;
  }
  return fit;
}

// instance type t survives on the candidate: (its) & it_compat & fits_off
// & it_allow (& cap_ok, tier 3); fits_off tests the groups where the
// candidate's total fits and an offering sits in an admitted zone and
// capacity type. The resource test goes before the key tests: it is the
// one a full claim fails, for every type.
__device__ bool type_ok(const P& p, const Tabs& tb, const Pod& pa, const WS& ws, int tier, int idx, int t) {
  const int T = p.T, R = p.R;
  if (!pa.allow[t]) return false;
  if (tier == 2 ? !p.its[(int64_t)idx * T + t] : !tb.t_its[(int64_t)idx * T + t]) return false;
  if (tier == 3)
    for (int r = 0; r < R; ++r)
      if (!(tb.cap[r * T + t] <= ws.bud[r])) return false;
  uint32_t fits = 0;  // the first 32 groups where the total fits; later ones are tested again
  bool any = false;
  for (int gr = 0; gr < p.GR; ++gr) {
    const bool fit = group_fits(p, tb, ws, t, gr);
    if (gr < 32) fits |= (uint32_t)fit << gr;
    any |= fit;
  }
  if (!any) return false;
  for (int k = 0; k < p.K; ++k)
    if (ws.changed[k] && !key_ok(p, tb, ws, t, k)) return false;
  const int NZW = words(p.Z * p.C);
  for (int gr = 0; gr < p.GR; ++gr) {
    if (!(gr < 32 ? (fits >> gr & 1u) != 0 : group_fits(p, tb, ws, t, gr))) continue;
    for (int w = 0; w < NZW; ++w)
      if (tb.zc[(gr * NZW + w) * T + t] & ws.zcm[w]) return true;
  }
  return false;
}

// The candidate's scalar tests, one thread per row: its live gates (a
// valid node the pod may use, an open window row, a valid template the pod
// tolerates within its nodes budget), and the tests of the row's own
// scalars — a node's free resources, host ports and volume limits, a
// claim's template toleration, resource ceilings and host ports, the
// hostname groups at the row's slot (e, E + slot_of[w], E + n_open). The
// rest is eval_row's. The tests accumulate rather than return early, so
// the row's loads are in flight together.
__device__ bool row_cheap(const P& p, const Pod& pa, int pod, int tier, int idx) {
  const int R = p.R;
  bool ok;
  int slot;
  if (tier == 1) {
    ok = (p.exist_valid[idx] != 0) & (p.exist_ok[(int64_t)pod * p.E + idx] != 0);
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      const float t = p.exist_used[(int64_t)idx * R + r] + pa.req[r];
      ok &= (t <= p.avail[(int64_t)idx * R + r]) | (t == 0.0f);
    }
    for (int l = 0; l < p.NPp; ++l) ok &= (pa.pconf[l] & p.exist_ports[(int64_t)idx * p.NPp + l]) == 0;
    if (pa.flags[0] && ok)
      for (int d = 0; d < p.ND; ++d) {
        int cnt = 0;
        for (int l = 0; l < p.NVp; ++l)
          cnt += __popc((uint32_t)((p.exist_vols[(int64_t)idx * p.NVp + l] | pa.pvols[l])
                                   & p.vol_driver[(int64_t)d * p.NVp + l]));
        ok &= (float)cnt <= p.vol_limits[(int64_t)idx * p.ND + d];
      }
    slot = idx;
  } else if (tier == 2) {
    const int tmpl = p.tmpl[idx];
    slot = p.E + p.slot_of[idx];
    ok = p.open[idx] != 0;
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      const float t = p.used[(int64_t)idx * R + r] + pa.req[r];
      ok &= (t <= p.row_max[(int64_t)idx * R + r]) | (t == 0.0f);
    }
    for (int l = 0; l < p.NPp; ++l) ok &= (pa.pconf[l] & p.claim_ports[(int64_t)idx * p.NPp + l]) == 0;
    ok &= pa.tok[tmpl] != 0;
  } else {
    ok = (p.t_valid[idx] != 0) & (pa.tok[idx] != 0) & (p.nodes_budget[idx] >= 1.0f);
    slot = p.E + pa.sc[kNOpen];
  }
  for (int h = 0; h < p.NGh; ++h) {
    if (!pa.hgate[h]) continue;
    const int32_t c = p.hg_counts[(int64_t)h * p.Sl + slot];
    const int type = pa.htype[h];
    if (type == kSpread)
      ok &= c + (pa.hself[h] ? 1 : 0) <= pa.hskew[h];
    else if (type == kAffinity)  // the bootstrap: the group is empty everywhere
      ok &= c > 0 || (pa.hself[h] && !pa.hnonempty[h]);
    else
      ok &= c == 0;
  }
  return ok;
}

// eval_row's type test under minValues or reservations: every type, the
// survivors' min-keyed value words and reserved offerings ORed into the
// scratch, then the floors (_min_values_ok) and the reservable options
// (_reserve_options, the strict refusals), warp-uniform. Leaves to_res in
// ws.tores.
__device__ bool eval_types_full(const P& p, const Tabs& tb, const Pod& pa, const WS& ws, int tier, int idx,
                                bool its_first) {
  const int lane = threadIdx.x & 31, T = p.T, NW = words(p.V);
  const int JW = p.J * NW, NRW = words(p.RID * p.RZ), NTW = words(p.RID);
  for (int q = lane; q < JW; q += 32) ws.mvb[q] = 0;
  for (int q = lane; q < NRW; q += 32) ws.resb[q] = 0;
  int n = 0;  // the surviving types
  for (int b = 0; b < T; b += 32) {
    const int t = b + lane;
    const bool ok = t < T && (b == 0 ? its_first : true) && type_ok(p, tb, pa, ws, tier, idx, t);
    const unsigned m = __ballot_sync(kFull, ok);
    n += __popc(m);
    // lanes over words, each ORing its word of every survivor of the chunk
    if (p.mv_active)
      for (int q = lane; q < JW; q += 32) {
        uint32_t acc = 0;
        for (unsigned c = m; c; c &= c - 1) acc |= tb.mv[(int64_t)q * T + b + __ffs(c) - 1];
        ws.mvb[q] |= acc;
      }
    if (p.res_active)
      for (int q = lane; q < NRW; q += 32) {
        uint32_t acc = 0;
        for (unsigned c = m; c; c &= c - 1) acc |= tb.res[(int64_t)q * T + b + __ffs(c) - 1];
        ws.resb[q] |= acc;
      }
  }
  __syncwarp();
  if (n == 0) return false;
  bool bad = false;
  if (p.mv_active) {
    // the floors: key -1 counts the types, key j the distinct values of
    // min-keyed key j; padding entries have floor 0
    const int tmpl = tier == 2 ? p.tmpl[idx] : idx;
    for (int m = lane; m < p.M; m += 32) {
      const int32_t key = p.mv_key[(int64_t)tmpl * p.M + m], need = p.mv_min[(int64_t)tmpl * p.M + m];
      if (need <= 0) continue;
      int cnt = n;
      if (key != -1) {
        const int j = min(max(key, 0), p.J - 1);
        cnt = 0;
        for (int w = 0; w < NW; ++w) cnt += __popc(ws.mvb[j * NW + w]);
      }
      if (cnt < need) bad = true;
    }
  }
  if (p.res_active) {
    // an available reserved offering on a survivor whose zone, reservation
    // id and capacity type the narrowed row admits; reservable when the
    // claim holds it already or capacity is left
    const uint32_t* zb = ws.cmb + p.zone_kid * NW;
    const uint32_t* rb = ws.cmb + p.rid_kid * NW;
    const bool ct_res = bit(ws.cmb + p.ct_kid * NW, p.res_vid);
    const uint8_t* hrow = tier == 2 ? p.held + (int64_t)idx * p.RID : nullptr;
    bool any_ofs = false, any_to = false, any_held = false;
    for (int w = lane; w < NTW; w += 32) {
      uint32_t to = 0;
      for (int r = 32 * w; r < min(p.RID, 32 * w + 32); ++r) {
        bool hit = false;
        for (int z = 0; z < p.RZ && !hit; ++z) hit = bit(ws.resb, r * p.RZ + z) && bit(zb, z);
        const bool ofs = hit && bit(rb, r) && ct_res;
        const bool h = hrow && hrow[r];
        any_ofs |= ofs;
        any_held |= h;
        if (ofs && (h || pa.rescap[r] > 0)) to |= 1u << (r & 31);
      }
      ws.tores[w] = to;
      any_to |= to != 0;
    }
    // strict (scheduler.go:75-78): refuse when reserved offerings are
    // compatible but none can be held, or (tier 2) when the add would
    // drop the claim's reservations
    const bool ao = __any_sync(kFull, any_ofs), at = __any_sync(kFull, any_to);
    const bool ah = __any_sync(kFull, any_held);
    if (p.res_strict && (ao || (tier == 2 && ah)) && !at) bad = true;
  }
  __syncwarp();
  return !__any_sync(kFull, bad);
}

// Evaluate candidate (tier, idx), which passed row_cheap, for pod `pod`
// with the calling warp: returns (warp-uniform) whether the row is
// feasible, its instance types included. A feasible row leaves in ws the
// combined requirements narrowed by the vocab-key groups (value bits in
// cmb), the keys that differ from the stored row and the candidate's
// total usage; an infeasible one may stop at the first failed test. The
// row's own data is loaded first, every load issued before any is used.
__device__ bool eval_row(const P& p, const Tabs& tb, const Pod& pa, const WS& ws, int pod, int tier, int idx) {
  const int lane = threadIdx.x & 31;
  const int K = p.K, V = p.V, KV = K * V, R = p.R, T = p.T, NW = words(V);
  const Set& rs = tier_set(p, tier);
  const int64_t ro = (int64_t)idx * KV, rk0 = (int64_t)idx * K;
  // ---- the row's data (the first 32 keys and resources take the register
  // path, anything past them a loop) ------------------------------------------
  float base = 0.0f, bud = 0.0f;
  if (lane < R) {
    base = tier == 1 ? p.exist_used[(int64_t)idx * R + lane]
           : tier == 2 ? p.used[(int64_t)idx * R + lane]
                       : p.daemon[(int64_t)idx * R + lane];
    if (tier == 3) bud = p.budget[(int64_t)idx * R + lane];
  }
  // the first types' row, so their first test finds it in cache
  const bool its_first = tier != 1 && lane < T
                         && (tier == 2 ? p.its[(int64_t)idx * T + lane] : tb.t_its[(int64_t)idx * T + lane]);
  uint8_t rinf = 0, rexcl = 0, rdef = 0;
  int32_t rgte = 0, rlte = 0;
  if (lane < K) {
    rinf = rs.inf[rk0 + lane];
    rexcl = rs.excl[rk0 + lane];
    rdef = rs.def[rk0 + lane];
    rgte = rs.gte[rk0 + lane];
    rlte = rs.lte[rk0 + lane];
  }
  // the stored mask into the warp's byte buffer (KV <= 512: a word per
  // lane and round, the loads in flight together)
  uint8_t* rm = pa.rm + (size_t)(threadIdx.x >> 5) * ((KV + 15) & ~15);
  const bool words4 = (KV & 3) == 0 && KV <= 512;
  uint32_t mw[4] = {0, 0, 0, 0};
  if (words4) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(rs.mask + ro);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (lane + 32 * q < KV / 4) mw[q] = src[lane + 32 * q];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (lane + 32 * q < KV / 4) reinterpret_cast<uint32_t*>(rm)[lane + 32 * q] = mw[q];
  } else {
    for (int i = lane; i < KV; i += 32) rm[i] = rs.mask[ro + i];
  }
  if (lane < K) {
    ws.rinf[lane] = rinf;
    ws.rexcl[lane] = rexcl;
    ws.rdef[lane] = rdef;
    ws.rgte[lane] = rgte;
    ws.rlte[lane] = rlte;
  }
  for (int k = lane + 32; k < K; k += 32) {
    ws.rinf[k] = rs.inf[rk0 + k];
    ws.rexcl[k] = rs.excl[rk0 + k];
    ws.rdef[k] = rs.def[rk0 + k];
    ws.rgte[k] = rs.gte[rk0 + k];
    ws.rlte[k] = rs.lte[rk0 + k];
  }
  if (lane < R) {
    ws.bud[lane] = bud;
    ws.total[lane] = base + pa.req[lane];
  }
  for (int r = lane + 32; r < R; r += 32) {
    ws.bud[r] = tier == 3 ? p.budget[(int64_t)idx * R + r] : 0.0f;
    ws.total[r] = (tier == 1 ? p.exist_used[(int64_t)idx * R + r]
                   : tier == 2 ? p.used[(int64_t)idx * R + r]
                               : p.daemon[(int64_t)idx * R + r]) + pa.req[r];
  }
  __syncwarp();
  // the stored mask's value bits: one ballot per (key, word), lanes over values
  for (int k = 0; k < K; ++k)
    for (int w = 0; w < NW; ++w) {
      const int v = 32 * w + lane;
      const unsigned b = __ballot_sync(kFull, v < V && rm[k * V + v]);
      if (lane == 0) ws.rmb[k * NW + w] = b;
    }
  __syncwarp();
  // ---- combined row (requirements.Add) and Compatible(row, pod) -------------
  bool bad = false;
  for (int k = lane; k < K; k += 32) {
    const bool pinf = pa.pinf[k], pdef = pa.pdef[k];
    const bool rinf = ws.rinf[k], rexcl = ws.rexcl[k], rdef = ws.rdef[k];
    bool rany = false, hit = false;
    for (int w = 0; w < NW; ++w) {
      const uint32_t r = ws.rmb[k * NW + w], c = r & pa.pmb[k * NW + w];
      ws.cmb[k * NW + w] = c;
      rany |= r != 0;
      hit |= c != 0;
    }
    const bool plen = pa.plen[k];
    const bool rlen = lenient_of(rdef, rinf, rexcl, rany);
    const int32_t gte0 = max(ws.rgte[k], pa.pgte[k]), lte0 = min(ws.rlte[k], pa.plte[k]);
    const bool inf = rinf && pinf && gte0 <= lte0;
    ws.cinf[k] = inf;
    ws.cexcl[k] = (rexcl || pa.pexcl[k]) && inf;
    ws.cgte[k] = inf ? gte0 : kIntMin;
    ws.clte[k] = inf ? lte0 : kIntMax;
    ws.cdef[k] = rdef || pdef;
    // custom keys of the pod must be defined on the row (well-known keys
    // excused outside tier 1), shared keys intersect
    const bool wk = tier != 1 && pa.wk[k];
    const bool custom_ok = !pdef || wk || rdef || plen;
    const bool inter = !(rdef && pdef) || hit || inf || (rlen && plen);
    if (!(custom_ok && inter)) bad = true;
  }
  __syncwarp();
  if (__any_sync(kFull, bad)) return false;
  // ---- vg_evaluate of the groups that apply, on the combined mask: the
  // candidates are words of bits, visited lowest value first -----------------
  const int ng = pa.flags[2];
  for (int q = lane; q < ng; q += 32) {
    const int j = pa.glist[q];
    const int gw = j * NW, kw = pa.vkey[j] * NW, gv = j * V;
    const int type = pa.vtype[j];
    int best = -1;
    bool ok = false;
    if (type == kSpread) {
      const int32_t self_add = pa.vself[j] ? 1 : 0;
      int32_t bk = kBig;
      for (int w = 0; w < NW; ++w)
        for (uint32_t c = pa.domb[gw + w] & ws.cmb[kw + w] & pa.okskewb[gw + w]; c; c &= c - 1) {
          const int v = 32 * w + __ffs(c) - 1;
          const int32_t key = (int32_t)((uint32_t)(pa.vgc[gv + v] + self_add) * (uint32_t)kRankBase
                                        + (uint32_t)pa.rank[gv + v]);
          if (best < 0 || key < bk) {
            bk = key;
            best = v;
          }
        }
    } else if (type == kAffinity) {
      bool any_opts = false;
      for (int w = 0; w < NW; ++w) any_opts |= (pa.optsb[gw + w] & ws.cmb[kw + w]) != 0;
      if (any_opts) {
        for (int w = 0; w < NW; ++w) ws.narb[gw + w] = pa.optsb[gw + w] & ws.cmb[kw + w];
        ok = true;
      } else if (pa.boot[j]) {
        int32_t bk = kBig;
        for (int w = 0; w < NW; ++w)
          for (uint32_t c = pa.domb[gw + w] & pa.smb[kw + w] & ws.cmb[kw + w]; c; c &= c - 1) {
            const int v = 32 * w + __ffs(c) - 1;
            if (best < 0 || pa.rank[gv + v] < bk) {
              bk = pa.rank[gv + v];
              best = v;
            }
          }
      }
    } else {
      for (int w = 0; w < NW; ++w) {
        const uint32_t n = pa.domb[gw + w] & pa.smb[kw + w] & ws.cmb[kw + w] & pa.czerob[gw + w];
        ws.narb[gw + w] = n;
        ok |= n != 0;
      }
    }
    if (type == kSpread || (type == kAffinity && !ok)) {  // a single value, or none
      for (int w = 0; w < NW; ++w) ws.narb[gw + w] = best >= 0 && best >> 5 == w ? 1u << (best & 31) : 0u;
      ok = best >= 0;
    }
    if (!ok) bad = true;
  }
  __syncwarp();
  if (__any_sync(kFull, bad)) return false;
  // ---- _apply_topo: AND each applying group's choice into its key, which
  // becomes a concrete finite set --------------------------------------------
  for (int k = lane; k < K; k += 32) {
    if (!pa.touched[k]) continue;
    for (int q = 0; q < ng; ++q) {
      const int j = pa.glist[q];
      if (pa.vkey[j] == k)
        for (int w = 0; w < NW; ++w) ws.cmb[k * NW + w] &= ws.narb[j * NW + w];
    }
    ws.cinf[k] = 0;
    ws.cexcl[k] = 0;
    ws.cgte[k] = kIntMin;
    ws.clte[k] = kIntMax;
    ws.cdef[k] = 1;
  }
  __syncwarp();
  // ---- lenient() of the narrowed row, the keys where it differs from the
  // stored row (tier 3: every key), the admitted offerings --------------------
  for (int k = lane; k < K; k += 32) {
    bool any = false, same = true;
    for (int w = 0; w < NW; ++w) {
      any |= ws.cmb[k * NW + w] != 0;
      same = same && ws.cmb[k * NW + w] == ws.rmb[k * NW + w];
    }
    ws.clen[k] = lenient_of(ws.cdef[k], ws.cinf[k], ws.cexcl[k], any);
    same = same && ws.cinf[k] == ws.rinf[k] && ws.cexcl[k] == ws.rexcl[k] && ws.cgte[k] == ws.rgte[k]
           && ws.clte[k] == ws.rlte[k] && ws.cdef[k] == ws.rdef[k];
    ws.changed[k] = tier == 3 || !same;
  }
  const int ZC = p.Z * p.C;
  const uint32_t* zb = ws.cmb + p.zone_kid * NW;
  const uint32_t* cb = ws.cmb + p.ct_kid * NW;
  for (int w = lane; w < words(ZC); w += 32) {
    uint32_t bits = 0;
    for (int b = w * 32; b < min(ZC, w * 32 + 32); ++b) {
      const int z = b / p.C, c = b - z * p.C;
      bits |= (uint32_t)(bit(zb, z) && bit(cb, c)) << (b - w * 32);
    }
    ws.zcm[w] = bits;
  }
  __syncwarp();
  if (tier == 1) return true;
  if (!p.mv_active && !p.res_active) {
    // ---- the instance types: lanes over T, stop at the first survivor -------
    for (int b = 0; b < T; b += 32) {
      const int t = b + lane;
      const bool ok = t < T && (b == 0 ? its_first : true) && type_ok(p, tb, pa, ws, tier, idx, t);
      if (__any_sync(kFull, ok)) return true;
    }
    return false;
  }
  return eval_types_full(p, tb, pa, ws, tier, idx, its_first);
}

// the pod-only terms of a step (vg_pod_precompute and the rest),
// block-wide: the pod's rows into shared memory (every load issued before
// the stores; its masks straight to value bits), then the terms from
// there, by separate warps
__device__ void pod_phase(const P& p, const Pod& pa, int pod) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int K = p.K, V = p.V, KV = K * V, NGv = p.NGv, NW = words(V);
  const int64_t po = (int64_t)pod * KV, pk = (int64_t)pod * K + tid;
  uint8_t inf = 0, excl = 0, def = 0, allow = 0, tok = 0, vg = 0, vs = 0, hg = 0, hs = 0;
  int32_t gte = 0, lte = 0, conf = 0, vols = 0;
  float req = 0.0f;
  if (tid < K) {
    inf = p.pr.inf[pk];
    excl = p.pr.excl[pk];
    def = p.pr.def[pk];
    gte = p.pr.gte[pk];
    lte = p.pr.lte[pk];
  }
  if (tid < p.R) req = p.requests[(int64_t)pod * p.R + tid];
  if (tid < p.T) allow = p.it_allow[(int64_t)pod * p.T + tid];
  if (tid < p.G) tok = p.tmpl_ok[(int64_t)pod * p.G + tid];
  if (tid < p.NPp) conf = p.port_conf[(int64_t)pod * p.NPp + tid];
  if (tid < p.NVp) vols = p.vols[(int64_t)pod * p.NVp + tid];
  if (tid < NGv) {
    vg = p.vg_applies[(int64_t)pod * NGv + tid];
    vs = p.vg_self[(int64_t)pod * NGv + tid];
  }
  if (tid < p.NGh) {
    hg = p.hg_applies[(int64_t)pod * p.NGh + tid];
    hs = p.hg_self[(int64_t)pod * p.NGh + tid];
  }
  // the pod's mask and its strict mask as value bits: a thread per (key,
  // value) of a K x 32 NW grid, a ballot per (key, word); whole warps
  // enter, as K NW 32 and the block are multiples of 32
  for (int i = tid; i < K * NW * 32; i += nt) {
    const int kw = i >> 5, k = kw / NW, v = (kw - k * NW) * 32 + lane;
    const bool in = v < V;
    const unsigned bp = __ballot_sync(kFull, in && p.pr.mask[po + k * V + v]);
    const unsigned bs = __ballot_sync(kFull, in && p.strict_mask[po + k * V + v]);
    if (lane == 0) {
      pa.pmb[kw] = bp;
      pa.smb[kw] = bs;
    }
  }
  if (tid < K) {
    pa.pinf[tid] = inf;
    pa.pexcl[tid] = excl;
    pa.pdef[tid] = def;
    pa.pgte[tid] = gte;
    pa.plte[tid] = lte;
  }
  if (tid < p.R) pa.req[tid] = req;
  if (tid < p.T) pa.allow[tid] = allow;
  if (tid < p.G) pa.tok[tid] = tok;
  if (tid < p.NPp) pa.pconf[tid] = conf;
  if (tid < p.NVp) pa.pvols[tid] = vols;
  if (tid < NGv) {
    pa.vgate[tid] = vg && pa.vvalid[tid];
    pa.vself[tid] = vs;
  }
  if (tid < p.NGh) {
    pa.hgate[tid] = hg && pa.hvalid[tid];
    pa.hself[tid] = hs;
  }
  // what a thread per element leaves (wider problems)
  for (int k = tid + nt; k < K; k += nt) {
    const int64_t q = (int64_t)pod * K + k;
    pa.pinf[k] = p.pr.inf[q];
    pa.pexcl[k] = p.pr.excl[q];
    pa.pdef[k] = p.pr.def[q];
    pa.pgte[k] = p.pr.gte[q];
    pa.plte[k] = p.pr.lte[q];
  }
  for (int r = tid + nt; r < p.R; r += nt) pa.req[r] = p.requests[(int64_t)pod * p.R + r];
  for (int t = tid + nt; t < p.T; t += nt) pa.allow[t] = p.it_allow[(int64_t)pod * p.T + t];
  for (int g = tid + nt; g < p.G; g += nt) pa.tok[g] = p.tmpl_ok[(int64_t)pod * p.G + g];
  for (int l = tid + nt; l < p.NPp; l += nt) pa.pconf[l] = p.port_conf[(int64_t)pod * p.NPp + l];
  for (int l = tid + nt; l < p.NVp; l += nt) pa.pvols[l] = p.vols[(int64_t)pod * p.NVp + l];
  for (int j = tid + nt; j < NGv; j += nt) {
    pa.vgate[j] = p.vg_applies[(int64_t)pod * NGv + j] && pa.vvalid[j];
    pa.vself[j] = p.vg_self[(int64_t)pod * NGv + j];
  }
  for (int h = tid + nt; h < p.NGh; h += nt) {
    pa.hgate[h] = p.hg_applies[(int64_t)pod * p.NGh + h] && pa.hvalid[h];
    pa.hself[h] = p.hg_self[(int64_t)pod * p.NGh + h];
  }
  if (tid == 0) pa.flags[0] = 0;
  __syncthreads();
  // warps 0..: the vocab-key group terms, a thread per group
  for (int j = tid; j < NGv; j += nt) {
    const int kw = pa.vkey[j] * NW, gv = j * V, gw = j * NW;
    int32_t minc = kBig;
    int supported = 0;
    bool any_pos = false, any_pdpos = false;
    for (int w = 0; w < NW; ++w) {
      uint32_t cz = 0, op = 0;
      for (int v = 32 * w; v < min(V, 32 * w + 32); ++v) {
        const bool dom = bit(pa.domb + gw, v);
        const bool d = bit(pa.smb + kw, v);
        const int32_t c = pa.vgc[gv + v];
        cz |= (uint32_t)(c == 0) << (v & 31);
        op |= (uint32_t)(dom && d && c > 0) << (v & 31);
        if (dom && d) {
          ++supported;
          minc = min(minc, c);
        }
        any_pos |= c > 0;
        any_pdpos |= d && c > 0;
      }
      pa.czerob[gw + w] = cz;
      pa.optsb[gw + w] = op;
    }
    const int32_t mind = pa.vmind[j];
    if (mind > 0 && supported < mind) minc = 0;
    if (minc == kBig) minc = 0;
    const int32_t self_add = pa.vself[j] ? 1 : 0;
    for (int w = 0; w < NW; ++w) {
      uint32_t ok = 0;
      for (int v = 32 * w; v < min(V, 32 * w + 32); ++v) {
        ok |= (uint32_t)((pa.vgc[gv + v] + self_add - minc) <= pa.vskew[j]) << (v & 31);
      }
      pa.okskewb[gw + w] = ok;
    }
    pa.boot[j] = self_add && (!any_pos || !any_pdpos);
  }
  // warp 8: lenient() of the pod's keys, the keys the groups touch
  if (warp == 8 % kWarps)
    for (int k = lane; k < K; k += 32) {
      bool any = false;
      for (int w = 0; w < NW; ++w) any |= pa.pmb[k * NW + w] != 0;
      pa.plen[k] = lenient_of(pa.pdef[k], pa.pinf[k], pa.pexcl[k], any);
      bool t = false;
      for (int j = 0; j < NGv; ++j) t |= pa.vgate[j] && pa.vkey[j] == k;
      pa.touched[k] = t;
    }
  // the last warp: the groups that apply, in order; the pod's volumes
  if (warp == kWarps - 1) {
    int cnt = 0;
    for (int b = 0; b < NGv; b += 32) {
      const int j = b + lane;
      const bool g = j < NGv && pa.vgate[j];
      const unsigned m = __ballot_sync(kFull, g);
      if (g) pa.glist[cnt + __popc(m & ((1u << lane) - 1u))] = j;
      cnt += __popc(m);
    }
    bool v = false;
    for (int l = lane; l < p.NVp; l += 32) v |= pa.pvols[l] != 0;
    v = __any_sync(kFull, v);
    if (lane == 0) {
      pa.flags[2] = cnt;
      pa.flags[0] = v;
    }
  }
  __syncthreads();
}

// the launch-level copies of the small tables (every block, once)
__device__ void launch_phase(const P& p, const Pod& pa) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int V = p.V, NW = words(V);
  for (int i = tid; i < p.NGv * NW; i += nt) {
    const int j = i / NW, w = i - j * NW;
    uint32_t b = 0;
    for (int v = 32 * w; v < min(V, 32 * w + 32); ++v) b |= (uint32_t)(p.vg_domains[j * V + v] != 0) << (v & 31);
    pa.domb[i] = b;
  }
  for (int i = tid; i < p.NGv * V; i += nt) {
    pa.rank[i] = p.vg_rank[i];
    pa.vgc[i] = p.vg_counts[i];
  }
  for (int j = tid; j < p.NGv; j += nt) {
    pa.vkey[j] = p.vg_key[j];
    pa.vtype[j] = p.vg_type[j];
    pa.vskew[j] = p.vg_skew[j];
    pa.vmind[j] = p.vg_mind[j];
    pa.vvalid[j] = p.vg_valid[j];
  }
  for (int r = tid; r < p.RID; r += nt) pa.rescap[r] = p.res_cap[r];
  if (tid == 0) {
    pa.sc[kNOpen] = *p.n_open;
    pa.sc[kWOpen] = *p.w_open;
    pa.sc[kWHw] = *p.w_hw;
    pa.sc[kSpills] = *p.spills;
  }
  for (int k = tid; k < p.K; k += nt) pa.wk[k] = p.well_known[k];
  for (int h = tid; h < p.NGh; h += nt) {
    pa.htype[h] = p.hg_type[h];
    pa.hskew[h] = p.hg_skew[h];
    pa.hvalid[h] = p.hg_valid[h];
  }
  // the valid existing nodes: tier 1 has no row without one
  int nv = 0;
  for (int e = tid; e < p.E; e += nt) nv |= p.exist_valid[e] != 0;
  nv = __syncthreads_or(nv);
  if (tid == 0) pa.flags[3] = nv;
  // a hostname group is nonempty when any slot counts a pod (or pods
  // outside the problem do); counts only grow, the commit keeps it
  for (int h = 0; h < p.NGh; ++h) {
    int any = tid == 0 && p.hg_extra[h];
    for (int s = tid; s < p.Sl && !any; s += nt) any = p.hg_counts[(int64_t)h * p.Sl + s] > 0;
    any = __syncthreads_or(any);
    if (tid == 0) pa.hnonempty[h] = any;
  }
}

// The least key of one tier's feasible rows (kBig when none), block-wide
// and block-uniform; when there is one, *win names the scratch that holds
// its row (warp * 2 + slot). The live rows and their keys go into pa.list
// kThreads at a time, in index order; the first nev warps take them one
// row each, with no barrier between rows: a warp skips a row whose key is not below
// the least key any warp has found so far (pa.flags[1], a hint that may
// lag, so a row is only ever skipped for a real better one). In tiers 1
// and 3 the key is the index, so a tier stops at the first list chunk
// with a feasible row.
template <int kTier>
__device__ int32_t scan_tier(const P& p, const Tabs& tb, const Pod& pa, WS (*ws)[2], int nev, int pod,
                             int32_t* wcount, int32_t* red, int32_t* keep, int* win) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = kTier == 1 ? p.E : (kTier == 2 ? min(pa.sc[kWOpen], p.W) : p.G);
  volatile int32_t* hint = pa.flags + 1;
  int32_t best = kBig;
  int cur = 0, kept = -1;
  if (tid == 0) *hint = kBig;
  for (int base = 0; base < n; base += kThreads) {
    const int c = base + tid;
    const bool live = c < n && row_cheap(p, pa, pod, kTier, c);
    const int32_t key = !live ? kBig : (kTier == 2 ? p.pods[c] * p.W + c : c);
    const unsigned m = __ballot_sync(kFull, live);
    if (lane == 0) wcount[warp] = __popc(m);
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? wcount[w] : 0;
      total += wcount[w];
    }
    if (live) {
      const int at = off + __popc(m & ((1u << lane) - 1u));
      pa.list[at] = c;
      pa.lkey[at] = key;
    }
    __syncthreads();
    for (int i = warp; warp < nev && i < total; i += nev) {
      const int32_t k = pa.lkey[i];
      const int32_t h = __shfl_sync(kFull, lane == 0 ? *hint : 0, 0);
      if (k >= h) {
        if (kTier == 2) continue;
        break;  // keys rise along the list
      }
      if (!eval_row(p, tb, pa, ws[warp][cur], pod, kTier, pa.list[i])) continue;
      if (k < best) {
        best = k;
        kept = cur;
        cur ^= 1;
      }
      if (lane == 0 && k < *hint) *hint = k;
    }
    __syncthreads();
    if (kTier != 2 && *hint < kBig) break;
  }
  if (lane == 0) {
    red[warp] = best;
    keep[warp] = kept;
  }
  __syncthreads();
  int32_t mk = kBig;
  for (int w = 0; w < kWarps; ++w)
    if (red[w] < mk) {
      mk = red[w];
      *win = w * 2 + keep[w];
    }
  __syncthreads();
  return mk;
}

// the block's parameters: in scenario mode, scenario s's block in shared
// memory, every pointer moved by s strides; the single-scenario
// instantiation reads the kernel parameter itself
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

// ---- the bulk asynchronous copy of the staged tables ----------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void stage_tables(const TabArgs& ta, char* dst, uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(1u) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(ta.staged) : "memory");
    for (uint32_t off = 0; off < ta.staged; off += kCopyChunk) {
      const uint32_t n = min(kCopyChunk, ta.staged - off);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
              smem_addr(dst + off)),
          "l"(ta.base + off), "r"(n), "r"(b)
          : "memory");
    }
  }
}

__device__ __forceinline__ void wait_tables(uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(b), "r"(0u)
        : "memory");
}

struct Pick {
  int place, found_e, found, opened, tier, idx, cslot, slot, assign, spilled;
};

// the reference's merge of the three tiers (tier 1 beats tier 2 beats
// tier 3, each its least key)
__device__ __forceinline__ Pick pick(const P& p, const Pod& pa, bool valid, int32_t m1, int32_t m2, int32_t m3) {
  Pick w;
  const int32_t n_open = pa.sc[kNOpen], w_open = pa.sc[kWOpen];
  const bool found_e = m1 < kBig;
  const int pick_e = found_e ? m1 : 0;
  const bool found = !found_e && m2 < kBig;
  const int pk = found ? m2 % p.W : 0;
  const bool any_t = m3 < kBig && valid && !found_e && !found;
  const int g = m3 < kBig ? m3 : 0;  // the first feasible template (index 0 when none is)
  const bool can_open = any_t && w_open < p.W && n_open < p.NCAP;
  w.spilled = any_t && !can_open && n_open < p.NCAP;
  w.place = found_e || found || can_open;
  w.found_e = found_e;
  w.found = found;
  w.opened = can_open && !found;
  w.tier = found_e ? 1 : (found ? 2 : 3);
  w.idx = found_e ? pick_e : (found ? pk : g);
  w.cslot = found ? pk : w_open;
  w.slot = found_e ? pick_e : p.E + (found ? p.slot_of[pk] : n_open);
  w.assign = w.place ? w.slot : (any_t ? kNoRoom : kNoClaim);
  return w;
}

// claim row w's ceiling for resource r from its viable types `row` (in
// shared or device memory), by the calling warp
__device__ void row_ceiling(const P& p, const Tabs& tb, const uint8_t* row, int w, int r) {
  const int lane = threadIdx.x & 31, T = p.T, R = p.R;
  float m = -INFINITY;
  for (int t = lane; t < T; t += 32)
    if (row[t])
      for (int gr = 0; gr < p.GR; ++gr)
        if (tb.gv[gr * T + t]) m = fmaxf(m, tb.alloc[(gr * R + r) * T + t]);
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  if (lane == 0) p.row_max[(int64_t)w * R + r] = m;
}

// the winner's commit, block-wide, from the scratch that holds its row
__device__ void commit(const P& p, const Tabs& tb, const Pod& pa, const WS& ws, int pod, const Pick& w) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int K = p.K, V = p.V, KV = K * V, T = p.T, R = p.R, NW = words(V);
  if (w.tier != 1) {
    // the claim row's viable types: tier 2 narrows its own row in place
    // (each thread reads and writes its own types), tier 3 fills the fresh
    // row; a copy in shared memory for the limits and the ceilings
    uint8_t* out = p.its + (int64_t)w.cslot * T;
    for (int t = tid; t < T; t += nt) {
      const uint8_t ok = type_ok(p, tb, pa, ws, w.tier, w.idx, t);
      out[t] = ok;
      pa.nits[t] = ok;
    }
  }
  __syncthreads();
  const Set& dst = w.tier == 1 ? p.exist_reqs : p.reqs;
  const int drow = w.tier == 1 ? w.idx : w.cslot;
  for (int i = tid; i < KV; i += nt) {
    const int k = i / V;
    dst.mask[(int64_t)drow * KV + i] = bit(ws.cmb + k * NW, i - k * V);
  }
  for (int k = tid; k < K; k += nt) {
    const int64_t dk = (int64_t)drow * K + k;
    dst.inf[dk] = ws.cinf[k];
    dst.excl[dk] = ws.cexcl[k];
    dst.gte[dk] = ws.cgte[k];
    dst.lte[dk] = ws.clte[k];
    dst.def[dk] = ws.cdef[k];
  }
  float* used_row = (w.tier == 1 ? p.exist_used : p.used) + (int64_t)drow * R;
  for (int r = tid; r < R; r += nt) used_row[r] = ws.total[r];
  int32_t* port_row = (w.tier == 1 ? p.exist_ports : p.claim_ports) + (int64_t)drow * p.NPp;
  for (int l = tid; l < p.NPp; l += nt) port_row[l] |= p.ports[(int64_t)pod * p.NPp + l];
  if (w.tier == 1)
    for (int l = tid; l < p.NVp; l += nt)
      p.exist_vols[(int64_t)drow * p.NVp + l] |= p.vols[(int64_t)pod * p.NVp + l];
  // vocab-key counts: the final values of each recording group's key, all
  // of them for anti-affinity, a single value otherwise, never a complement
  for (int j = tid; j < p.NGv; j += nt) {
    const int key = pa.vkey[j];
    int n = 0;
    for (int w = 0; w < NW; ++w) n += __popc(ws.cmb[key * NW + w]);
    const bool rec = p.vg_records[(int64_t)pod * p.NGv + j] && pa.vvalid[j];
    if (rec && !ws.cinf[key] && (pa.vtype[j] == kAnti || n == 1))
      for (int w = 0; w < NW; ++w)
        for (uint32_t c = ws.cmb[key * NW + w]; c; c &= c - 1) pa.vgc[j * V + 32 * w + __ffs(c) - 1] += 1;
  }
  for (int h = tid; h < p.NGh; h += nt)
    if (p.hg_records[(int64_t)pod * p.NGh + h] && pa.hvalid[h]) {
      const int32_t c = p.hg_counts[(int64_t)h * p.Sl + w.slot] + 1;
      p.hg_counts[(int64_t)h * p.Sl + w.slot] = c;
      if (c > 0) pa.hnonempty[h] = 1;  // counts only grow within a scan
    }
  if (w.tier != 1) {
    // the claim's ceilings, and the limits on open: the max capacity over
    // the fresh claim's viable types; one warp per (resource, quantity)
    for (int r = warp; r < R; r += nt / 32) row_ceiling(p, tb, pa.nits, w.cslot, r);
    if (w.opened)
      for (int r = nt / 32 - 1 - warp; r >= 0 && r < R; r += nt / 32) {
        float m = -INFINITY;
        for (int t = lane; t < T; t += 32)
          if (pa.nits[t]) m = fmaxf(m, tb.cap[r * T + t]);
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
        if (lane == 0) p.budget[(int64_t)w.idx * R + r] += -(isfinite(m) ? m : 0.0f);
      }
    if (tid == 0) {
      if (w.opened) {
        p.tmpl[w.cslot] = w.idx;
        p.slot_of[w.cslot] = pa.sc[kNOpen];
        pa.sc[kNOpen] += 1;
        pa.sc[kWOpen] += 1;
      }
      p.open[w.cslot] = 1;
    }
    if (tid == 32) p.pods[w.cslot] += 1;
    if (tid == 64 && w.opened) p.nodes_budget[w.idx] += -1.0f;
    // reserved capacity: the row holds the winner's options; newly held
    // ids take one from the capacity, dropped ones give it back (a fresh
    // claim held none)
    if (p.res_active)
      for (int r = tid; r < p.RID; r += nt) {
        const bool sel = bit(ws.tores, r);
        uint8_t* h = p.held + (int64_t)w.cslot * p.RID + r;
        const bool prev = w.tier == 2 && *h;
        pa.rescap[r] += (int)(prev && !sel) - (int)(sel && !prev);
        *h = sel;
      }
  }
}

template <bool kScen>
__global__ void __launch_bounds__(kThreads, 1)
    perpod_scan_persistent_kernel(const __grid_constant__ PS ps, const __grid_constant__ TabArgs ta, int nev, int lo,
                                  int hi) {
  extern __shared__ __align__(16) char smem[];
  __shared__ P sp;
  __shared__ Tabs tabs;
  __shared__ Pod pod_s;
  __shared__ WS ws_s[kWarps][2];
  __shared__ int32_t wcount[kWarps], red[kWarps], keep[kWarps];
  __shared__ __align__(8) uint64_t bar;
  const P& p = block_params<kScen>(ps, blockIdx.x, &sp);
  const int tid = threadIdx.x;
  char* staged = smem;
  if (tid == 0) {
    carve(smem + ta.staged, p, nev, &pod_s, ws_s);
    const char* src[kTabs];
    for (int f = 0; f < kTabs; ++f)
      src[f] = ta.off[f + 1] <= (int64_t)ta.staged ? staged + ta.off[f] : ta.base + ta.off[f];
    tabs = Tabs{(const uint8_t*)src[kTIts], (const uint8_t*)src[kGv], (const float*)src[kAlloc],
                (const uint32_t*)src[kZc], (const float*)src[kCap], (const uint8_t*)src[kDef],
                (const uint8_t*)src[kInf], (const uint8_t*)src[kExcl], (const uint32_t*)src[kMbits],
                (const int32_t*)src[kGte], (const int32_t*)src[kLte], (const uint32_t*)src[kMv],
                (const uint32_t*)src[kRes]};
  }
  if (ta.staged) stage_tables(ta, staged, &bar);
  __syncthreads();
  const Pod& pa = pod_s;
  const Tabs& tb = tabs;
  launch_phase(p, pa);
  if (ta.staged) wait_tables(&bar);
  __syncthreads();
  for (int i = tid >> 5; i < min(pa.sc[kWOpen], p.W) * p.R; i += kWarps)
    row_ceiling(p, tb, p.its + (int64_t)(i / p.R) * p.T, i / p.R, i % p.R);
  __syncthreads();
  for (int step = lo; step < hi; ++step) {
    const int pod = p.pod_idx ? p.pod_idx[step] : step;
    const bool valid = p.pvalid[step];
    int32_t m1 = kBig, m2 = kBig, m3 = kBig;
    int win = 0;
    if (valid) {
      pod_phase(p, pa, pod);
      if (pa.flags[3]) m1 = scan_tier<1>(p, tb, pa, ws_s, nev, pod, wcount, red, keep, &win);
      if (m1 == kBig) m2 = scan_tier<2>(p, tb, pa, ws_s, nev, pod, wcount, red, keep, &win);
      if (m1 == kBig && m2 == kBig) m3 = scan_tier<3>(p, tb, pa, ws_s, nev, pod, wcount, red, keep, &win);
    }
    const Pick w = pick(p, pa, valid, m1, m2, m3);
    if (w.place) commit(p, tb, pa, ws_s[win / 2][win % 2], pod, w);
    if (tid == 0) {  // after commit's own updates of w_open by this thread
      if (!w.place) pa.sc[kSpills] += w.spilled;
      pa.sc[kWHw] = max(pa.sc[kWHw], pa.sc[kWOpen]);
      p.assignment[step] = w.assign;
    }
    __syncthreads();
  }
  // the carry's counts and scalars back to device memory
  for (int i = tid; i < p.NGv * p.V; i += blockDim.x) p.vg_counts[i] = pa.vgc[i];
  for (int r = tid; r < p.RID; r += blockDim.x) p.res_cap[r] = pa.rescap[r];
  if (tid == 0) {
    *p.n_open = pa.sc[kNOpen];
    *p.w_open = pa.sc[kWOpen];
    *p.w_hw = pa.sc[kWHw];
    *p.spills = pa.sc[kSpills];
  }
}

template <bool kScen>
int launch(const PS& ps, const TabArgs& ta_in, int S, int lo, int hi, cudaStream_t stream) {
  auto* fn = perpod_scan_persistent_kernel<kScen>;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  // the most evaluating warps whose row scratches fit (a wide vocabulary
  // leaves room for fewer), then the longest prefix of the tables that
  // fits beside the workspace
  int nev = kWarps;
  size_t work = carve(nullptr, ps.p, nev, nullptr, nullptr);
  while (nev > 1 && attr.sharedSizeBytes + work > (size_t)kSmemMax)
    work = carve(nullptr, ps.p, --nev, nullptr, nullptr);
  const int64_t budget = (int64_t)kSmemMax - (int64_t)attr.sharedSizeBytes - (int64_t)work;
  if (budget < 0) return (int)cudaErrorInvalidValue;
  TabArgs ta = ta_in;
  ta.staged = 0;
  for (int f = 0; f < kTabs && ta.off[f + 1] <= budget; ++f) ta.staged = (uint32_t)ta.off[f + 1];
  const size_t smem = ta.staged + work;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<S, kThreads, smem, stream>>>(ps, ta, nev, lo, hi);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: a host array of the 82 device pointers in P's field order (pod_idx
// null in the single-scenario entry); dims: E, W, G, T, K, V, R, GR, Z, C,
// NGv, NGh, Sl, NPp, NVp, ND, NCAP, L, zone_kid, ct_kid, J, M, RID, RZ,
// rid_kid, res_vid, mv_active, res_active, res_strict; strides: 82 byte
// strides per scenario, or null for one scenario read in place (S = 1);
// tables: the packed type tables in device memory (16-byte aligned) and
// the byte offset of each of the 13 tables and the total (each 16-byte
// aligned). Runs steps lo .. hi - 1 of every scenario in one launch;
// returns cudaGetLastError() of the launch.
extern "C" int perpod_steps(const int64_t* ptrs, int n_ptrs, const int64_t* dims, const int64_t* strides, int S,
                            const void* tables, const int64_t* table_off, int lo, int hi, void* stream) {
  static_assert(offsetof(P, E) == kPtrs * sizeof(void*), "P: pointers first");
  static_assert(kThreads >= kPtrs + kDims, "block_params needs a thread per field");
  if (n_ptrs != kPtrs || S < 1 || (!strides && S != 1)) return (int)cudaErrorInvalidValue;
  PS ps;
  memset(&ps, 0, sizeof(ps));
  P& p = ps.p;
  memcpy(&p, ptrs, kPtrs * sizeof(void*));
  if (strides) memcpy(ps.stride, strides, kPtrs * sizeof(int64_t));
  int* d = &p.E;
  for (int i = 0; i < kDims; ++i) d[i] = (int)dims[i];
  if (p.K < 1 || p.V < 1 || p.R < 1 || p.NGv < 1 || p.NGh < 1 || p.Z > p.V || p.C > p.V || p.W < 1)
    return (int)cudaErrorInvalidValue;
  if (p.J < 1 || p.M < 1 || p.RID < 1 || p.RZ < 1 || p.RZ > p.V || p.RID > p.V)
    return (int)cudaErrorInvalidValue;
  if (p.res_active && (p.rid_kid < 0 || p.rid_kid >= p.K || p.res_vid < 0 || p.res_vid >= p.V))
    return (int)cudaErrorInvalidValue;
  if (lo < 0 || hi > p.L || lo > hi) return (int)cudaErrorInvalidValue;
  TabArgs ta;
  memset(&ta, 0, sizeof(ta));
  ta.base = (const char*)tables;
  if ((uintptr_t)tables % 16) return (int)cudaErrorInvalidValue;
  for (int f = 0; f <= kTabs; ++f) {
    ta.off[f] = table_off[f];
    if (ta.off[f] % 16 || (f && ta.off[f] < ta.off[f - 1])) return (int)cudaErrorInvalidValue;
  }
  if (lo == hi) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return strides ? launch<true>(ps, ta, S, lo, hi, s) : launch<false>(ps, ta, S, lo, hi, s);
}

// the workspace bytes of a launch with `nev` evaluating warps (dims as
// perpod_steps'), without the staged tables: what ops/cuda.py's
// `perpod_workspace` mirrors
extern "C" int64_t perpod_workspace(const int64_t* dims, int nev) {
  P p;
  memset(&p, 0, sizeof(p));
  int* d = &p.E;
  for (int i = 0; i < kDims; ++i) d[i] = (int)dims[i];
  return (int64_t)carve(nullptr, p, nev, nullptr, nullptr);
}

extern "C" const char* perpod_scan_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
