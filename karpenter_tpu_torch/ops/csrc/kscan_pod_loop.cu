// H6 kscan_pod_loop — replaces the pod loop of the JAX package's
// ops/solver.py `_make_kind_step` (solver.py:3093-3223: pod_step under
// lax.while_loop), with `_vg_eval` (:2882), ops/topology.py `hg_evaluate`
// (:511) and `hg_commit` (:531) inlined.
//
// One launch per kind-scan segment, one thread block: the pods of a
// segment place one after another (each pod's choice moves the counts the
// next one reads), so the block loops over the segment's `count` pods.
// Per pod: tier 1 the earliest feasible existing node, tier 2 the
// feasible claim of the window with the least (pods + placed) * W + row,
// tier 3 the first feasible template in the try order (weight order, or
// the rank's: t_order lists the templates by rank, ties to the lowest
// index; 0 when none is feasible); a candidate is feasible when the
// vocab-key groups admit its domain set (a D-bit mask; the spread pick
// keys on eff * 2^16 + rank formed in uint32, the bootstrap on rank, ties
// to the lowest domain), the hostname groups admit its slot and, for a
// claim or template, a domain of the narrowed set has room. Ties go to
// the lowest index everywhere; all integers are int32.
//
// Bound on an H100: a latency chain, not bytes or operations — the pods
// of a segment cannot overlap. Design:
//  - at segment start the block stages the LIVE candidate rows into
//    shared memory as 16-byte records, in order: existing nodes with room
//    (pl_e < cap_e), templates with a static pass and a domain of
//    capacity (in try order), window rows that are open and static or
//    fresh (r in [w_open0, w_open)) with a domain of room. A record holds
//    the domain set and a D-bit room word (bit d: min(capd[r][d],
//    self_conf ? 1 : inf) > placed[r]) so that a claim's fit test is one
//    AND, the tier-2 key or the node's count and cap, the slot, the row
//    and its key-complement bit. Rows at or past w_open are not walked; a
//    claim opened mid-segment is appended (updated in place when it was
//    staged). Past kRowCap records (W up to 8192 and more) the rest live
//    in a device-memory workspace, read in the same pass;
//  - the hostname groups the pod applies become one word per slot (bit h:
//    the count at the slot passes group h's rule, in shared memory up to
//    kSlotCap slots, in the workspace past them), so a slot's test is one
//    OR and compare against the pod's free groups;
//  - the vocab-key groups the pod applies become one 16-byte term each
//    per pod, and a spread pick (or a bootstrap's) one table lookup per
//    nibble of domains: entry [i][v] is the least (key, d) among the
//    domains of nibble i in v;
//  - per pod two barriers (named, over the threads the live rows need,
//    256-1024): after the group terms, every thread walks its live rows and
//    each warp reduces the three tier minima (__reduce_min_sync, the
//    winner's narrowed set as payload); after the reduction, warp 0 folds
//    the warps' picks, commits (counts over D lanes, hostname counts by
//    atomics over NGh lanes, the winner's record, the carry rows in device
//    memory) and computes the next pod's group terms. No device-memory
//    read waits on that chain: a filled claim's room once one more pod
//    lands is kept with its record, and its capacity row and count are
//    read at the commit and used at the next one; a fresh claim's row
//    values are read one open ahead. The shared counts, n_open, w_open and
//    spills go back to device memory at segment end.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxD = 16;        // KSCAN_D
constexpr int kMaxG = 32;        // vocab-key / hostname groups per family
constexpr int kRowCap = 8192;    // live-row records staged in shared memory
constexpr int kSlotCap = 8192;   // hostname slot words staged in shared memory
constexpr int32_t kBig = 0x7fffffff;
constexpr int32_t kRankBase = 1 << 16;
constexpr int32_t kNoRoom = -2;
constexpr int32_t kNoClaim = -1;
constexpr int kSpread = 0, kAffinity = 1, kAnti = 2;
constexpr uint64_t kNone = ~0ull;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kFlag = 0x80000000u;  // a record's key-complement bit
constexpr int64_t kNoDomain = 0x7fffffffffffffffll;

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
  int32_t* ws;                // workspace: records [E+G+W][4], slot words [S], row -> record [W],
                              // next-room words [E+G+W]
  int E, W, G, D, NGv, NGh, S, V, NCAP, count;
};

// a warp's picks: the least record of tiers 1 and 3, tier 2's least (key,
// record), each with its narrowed set (kBig: none)
struct Red {
  int32_t x1, z1, k2, x2, z2, x3, z3;
};

// a gated group's terms for the pod: m is dom & ok-skew (spread), dom &
// pd & count > 0 (affinity) or dom & pd & count == 0 (anti-affinity)
struct GTerm {
  int32_t type;
  uint32_t m;
  uint32_t bootsp;  // dom & pd
  int32_t boot;
};

struct Shared {
  // vocab-key groups j < NGv
  int32_t cnt[kMaxG][kMaxD];
  int32_t rank[kMaxG][kMaxD];
  uint32_t dom[kMaxG];
  int32_t vtype[kMaxG], vself[kMaxG], vrec[kMaxG], vskew[kMaxG], vmind[kMaxG];
  // the gated groups k < ng (group gj[k]), the pod's terms of each, and
  // the argmin of the spread key (eff * 2^16 + rank, per pod) and of the
  // bootstrap rank (per segment) over each nibble of domains: entry
  // [i][v] is key * 16 + d of the least (key, d) among the domains
  // d = 4 i + bit, bit in v (kNoDomain when none)
  int32_t gj[kMaxG];
  int32_t ng;
  GTerm gt[kMaxG];
  int64_t stab[kMaxG][kMaxD / 4][16];
  int64_t btab[kMaxG][kMaxD / 4][16];
  // hostname groups as masks over h < NGh
  int32_t htype[kMaxG], hskew[kMaxG];
  uint32_t hgated, hrec, hself, haff, hnonempty, hfull;
  uint32_t hfree;         // the pod's groups whose test passes at any slot
  int32_t tmpl_ok;        // the hostname groups admit a fresh claim's slot
  uint32_t pd;
  int32_t n_open, w_open, spills, w_open0, self_conf, key_touched;
  int32_t nE, nG, nlive, nact;
  int32_t wcnt[32];
  Red red[32];
};

// the live-row records, their next-room words (a claim's room once one
// more pod lands) and the slot words: shared memory first, the workspace
// past it
struct Store {
  int4* srec;
  int4* grec;
  uint16_t* sroom2;
  int32_t* groom2;
  uint32_t* sok;
  uint32_t* gok;
  int32_t* map;
  __device__ __forceinline__ int4* rec(int i) const { return i < kRowCap ? srec + i : grec + i; }
  __device__ __forceinline__ uint32_t* ok(int s) const { return s < kSlotCap ? sok + s : gok + s; }
  __device__ __forceinline__ uint32_t room2(int i) const { return i < kRowCap ? sroom2[i] : (uint32_t)groom2[i]; }
  __device__ __forceinline__ void set_room2(int i, uint32_t v) const {
    if (i < kRowCap)
      sroom2[i] = (uint16_t)v;
    else
      groom2[i] = (int32_t)v;
  }
};

__device__ __forceinline__ uint32_t load_bits(const uint8_t* row, int D) {
  uint32_t b = 0;
  for (int d = 0; d < D; ++d)
    if (row[d]) b |= 1u << d;
  return b;
}

// the domain of `space` with the least (key, d), from a nibble table; a
// one-hot mask, 0 when space is empty
__device__ __forceinline__ uint32_t tab_argmin(const int64_t (&tab)[kMaxD / 4][16], uint32_t space, int nnib) {
  int64_t best = kNoDomain;
  for (int i = 0; i < nnib; ++i) {
    const uint32_t v = (space >> (4 * i)) & 15u;
    if (v) best = min(best, tab[i][v]);
  }
  return best == kNoDomain ? 0u : 1u << (int)(best & 15);
}

// the table entry [i][v] of keys key(d)
template <class Key>
__device__ __forceinline__ int64_t tab_entry(int i, uint32_t v, int D, Key key) {
  int64_t best = kNoDomain;
  for (int bit = 0; bit < 4; ++bit) {
    const int d = 4 * i + bit;
    if (((v >> bit) & 1u) && d < D) best = min(best, (int64_t)key(d) * 16 + d);
  }
  return best;
}

// the vocab-key groups on a candidate's domain set zs: feasible, and the
// narrowed set zs & the AND of every gated group's choice
__device__ __forceinline__ bool vg_eval(const Shared& sh, uint32_t zs, int nnib, uint32_t* newz) {
  uint32_t upd = zs;
  for (int k = 0; k < sh.ng; ++k) {
    const GTerm g = sh.gt[k];
    uint32_t nar;
    if (g.type == kSpread) {
      nar = tab_argmin(sh.stab[k], g.m & zs, nnib);
    } else if (g.type == kAffinity) {
      const uint32_t oc = g.m & zs;
      nar = oc ? oc : (g.boot ? tab_argmin(sh.btab[k], g.bootsp & zs, nnib) : 0u);
    } else {
      nar = g.m & zs;
    }
    if (!nar) return false;
    upd &= nar;
  }
  *newz = upd;
  return true;
}

__device__ __forceinline__ bool hg_pass(const Shared& sh, const Store& st, int slot, int S, uint32_t hfree) {
  if (!sh.hgated) return true;
  const uint32_t bits = slot < S ? *st.ok(slot) : 0u;
  return ((bits | hfree) & sh.hfull) == sh.hfull;
}

// bit h: the count c at a slot passes gated group h's rule
__device__ __forceinline__ uint32_t hg_bit(const Shared& sh, int h, int32_t c) {
  const bool ok = sh.htype[h] == kSpread ? c + (int32_t)((sh.hself >> h) & 1u) <= sh.hskew[h]
                  : sh.htype[h] == kAffinity ? c > 0
                                             : c == 0;
  return ok ? 1u << h : 0u;
}

// the warp's least (key, x) over the lanes (key kBig: none) and the
// narrowed set z of the lane that holds it
__device__ __forceinline__ void warp_pick(int32_t& key, int32_t& x, int32_t& z) {
  const int32_t km = __reduce_min_sync(kFull, key);
  const int32_t xm = __reduce_min_sync(kFull, key == km ? x : kBig);
  const uint32_t at = __ballot_sync(kFull, key == km && x == xm);
  z = __shfl_sync(kFull, z, __ffs(at) - 1);
  key = km;
  x = xm;
}

// the threads of the pod loop meet here (a named barrier over sh.nact)
__device__ __forceinline__ void pod_sync(int n) { asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory"); }

// warp 0: the pod's group terms from the counts (a lane per gated group),
// the spread groups' argmin tables (a lane per entry), its free hostname
// groups and the fresh claim's slot test
__device__ void pod_terms(Shared& sh, const Store& st, const Loop& p, int lane) {
  const int D = p.D, nnib = (D + 3) / 4;
  if (lane < sh.ng) {
    const int k = lane, j = sh.gj[k];
    const uint32_t in_universe = sh.dom[j] & sh.pd;
    int32_t minc = kBig;
    uint32_t pos = 0, zero = 0;
    for (int d = 0; d < D; ++d) {
      const int32_t c = sh.cnt[j][d];
      if ((in_universe >> d) & 1u) minc = min(minc, c);
      if (c > 0) pos |= 1u << d;
      if (c == 0) zero |= 1u << d;
    }
    if (sh.vmind[j] > 0 && __popc(in_universe) < sh.vmind[j]) minc = 0;
    if (minc == kBig) minc = 0;
    uint32_t okskew = 0;
    for (int d = 0; d < D; ++d)
      if (sh.cnt[j][d] + sh.vself[j] - minc <= sh.vskew[j]) okskew |= 1u << d;
    const int32_t t = sh.vtype[j];
    sh.gt[k].m = t == kSpread ? sh.dom[j] & okskew : t == kAffinity ? sh.dom[j] & sh.pd & pos : sh.dom[j] & sh.pd & zero;
    sh.gt[k].boot = sh.vself[j] && (pos == 0 || (sh.pd & pos) == 0);
  }
  for (int k = 0; k < sh.ng; ++k) {
    const int j = sh.gj[k];
    if (sh.vtype[j] != kSpread) continue;
    // (count + self) * 2^16 + rank in uint32, wrapping past a count of
    // 2^15 - 1 as the reference's int32 arithmetic does
    for (int e = lane; e < nnib * 16; e += 32)
      sh.stab[k][e >> 4][e & 15] = tab_entry(e >> 4, e & 15, D, [&](int d) {
        return (int32_t)((uint32_t)(sh.cnt[j][d] + sh.vself[j]) * (uint32_t)kRankBase + (uint32_t)sh.rank[j][d]);
      });
  }
  if (lane == 0) {
    const uint32_t hfree = ~sh.hgated | (sh.haff & sh.hself & ~sh.hnonempty);
    sh.hfree = hfree;
    sh.tmpl_ok = hg_pass(sh, st, p.E + sh.n_open, p.S, hfree);
  }
  __syncwarp();
}

// block-wide ordered compaction of [0, n): keep(i) rows are written by
// put(i, out) at out = base + their rank; returns base + the count
template <class Keep, class Put>
__device__ int compact(Shared& sh, int n, int base, Keep keep, Put put) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int t0 = 0; t0 < n; t0 += blockDim.x) {
    const int i = t0 + threadIdx.x;
    const bool k = i < n && keep(i);
    const uint32_t m = __ballot_sync(kFull, k);
    if (lane == 0) sh.wcnt[warp] = __popc(m);
    __syncthreads();
    int off = base, tot = base;
    for (int w = 0; w < nw; ++w) {
      if (w < warp) off += sh.wcnt[w];
      tot += sh.wcnt[w];
    }
    if (k) put(i, off + __popc(m & ((1u << lane) - 1u)));
    __syncthreads();
    base = tot;
  }
  return base;
}

__global__ void __launch_bounds__(kThreads) pod_loop_kernel(Loop p) {
  extern __shared__ __align__(16) char smem[];
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = p.D, E = p.E, W = p.W, G = p.G, S = p.S;
  const int nrows = E + G + W;
  Store st;
  // records, then slot words, then next-room words: each 4-byte aligned
  st.srec = reinterpret_cast<int4*>(smem);
  st.sok = reinterpret_cast<uint32_t*>(smem + 16 * (size_t)min(nrows, kRowCap));
  st.sroom2 = reinterpret_cast<uint16_t*>(smem + 16 * (size_t)min(nrows, kRowCap) + 4 * (size_t)min(S, kSlotCap));
  st.grec = reinterpret_cast<int4*>(p.ws);
  st.gok = reinterpret_cast<uint32_t*>(p.ws + 4 * (int64_t)nrows);
  st.map = p.ws + 4 * (int64_t)nrows + S;
  st.groom2 = p.ws + 4 * (int64_t)nrows + S + W;

  // ---- segment constants ----------------------------------------------
  if (tid < p.NGv) {
    const int j = tid;
    sh.dom[j] = load_bits(p.vg_domains + (int64_t)j * p.V, D);
    for (int d = 0; d < D; ++d) {
      sh.rank[j][d] = p.vg_rank[(int64_t)j * p.V + d];
      sh.cnt[j][d] = p.cnt[j * D + d];
    }
    sh.vtype[j] = p.vg_type[j];
    sh.vself[j] = p.vg_self[j];
    sh.vrec[j] = p.recs[j];
    sh.vskew[j] = p.vg_skew[j];
    sh.vmind[j] = p.vg_mind[j];
  }
  if (tid < p.NGh) {
    sh.htype[tid] = p.hg_type[tid];
    sh.hskew[tid] = p.hg_skew[tid];
  }
  if (warp == 0) {
    const bool h = lane < p.NGh;
    const uint32_t gated = __ballot_sync(kFull, h && p.hg_applies[lane] && p.hg_valid[lane]);
    const uint32_t rec = __ballot_sync(kFull, h && p.hg_records[lane] && p.hg_valid[lane]);
    const uint32_t self = __ballot_sync(kFull, h && p.hg_self[lane]);
    const uint32_t aff = __ballot_sync(kFull, h && p.hg_type[lane] == kAffinity);
    const uint32_t extra = __ballot_sync(kFull, h && p.hg_extra[lane]);
    const bool gv = lane < p.NGv && p.gate[lane];
    const uint32_t gm = __ballot_sync(kFull, gv);
    if (gv) sh.gj[__popc(gm & ((1u << lane) - 1u))] = lane;
    if (lane == 0) {
      sh.hgated = gated;
      sh.hrec = rec;
      sh.hself = self;
      sh.haff = aff & gated;
      sh.hnonempty = extra;
      sh.hfull = p.NGh >= 32 ? kFull : (1u << p.NGh) - 1u;
      sh.ng = __popc(gm);
      sh.pd = load_bits(p.pd, D);
      sh.n_open = *p.n_open;
      sh.w_open = *p.w_open;
      sh.spills = *p.spills;
      sh.w_open0 = *p.w_open0;
      sh.self_conf = *p.self_conf;
      sh.key_touched = *p.key_touched;
    }
  }
  for (int r = tid; r < W; r += blockDim.x) st.map[r] = -1;
  __syncthreads();
  const int nnib = (D + 3) / 4;
  for (int k = tid; k < sh.ng; k += blockDim.x) {
    sh.gt[k].type = sh.vtype[sh.gj[k]];
    sh.gt[k].bootsp = sh.dom[sh.gj[k]] & sh.pd;
  }
  for (int e = tid; e < sh.ng * nnib * 16; e += blockDim.x) {
    const int k = e / (nnib * 16), i = (e / 16) % nnib, j = sh.gj[k];
    sh.btab[k][i][e % 16] = tab_entry(i, e % 16, D, [&](int d) { return sh.rank[j][d]; });
  }

  // ---- the slot words of the gated hostname groups -----------------------
  if (sh.hgated) {
    uint32_t pos = 0;
    for (int s = tid; s < S; s += blockDim.x) {
      uint32_t bits = 0;
      for (uint32_t m = sh.hgated; m; m &= m - 1) {
        const int h = __ffs(m) - 1;
        const int32_t c = p.hgc[(int64_t)h * S + s];
        bits |= hg_bit(sh, h, c);
        if (c > 0) pos |= 1u << h;
      }
      *st.ok(s) = bits;
    }
    for (int o = 16; o > 0; o >>= 1) pos |= (uint32_t)__shfl_xor_sync(kFull, (int)pos, o);
    if (lane == 0 && pos) atomicOr(&sh.hnonempty, pos);
  }

  // ---- the live rows: existing nodes, templates, window rows ------------
  const int w_open_start = sh.w_open;
  const bool sc = sh.self_conf;
  const int nE = compact(
      sh, E, 0, [&](int c) { return p.pl_e[c] < p.cap_e[c]; },
      [&](int c, int x) {
        *st.rec(x) = make_int4((int)(load_bits(p.ze + (int64_t)c * D, D) | 0xffff0000u), p.pl_e[c], p.cap_e[c],
                               (int)((uint32_t)c | (p.zie0[c] ? kFlag : 0u)));
      });
  // a claim's domains with room: min(capd, self_conf ? 1 : inf) > placed
  auto room_of = [&](const int32_t* capd, int32_t placed) {
    uint32_t room = 0;
    for (int d = 0; d < D; ++d)
      if ((sc ? min(capd[d], 1) : capd[d]) > placed) room |= 1u << d;
    return room;
  };
  // a template's record: its domains with capacity, and (y) the room of a
  // claim it opens once one and two pods have landed
  const int nEG = compact(
      sh, G, nE,
      [&](int pos) {
        const int g = p.t_order ? p.t_order[pos] : pos;
        return p.static_g[g] && room_of(p.capd_g + (int64_t)g * D, 0) != 0;
      },
      [&](int pos, int x) {
        const int g = p.t_order ? p.t_order[pos] : pos;
        const int32_t* cg = p.capd_g + (int64_t)g * D;
        uint32_t cap = 0;
        for (int d = 0; d < D; ++d)
          if (cg[d] >= 1) cap |= 1u << d;
        *st.rec(x) = make_int4((int)(load_bits(p.z0_g + (int64_t)g * D, D) | (cap << 16)),
                               (int)(room_of(cg, 1) | (room_of(cg, 2) << 16)),
                               (int)((uint32_t)g | (p.zinf_g[g] ? kFlag : 0u)), 0);
      });
  const int nlive = compact(
      sh, W, nEG,
      [&](int r) {
        const bool fresh = r >= sh.w_open0 && r < w_open_start;
        return (p.open0[r] || fresh) && (p.static_n0[r] || fresh) && room_of(p.capd + (int64_t)r * D, p.pl_n[r]) != 0;
      },
      [&](int r, int x) {
        const int32_t placed = p.pl_n[r];
        const int32_t* cr = p.capd + (int64_t)r * D;
        *st.rec(x) = make_int4(
            (int)(load_bits(p.zn + (int64_t)r * D, D) | (room_of(cr, placed) << 16)),
            (int32_t)((uint32_t)(p.pods0[r] + placed) * (uint32_t)W + (uint32_t)r), E + p.slot_of[r],
            (int)((uint32_t)r | (p.zin0[r] ? kFlag : 0u)));
        st.set_room2(x, room_of(cr, placed + 1));
        st.map[r] = x;
      });
  if (tid == 0) {
    sh.nE = nE;
    sh.nG = nEG - nE;
    sh.nlive = nlive;
    // threads for the rows that can be live: two rows a thread, 256-1024
    const int most = nlive + min(p.count, max(0, W - w_open_start));
    sh.nact = min((int)blockDim.x, max(256, (most / 2 + 31) / 32 * 32));
  }
  __syncthreads();
  const int nact = sh.nact;
  if (tid >= nact) return;
  // warp 0 carries across pods: the next claim row's values, read one pod
  // ahead (lane 0 pl_n, 1 pods0, 2 open0, 3 static_n0, 4 zin0, 5 its
  // record), and the last commit's device-memory reads, used at the next
  // pod's commit (lane d: the claim's capacity in domain d; lane 0: its
  // pl_n before the commit)
  int32_t nxt = 0, pend_cap = 0, pend_pl = 0;
  int pend = 0, pend_r = 0, pend_x = 0;  // pend: 1 a claim filled, 2 a claim opened
  auto prefetch = [&](int r) {
    if (r >= W) return;
    nxt = lane == 0 ? p.pl_n[r] : lane == 1 ? p.pods0[r] : lane == 2 ? p.open0[r] : lane == 3 ? p.static_n0[r]
        : lane == 4 ? p.zin0[r] : lane == 5 ? st.map[r] : 0;
  };
  if (warp == 0) {
    prefetch(w_open_start);
    pod_terms(sh, st, p, lane);
  }
  pod_sync(nact);

  for (int i = 0; i < p.count; ++i) {
    // ---- one pass over the live rows ------------------------------------
    const int n1 = sh.nE, n3 = sh.nE + sh.nG, n2 = sh.nlive;
    const uint32_t hfree = sh.hfree;
    int32_t x1 = kBig, z1 = 0, k2 = kBig, x2 = kBig, z2 = 0, x3 = kBig, z3 = 0;
    for (int x = tid; x < n1; x += nact) {
      const int4 r = *st.rec(x);
      uint32_t nz;
      if (!(r.x >> 16) || !hg_pass(sh, st, (int)((uint32_t)r.w & ~kFlag), S, hfree)) continue;
      if (!vg_eval(sh, (uint32_t)r.x & 0xffffu, nnib, &nz)) continue;
      x1 = x;
      z1 = (int32_t)nz;
      break;  // this thread's rows come in index order
    }
    if (sh.tmpl_ok) {
      for (int x = n1 + tid; x < n3; x += nact) {
        const int4 r = *st.rec(x);
        uint32_t nz;
        if (!vg_eval(sh, (uint32_t)r.x & 0xffffu, nnib, &nz) || !(nz & ((uint32_t)r.x >> 16))) continue;
        x3 = x;
        z3 = (int32_t)nz;
        break;
      }
    }
    for (int x = n3 + tid; x < n2; x += nact) {
      const int4 r = *st.rec(x);
      const uint32_t room = (uint32_t)r.x >> 16;
      uint32_t nz;
      if (!room || !hg_pass(sh, st, r.z, S, hfree)) continue;
      if (!vg_eval(sh, (uint32_t)r.x & 0xffffu, nnib, &nz) || !(nz & room)) continue;
      if (x2 == kBig || r.y < k2) {  // keys are distinct
        k2 = r.y;
        x2 = x;
        z2 = (int32_t)nz;
      }
    }
    if (__any_sync(kFull, (x1 & x2 & x3) != kBig)) {
      int32_t one = 0;
      warp_pick(x1, one, z1);
      warp_pick(k2, x2, z2);
      warp_pick(x3, one, z3);
    }
    if (lane == 0) sh.red[warp] = Red{x1, z1, k2, x2, z2, x3, z3};
    pod_sync(nact);

    // ---- warp 0: the last commit's reads, the picks, the commit, the next
    // pod's terms ------------------------------------------------------------
    if (warp == 0) {
      if (pend) {
        const int32_t placed = __shfl_sync(kFull, pend_pl, 0) + 1;
        if (lane == 0) p.pl_n[pend_r] = placed;
        if (pend == 1) {
          const uint32_t room2 = __ballot_sync(kFull, lane < D && (sc ? min(pend_cap, 1) : pend_cap) > placed + 1);
          if (lane == 0) st.set_room2(pend_x, room2);
        } else if (lane < D) {
          p.capd[(int64_t)pend_r * D + lane] = pend_cap;
        }
        pend = 0;
      }
      const int nw = nact >> 5;
      const Red rw = lane < nw ? sh.red[lane] : Red{kBig, 0, kBig, kBig, 0, kBig, 0};
      int32_t one = 0;
      x1 = rw.x1, z1 = rw.z1, k2 = rw.k2, x2 = rw.x2, z2 = rw.z2, x3 = rw.x3, z3 = rw.z3;
      warp_pick(x1, one, z1);
      warp_pick(k2, x2, z2);
      warp_pick(x3, one, z3);
      const int n_open = sh.n_open, w_open = sh.w_open;
      const bool found_e = x1 != kBig;
      const bool found = !found_e && x2 != kBig;
      const bool any_tf = x3 != kBig;
      const int4 r1 = found_e ? *st.rec(x1) : make_int4(0, 0, 0, 0);
      const int4 r2 = found ? *st.rec(x2) : make_int4(0, 0, 0, 0);
      const int4 r3 = any_tf ? *st.rec(x3) : make_int4(0, 0, 0, 0);
      const int pick_e = (int)((uint32_t)r1.w & ~kFlag);
      const int pick = (int)((uint32_t)r2.w & ~kFlag);
      const int g = (int)((uint32_t)r3.z & ~kFlag);
      const bool any_t = any_tf && !found_e && !found;
      const bool can_open = any_t && w_open < W && n_open < p.NCAP;
      const bool spilled = any_t && !can_open && n_open < p.NCAP;
      const bool place = found_e || found || can_open;
      const int cslot = found ? pick : w_open;
      const int slot = found_e ? pick_e : (found ? r2.z : E + n_open);
      if (lane == 0) p.assignment[i] = place ? slot : (any_t ? kNoRoom : kNoClaim);
      if (place) {
        const uint32_t win_z = (uint32_t)(found_e ? z1 : found ? z2 : z3);
        const uint32_t zflag = found_e ? (uint32_t)r1.w : found ? (uint32_t)r2.w : (uint32_t)r3.z;
        const bool win_zinf = (zflag & kFlag) && !sh.key_touched;
        const bool single = __popc(win_z) == 1;
        // hostname counts: only a gated spread group's new count is read back
        const bool hrec = lane < p.NGh && ((sh.hrec >> lane) & 1u);
        const bool hread = hrec && ((sh.hgated >> lane) & 1u) && sh.htype[lane] == kSpread;
        int32_t newc = 0;
        if (hread)
          newc = atomicAdd(&p.hgc[(int64_t)lane * S + slot], 1) + 1;
        else if (hrec)
          atomicAdd(&p.hgc[(int64_t)lane * S + slot], 1);
        for (int pp = lane; pp < p.NGv * D; pp += 32) {
          const int j = pp / D, d = pp - j * D;
          if (sh.vrec[j] && !win_zinf && (sh.vtype[j] == kAnti || single) && ((win_z >> d) & 1u)) sh.cnt[j][d] += 1;
        }
        const uint32_t gr = sh.hgated & sh.hrec;
        const uint32_t nb = __ballot_sync(kFull, hrec && ((gr >> lane) & 1u) &&
                                                     hg_bit(sh, lane, hread ? newc : 1));
        if (lane == 0) {
          if (gr && slot < S) *st.ok(slot) = (*st.ok(slot) & ~gr) | nb;
          sh.hnonempty |= sh.hrec;
        }
        uint8_t* zrow = found_e ? p.ze + (int64_t)pick_e * D : p.zn + (int64_t)cslot * D;
        if (lane < D) zrow[lane] = (win_z >> lane) & 1u;
        if (found_e) {
          if (lane == 0) {
            const int32_t placed = r1.y + 1;
            p.pl_e[pick_e] = placed;
            *st.rec(x1) = make_int4((int)(win_z | (placed < r1.z ? 0xffff0000u : 0u)), placed, r1.z, r1.w);
          }
        } else if (found) {
          // the room once this pod lands was read one pod ahead; the reads
          // for the next one go out now and are used at the next commit
          if (lane == 0)
            *st.rec(x2) = make_int4((int)(win_z | (st.room2(x2) << 16)), (int32_t)((uint32_t)r2.y + (uint32_t)W),
                                    r2.z, r2.w);
          if (lane < D) pend_cap = p.capd[(int64_t)pick * D + lane];
          if (lane == 0) pend_pl = p.pl_n[pick];
          pend = 1;
          pend_r = pick;
          pend_x = x2;
        } else {
          // a fresh claim at row w_open, its values read one pod ahead
          int32_t pl0 = __shfl_sync(kFull, nxt, 0);
          const int32_t pods0 = __shfl_sync(kFull, nxt, 1), open0 = __shfl_sync(kFull, nxt, 2);
          const int32_t static0 = __shfl_sync(kFull, nxt, 3), zin0 = __shfl_sync(kFull, nxt, 4);
          const int32_t at = __shfl_sync(kFull, nxt, 5);
          const int32_t* cg = p.capd_g + (int64_t)g * D;
          if (lane < D) pend_cap = cg[lane];
          uint32_t room = (uint32_t)r3.y & 0xffffu, room2 = (uint32_t)r3.y >> 16;
          if (at >= 0) pl0 = p.pl_n[cslot];  // a staged row: its count may have moved
          if (pl0 != 0) {
            const int32_t lim = sc ? min(pend_cap, 1) : pend_cap;
            room = __ballot_sync(kFull, lane < D && lim > pl0 + 1);
            room2 = __ballot_sync(kFull, lane < D && lim > pl0 + 2);
          }
          if (lane == 0) {
            p.tmpl_n[cslot] = g;
            p.slot_of[cslot] = n_open;
            const int4 nr = make_int4((int)(win_z | (room << 16)),
                                      (int32_t)((uint32_t)(pods0 + pl0 + 1) * (uint32_t)W + (uint32_t)cslot),
                                      E + n_open, (int)((uint32_t)cslot | (zin0 ? kFlag : 0u)));
            const bool fresh = cslot >= sh.w_open0;
            int into = at;
            if (into < 0 && (open0 || fresh) && (static0 || fresh)) {
              into = sh.nlive;
              st.map[cslot] = into;
              sh.nlive += 1;
            }
            if (into >= 0) {
              *st.rec(into) = nr;
              st.set_room2(into, room2);
            }
            sh.n_open = n_open + 1;
            sh.w_open = w_open + 1;
          }
          pend_pl = pl0;
          pend = 2;
          pend_r = cslot;
          prefetch(w_open + 1);
        }
      }
      if (lane == 0 && spilled) sh.spills += 1;
      __syncwarp();
      if (i + 1 < p.count) pod_terms(sh, st, p, lane);
    }
    pod_sync(nact);
  }
  // ---- write back the shared carry --------------------------------------
  if (warp == 0) {
    if (pend) {
      const int32_t placed = __shfl_sync(kFull, pend_pl, 0) + 1;
      if (lane == 0) p.pl_n[pend_r] = placed;
      if (pend == 2 && lane < D) p.capd[(int64_t)pend_r * D + lane] = pend_cap;
    }
    for (int pp = lane; pp < p.NGv * D; pp += 32) p.cnt[pp] = sh.cnt[pp / D][pp % D];
    if (lane == 0) {
      *p.n_open = sh.n_open;
      *p.w_open = sh.w_open;
      *p.spills = sh.spills;
    }
  }
}

bool g_opted = false;

}  // namespace

// ptrs: a host array of the 44 device pointers in Loop's field order
// (t_order null for weight order; ws the int32 workspace of
// 5 (E + G + W) + S + W entries); dims: E, W, G, D, NGv, NGh, S, V, NCAP,
// count.
extern "C" int kscan_pod_loop(const int64_t* ptrs, int n_ptrs, const int64_t* dims, void* stream) {
  constexpr int kPtrs = 44;
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
  const size_t smem = 18 * (size_t)min(p.E + p.G + p.W, kRowCap) + 4 * (size_t)min(p.S, kSlotCap);
  if (!g_opted) {
    const cudaError_t e = cudaFuncSetAttribute(pod_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               18 * kRowCap + 4 * kSlotCap);
    if (e != cudaSuccess) return (int)e;
    g_opted = true;
  }
  pod_loop_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* kscan_pod_loop_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
