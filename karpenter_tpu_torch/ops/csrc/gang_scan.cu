// H9 gang_scan — replaces the scan body of the JAX package's
// ops/solver.py `solve_gang` + `_make_gang_step` (solver.py:2657 / 2361),
// with `_claim_fill_caps` (:1355), `_fits_off_counted` (:1333),
// `_cap_res_grid` (:2751), `_kscan_admit` (:2787), `_vg_eval` (:2882) and
// ops/topology.py `hg_evaluate` (:511) inlined.
//
// One launch per gang run, one 256-thread block. The run's B segments
// (one gang each, in rank order) are sequential through n_open, the pool
// budgets, the vocab-key and hostname counts: that chain is the kernel's
// time, so the design keeps everything off it that does not read the
// carry.
//   * Staged once per launch: cap, alloc and group_valid and the
//     offerings with one bulk copy on an mbarrier (arrays not 16-byte
//     aligned are copied by the threads), the offerings packed as one
//     Z x C bitmask per (type, allocatable group); the budgets, the
//     topology groups' constants and their counts' state in shared memory.
//   * Warps 1-7 produce, up to three segments ahead of the walk, each
//     segment's state-free terms for every template g into a ring of
//     slots (shared memory, or device memory when three slots do not
//     fit), handed over by a full / empty mbarrier pair: the fit of one
//     pod over the daemon usage in an offered group as 32-bit words over
//     the types with each word's largest offered cell count
//     (count_cell.cuh), the largest offered count per type, without a
//     key the largest c that fits (maxfit_of: where every request and
//     daemon usage is finite and >= 0, fits_at(c) is c <= that count),
//     under a key each cell's count and the key domains it offers, and
//     the segment's small rows. A segment whose request, gate rows and
//     offering rows equal the one before's copies its terms.
//   * Warp 0 walks the carry, with no block-wide barrier inside the walk:
//     its0 = fit & cap <= budget[g] as words (the cap words are refreshed
//     only when a placement's debit takes template g's budget below the
//     largest cap within them); the template by a vote per template
//     (first index, or lowest rank); f by a warp max; the hostname groups
//     with the blocks over the lanes (a block's counts are fixed at the
//     segment's start); without a key the pod count c_j of a rank block
//     takes two values (f, and the remainder for the last block), so two
//     type rows by ballots and their max caps by a warp max per resource;
//     under a key the vocab-key groups with the groups over the lanes per
//     block, the block's row from the cells' counts at c_j and its domain
//     set, cached by (domain set, c_j); a block that fails spills the
//     whole gang. While segments reuse their terms and template g's cap
//     words stand, f, the two rows and the keyed rows carry over.
//   * The bank rows are written after the walk, by every thread, from the
//     rows' type words and a record per placed row kept in device memory.
// Numerics as the plain loop: the debit is summed in f32 in block order,
// used = __fmaf_rn(c_j, req, daemon) (XLA fuses the reference's
// multiply-add), ties go to the lowest index, the spread rank key is
// formed in uint32 and wraps as the reference's int32 does. The max cap
// of a row orders -0.0 below +0.0 where the plain amax keeps the first of
// two zeros; the debit starts at +0.0, so a zero's sign never reaches a
// budget. Caps are finite capacities: a NaN cap is not supported.
//
// Bound on an H100: a latency chain, not bytes or operations — the
// segments and the rank blocks of a segment are a dependent chain of warp
// collectives and shared-memory reads on one SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "count_cell.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kProducers = kThreads - 32;  // warps 1-7 produce, warp 0 walks
constexpr int kProducerWarps = kProducers / 32;
constexpr int kMaxD = 16;                  // KSCAN_D
constexpr int kMaxZC = 64;                 // the offerings' bitmask
constexpr int kRing = 3;                   // slots of the producers' ring
constexpr int kRowCache = 8;               // type rows a keyed segment keeps
constexpr int32_t kBig = 0x7fffffff;
constexpr uint32_t kRankBase = 1u << 16;
constexpr uint32_t kFull = 0xffffffffu;
constexpr int32_t kNoClaim = -1, kNoRoom = -2, kGangSpill = -3;
constexpr int kSpread = 0, kAffinity = 1, kAnti = 2;
constexpr size_t kSmemMax = 232448;  // a block's shared memory on an H100
constexpr size_t kRingSmem = kSmemMax;  // the shared memory the ring may reach
constexpr uint32_t kCopyChunk = 32768;  // bytes per bulk copy instruction
constexpr int kPtrs = 48;

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
  char* ws;                    // gang_scan_workspace bytes
  int B, G, T, GR, R, Z, C, V, D, NGv, NGh, S, E, NCAP, maxg, TK, tk_idx, has_key, key_is_zone;
};

// byte offsets of every array: the shared memory (`sm_*`), one ring slot
// (`sl_*`, slot s at ring + s * slot) and the device workspace (`ws_*`),
// each array rounded up to 16 bytes
struct Plan {
  int TW, NS, ring_in_smem;
  size_t sm_cap, sm_alloc, sm_valid, sm_zc, sm_zcb, sm_daemon, sm_budget, sm_nbud, sm_capw, sm_capall, sm_capin, sm_admit,
      sm_rank;
  size_t sm_vdom, sm_vrank, sm_vi, sm_hi, sm_hne, sm_vc, sm_vt, sm_its0, sm_rowA, sm_rowB;
  size_t sm_cache, sm_cache_m, sm_misc, sm_bars, sm_ring, smem;
  size_t sl_fitw, sl_fmaxc, sl_cellmax, sl_maxfit, sl_mono, sl_kcnt, sl_kdom, sl_pm, sl_rq, sl_scal, sl_same, sl_gmeta, sl_cbits,
      sl_vg, sl_hg, slot;
  size_t ws_rows, ws_recs, ws_ring, ws;
};

__host__ __device__ inline size_t take(size_t* off, size_t bytes) {
  const size_t r = *off;
  *off += (bytes + 15) & ~(size_t)15;
  return r;
}

__host__ __device__ inline Plan plan(const Gang& p) {
  Plan L;
  const size_t T = p.T, G = p.G, R = p.R, TG = (size_t)p.T * p.GR, NGv = p.NGv, NGh = p.NGh, D = p.D;
  L.TW = (p.T + 31) / 32;
  const size_t TW = L.TW;
  size_t o = 0;
  L.sl_fitw = take(&o, 4 * G * TW);
  L.sl_fmaxc = take(&o, 4 * G * TW);
  L.sl_cellmax = take(&o, 4 * G * T);
  L.sl_maxfit = take(&o, p.has_key ? 0 : 4 * G * T);
  L.sl_mono = take(&o, 4 * G);
  L.sl_kcnt = take(&o, p.has_key ? 4 * G * TG : 0);
  L.sl_kdom = take(&o, p.has_key ? 4 * G * TG : 0);
  L.sl_pm = take(&o, 8 * G);
  L.sl_rq = take(&o, 4 * R);
  L.sl_scal = take(&o, 4 * 4);
  L.sl_same = take(&o, 4);
  L.sl_gmeta = take(&o, 4 * G);
  L.sl_cbits = take(&o, 4 * G);
  L.sl_vg = take(&o, 3 * NGv);
  L.sl_hg = take(&o, 3 * NGh);
  L.slot = o;
  o = 0;
  L.sm_cap = take(&o, 4 * T * R);
  L.sm_alloc = take(&o, 4 * TG * R);
  L.sm_valid = take(&o, TG);
  L.sm_zc = take(&o, TG * p.Z * p.C);
  L.sm_zcb = take(&o, 8 * TG);
  L.sm_daemon = take(&o, 4 * G * R);
  L.sm_budget = take(&o, 4 * G * R);
  L.sm_nbud = take(&o, 4 * G);
  L.sm_capw = take(&o, 4 * G * TW);
  L.sm_capall = take(&o, 4 * G);
  L.sm_capin = take(&o, 4 * G * R);
  L.sm_admit = take(&o, 4 * T);
  L.sm_rank = take(&o, 4 * G);
  L.sm_vdom = take(&o, 4 * NGv);
  L.sm_vrank = take(&o, 4 * NGv * D);
  L.sm_vi = take(&o, 4 * 3 * NGv);
  L.sm_hi = take(&o, 4 * 2 * NGh);
  L.sm_hne = take(&o, 4 * NGh);
  L.sm_vc = take(&o, 4 * NGv * D);
  L.sm_vt = take(&o, 4 * NGv * D);
  L.sm_its0 = take(&o, 4 * TW);
  L.sm_rowA = take(&o, 4 * TW);
  L.sm_rowB = take(&o, 4 * TW);
  L.sm_cache = take(&o, p.has_key ? 4 * kRowCache * TW : 0);
  L.sm_cache_m = take(&o, p.has_key ? 4 * kRowCache * R : 0);
  L.sm_misc = take(&o, 4 * 3 * R + 16);  // the debit, the two rows' max caps; n_open at the end and start, the producers' flag
  L.sm_bars = take(&o, 8 * (1 + 2 * kRing));
  L.NS = kRing;
  L.ring_in_smem = o + kRing * L.slot <= kRingSmem;
  L.sm_ring = take(&o, L.ring_in_smem ? kRing * L.slot : 0);
  L.smem = o;
  o = 0;
  L.ws_rows = take(&o, 4 * (size_t)p.NCAP * TW);
  L.ws_recs = take(&o, 16 * (size_t)p.NCAP);
  L.ws_ring = take(&o, L.ring_in_smem ? 0 : kRing * L.slot);
  L.ws = o;
  return L;
}

// ---- the mbarriers, the bulk copy and the producers' named barrier -------
__device__ __forceinline__ uint32_t smem_addr(const void* ptr) { return (uint32_t)__cvta_generic_to_shared(ptr); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];" : "=l"(state) : "r"(smem_addr(bar)) : "memory");
  (void)state;
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  for (uint32_t off = 0; off < bytes; off += kCopyChunk) {
    const uint32_t n = min(kCopyChunk, bytes - off);
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                     smem_addr(static_cast<char*>(dst) + off)),
                 "l"(static_cast<const char*>(src) + off), "r"(n), "r"(smem_addr(bar))
                 : "memory");
  }
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// the same wait for a warp that waits long and must not take issue slots
// from the walk (a producer waiting for its slot): it sleeps between polls
__device__ __forceinline__ void mbar_wait_idle(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) break;
    __nanosleep(256);
  }
}

// warps 1-7 only: bar.sync 1 over the producers
__device__ __forceinline__ void producers_sync() { asm volatile("bar.sync 1, %0;" ::"r"(kProducers) : "memory"); }
// ---- end of the mbarrier helpers ----------------------------------------

// one array staged into shared memory: by a bulk copy when its source and
// size are 16-byte multiples, else by the threads
struct Piece {
  void* dst;
  const void* src;
  size_t bytes;
  __device__ __forceinline__ bool bulk() const { return bytes && !((((uintptr_t)src) | bytes) & 15); }
};

// bits of a float that order as the float does (-0.0 just below +0.0);
// the map is its own inverse
__device__ __forceinline__ int32_t ord(float x) {
  const int32_t b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float unord(int32_t k) { return __int_as_float(k ^ ((k >> 31) & 0x7fffffff)); }

// a cell's R floats into registers, kN >= R of them (the rest 0)
template <int kN>
__device__ __forceinline__ void load_row(const float* src, int R, float (&v)[kN]) {
#pragma unroll
  for (int r = 0; r < kN; ++r) v[r] = r < R ? src[r] : 0.0f;
}

// count_cell.cuh's count and fit with the operands in registers (kN >= R),
// or read in place (kN = 0, any R)
template <int kN>
__device__ __forceinline__ int32_t count_of(const float* u, const float* q, const float* al, int R) {
  if constexpr (kN == 0) {
    return ktpu::cell_count(u, q, al, R);
  } else {
    float a[kN], b[kN], c[kN];
    load_row(u, R, a);
    load_row(q, R, b);
    load_row(al, R, c);
    return ktpu::cell_count_t<kN>(a, b, c, R);
  }
}

template <int kN>
__device__ __forceinline__ bool fits_of(const float* u, const float* q, const float* al, int R, int c) {
  if constexpr (kN == 0) {
    return ktpu::fits_at(u, q, al, R, c);
  } else {
    float a[kN], b[kN], d[kN];
    load_row(u, R, a);
    load_row(q, R, b);
    load_row(al, R, d);
    return ktpu::fits_at_t<kN>(a, b, d, R, c);
  }
}

// The largest c in [0, kFitCap] with fits_at(c), -1 when c = 0 does not
// fit: exact where the fit is monotone in c, so that fits_at(c) is
// c <= maxfit. It is when every request and daemon usage is finite and
// >= 0: c*q + u is then non-decreasing in c and >= 0, one rounding keeps
// that order, so t <= al and t == 0 each hold for a prefix of the c's, as
// does their OR and the AND over resources. `cnt` (count_cell.cuh's
// +/-1-verified count) seeds the search: fits(cnt) && !fits(cnt + 1) ends
// it at once; otherwise a bisection of fits_at itself.
constexpr int32_t kFitCap = 1 << 23;

template <int kN>
__device__ __forceinline__ int32_t maxfit_of(const float* u, const float* q, const float* al, int R, int32_t cnt) {
  if (!fits_of<kN>(u, q, al, R, 0)) return -1;
  int32_t lo = 0, hi = kFitCap + 1;  // fits(lo); hi does not fit, or is past the cap
  if (cnt > 0 && fits_of<kN>(u, q, al, R, cnt)) {
    if (!fits_of<kN>(u, q, al, R, cnt + 1)) return cnt;
    lo = cnt + 1;
  } else if (cnt > 0) {
    hi = cnt;
  }
  while (hi - lo > 1) {
    const int32_t mid = lo + (hi - lo) / 2;
    if (fits_of<kN>(u, q, al, R, mid))
      lo = mid;
    else
      hi = mid;
  }
  return lo;
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

struct Smem {
  float *cap, *alloc, *daemon, *budget, *nbud, *debit, *mrow, *capin;
  uint8_t *valid, *zc;
  uint64_t* zcb;
  uint32_t *capw, *capall, *admitb, *vdom, *hne, *its0w, *rowA, *rowB, *cache;
  int32_t *rank, *vrank, *vi, *hi, *vc, *vt, *misc;
  float* cache_m;
  uint64_t *stage_bar, *full, *empty;
  char* ring;
};

struct Slot {
  uint32_t* fitw;     // [G, TW] its_base & one pod fits an offered group
  int32_t* fmaxc;     // [G, TW] the largest offered cell count of each word's fitw types
  int32_t* cellmax;   // [G, T] the largest offered cell count
  int32_t* maxfit;    // [G, T] the largest c that fits an offered group (-1: none), runs without a key
  uint32_t* mono;     // [G] the fit is monotone in c: maxfit stands for fits_at
  int32_t* kcnt;      // [G, T, GR] each valid cell's count (0 otherwise), key runs
  uint32_t* kdom;     // [G, T, GR] the key domains the cell offers, key runs
  uint64_t* pm;       // [G] the template's admitted (zone, capacity-type) pairs
  float* rq;          // [R]
  int32_t* scal;      // count, self_conf, key_touched, pd bits
  uint32_t* same;     // the cell terms (fitw ... kdom) are segment b - 1's
  uint32_t* gmeta;    // [G] bit 0 tmpl_base, 1 zinf, 2 zdef; the key row's domains << 16
  uint32_t* cbits;    // [G] the template's admitted capacity types
  uint8_t* vg;        // [3, NGv] gate, records, self
  uint8_t* hg;        // [3, NGh] applies & valid, records & valid, self
};

__device__ __forceinline__ Slot slot_at(const Plan& L, char* ring, int s) {
  char* b = ring + (size_t)s * L.slot;
  return Slot{reinterpret_cast<uint32_t*>(b + L.sl_fitw), reinterpret_cast<int32_t*>(b + L.sl_fmaxc),
              reinterpret_cast<int32_t*>(b + L.sl_cellmax),
              reinterpret_cast<int32_t*>(b + L.sl_maxfit), reinterpret_cast<uint32_t*>(b + L.sl_mono),
              reinterpret_cast<int32_t*>(b + L.sl_kcnt),  reinterpret_cast<uint32_t*>(b + L.sl_kdom),
              reinterpret_cast<uint64_t*>(b + L.sl_pm),   reinterpret_cast<float*>(b + L.sl_rq),
              reinterpret_cast<int32_t*>(b + L.sl_scal),  reinterpret_cast<uint32_t*>(b + L.sl_same),
              reinterpret_cast<uint32_t*>(b + L.sl_gmeta),
              reinterpret_cast<uint32_t*>(b + L.sl_cbits), reinterpret_cast<uint8_t*>(b + L.sl_vg),
              reinterpret_cast<uint8_t*>(b + L.sl_hg)};
}

// ---- the producers ---------------------------------------------------------
// segment b's state-free terms into its slot, for every template
template <int kN>
__device__ void produce(const Gang& p, const Plan& L, const Smem& m, const Slot& sl, int b) {
  const int ptid = threadIdx.x - 32, lane = threadIdx.x & 31, pw = ptid >> 5;
  const int G = p.G, T = p.T, GR = p.GR, R = p.R, D = p.D, TW = L.TW;
  const int32_t count = p.count[b];
  for (int i = ptid; i < R; i += kProducers) sl.rq[i] = p.requests[(int64_t)b * R + i];
  // the small rows: a lane a byte, the bytes loaded together, bits by ballots
  if (pw == 0) {
    const uint32_t pd = __ballot_sync(kFull, p.has_key && lane < D && p.pd[(int64_t)b * D + lane]);
    if (lane == 0) {
      sl.scal[0] = count;
      sl.scal[1] = p.self_conf[b];
      sl.scal[2] = p.key_touched[b];
      sl.scal[3] = (int32_t)pd;
      *sl.same = 0;
    }
  }
  const int ZC = p.Z * p.C;
  for (int g = pw; g < G; g += kProducerWarps) {
    const int64_t bg = (int64_t)b * G + g;
    bool pair[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = lane + 32 * h;
      pair[h] = k < ZC && p.zmask[bg * p.Z + k / p.C] && p.cmask[bg * p.C + k % p.C];
    }
    const uint32_t lo = __ballot_sync(kFull, pair[0]), hi = __ballot_sync(kFull, pair[1]);
    const uint32_t kd = __ballot_sync(kFull, p.has_key && lane < D && p.kmask[bg * p.V + lane]);
    const uint32_t cb = __ballot_sync(kFull, lane < p.C && p.cmask[bg * p.C + lane]);
    if (lane == 0) {
      sl.pm[g] = (uint64_t)lo | (uint64_t)hi << 32;
      sl.gmeta[g] = (p.tmpl_base[bg] ? 1u : 0u) | (p.zinf[bg] ? 2u : 0u) | (p.zdef[bg] ? 4u : 0u) | kd << 16;
      sl.cbits[g] = cb;
    }
  }
  for (int j = ptid; j < p.NGv; j += kProducers) {
    const int64_t x = (int64_t)b * p.NGv + j;
    sl.vg[j] = p.gate[x];
    sl.vg[p.NGv + j] = p.recs[x];
    sl.vg[2 * p.NGv + j] = p.vg_self[x];
  }
  for (int h = ptid; h < p.NGh; h += kProducers) {
    const int64_t x = (int64_t)b * p.NGh + h;
    sl.hg[h] = p.hg_applies[x] && p.hg_valid[h];
    sl.hg[p.NGh + h] = p.hg_rec[x];
    sl.hg[2 * p.NGh + h] = p.hg_self[x];
  }
  producers_sync();  // the pair masks and the request, for every producer
  if (count <= 0) return;  // a padding segment: the walk reads nothing more
  // the cell terms of segment b are those of b - 1 when their inputs are:
  // the request, the template gates per type and the offering rows (a gang
  // storm's segments usually are)
  if (b > 0 && p.count[b - 1] > 0) {
    const int64_t GT = (int64_t)G * T;
    int diff = 0;
    if (!(((uintptr_t)p.its_base | GT) & 15)) {  // the gate rows 16 bytes at a time
      const int4* x = reinterpret_cast<const int4*>(p.its_base + b * GT);
      const int4* y = reinterpret_cast<const int4*>(p.its_base + (b - 1) * GT);
      for (int64_t i = ptid; i < GT / 16; i += kProducers) {
        const int4 u = x[i], v = y[i];
        diff |= (u.x != v.x) | (u.y != v.y) | (u.z != v.z) | (u.w != v.w);
      }
    } else {
      for (int64_t i = ptid; i < GT; i += kProducers) diff |= p.its_base[b * GT + i] != p.its_base[(b - 1) * GT + i];
    }
    for (int i = ptid; i < G * p.Z; i += kProducers)
      diff |= p.zmask[(int64_t)b * G * p.Z + i] != p.zmask[(int64_t)(b - 1) * G * p.Z + i];
    for (int i = ptid; i < G * p.C; i += kProducers)
      diff |= p.cmask[(int64_t)b * G * p.C + i] != p.cmask[(int64_t)(b - 1) * G * p.C + i];
    for (int i = ptid; i < R; i += kProducers)
      diff |= __float_as_int(p.requests[(int64_t)b * R + i]) != __float_as_int(p.requests[(int64_t)(b - 1) * R + i]);
    if (__any_sync(kFull, diff) && lane == 0) atomicOr(reinterpret_cast<unsigned*>(m.misc + 2), 1u);
    producers_sync();
    const bool same = m.misc[2] == 0;
    producers_sync();  // every producer has read the flag
    if (ptid == 0) m.misc[2] = 0;
    if (same) {  // the slot's cell terms, fitw ... kdom, are one 16-byte-aligned run
      const char* prev = m.ring + (size_t)((b - 1) % L.NS) * L.slot;
      char* cur = m.ring + (size_t)(b % L.NS) * L.slot;
      for (size_t i = 16 * (size_t)ptid; i < L.sl_pm - L.sl_fitw; i += 16 * (size_t)kProducers)
        *reinterpret_cast<int4*>(cur + L.sl_fitw + i) = *reinterpret_cast<const int4*>(prev + L.sl_fitw + i);
      if (ptid == 0) *sl.same = 1;
      return;
    }
  }
  const float* rq = sl.rq;
  const uint32_t dall = D >= 32 ? kFull : ((1u << D) - 1u);
  for (int ch = pw; ch < G * TW; ch += kProducerWarps) {
    const int g = ch / TW, k = ch - g * TW, t = k * 32 + lane;
    const float* dg = m.daemon + (int64_t)g * R;
    const uint64_t pm = sl.pm[g];
    bool mono = true;
    for (int r = 0; r < R; ++r) mono = mono && dg[r] >= 0.0f && dg[r] < INFINITY && rq[r] >= 0.0f && rq[r] < INFINITY;
    bool fit = false;
    int32_t cm = 0, mf = -1;
    if (t < T && p.its_base[((int64_t)b * G + g) * T + t]) {
      const uint32_t cbits = sl.cbits[g];
      for (int gr = 0; gr < GR; ++gr) {
        const int cell = t * GR + gr;
        int32_t cnt = 0;
        uint32_t dom = 0;
        if (m.valid[cell]) {
          const float* al = m.alloc + (int64_t)cell * R;
          const uint64_t zc = m.zcb[cell];
          const bool off = (zc & pm) != 0;
          if (off || p.has_key) cnt = count_of<kN>(dg, rq, al, R);
          if (off) {
            cm = max(cm, cnt);
            fit = fit || fits_of<kN>(dg, rq, al, R, 1);
            if (!p.has_key && mono) mf = max(mf, maxfit_of<kN>(dg, rq, al, R, cnt));
          }
          if (p.has_key) {
            if (p.key_is_zone) {
              for (int d = 0; d < D; ++d)
                if ((zc >> (d * p.C)) & cbits) dom |= 1u << d;
            } else {
              dom = off ? dall : 0u;
            }
          }
        }
        if (p.has_key) {
          const int64_t x = ((int64_t)g * T + t) * GR + gr;
          sl.kcnt[x] = cnt;
          sl.kdom[x] = dom;
        }
      }
    }
    if (t < T) {
      sl.cellmax[(int64_t)g * T + t] = cm;
      if (!p.has_key) sl.maxfit[(int64_t)g * T + t] = mf;
    }
    if (k == 0 && lane == 0) sl.mono[g] = mono;
    const uint32_t word = __ballot_sync(kFull, fit);
    const int32_t fmax = __reduce_max_sync(kFull, fit ? cm : 0);
    if (lane == 0) {
      sl.fitw[(int64_t)g * TW + k] = word;
      sl.fmaxc[(int64_t)g * TW + k] = fmax;
    }
  }
}

// ---- the walker ------------------------------------------------------------
// the vocab-key groups of lane-owned group v on the domain set zs against
// the tentative counts (the reference's _vg_eval, one group): the narrowed set
__device__ __forceinline__ uint32_t vg_narrow(const Gang& p, const Smem& m, const Slot& sl, int v, uint32_t zs,
                                              uint32_t pd) {
  const int D = p.D, NGv = p.NGv;
  const int32_t* cnt = m.vt + v * D;
  const int32_t self = sl.vg[2 * NGv + v];
  const uint32_t dom = m.vdom[v];
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
  const int32_t mind = m.vi[2 * NGv + v];
  if (mind > 0 && supported < mind) minc = 0;
  if (minc == kBig) minc = 0;
  const int type = m.vi[v];
  if (type == kSpread) {
    uint32_t okskew = 0;
    int32_t key[kMaxD];
    for (int d = 0; d < D; ++d) {
      const int32_t e = cnt[d] + self;
      if (e - minc <= m.vi[NGv + v]) okskew |= 1u << d;
      key[d] = (int32_t)((uint32_t)e * kRankBase + (uint32_t)m.vrank[v * D + d]);
    }
    return argmin_onehot(dom & zs & okskew, key, D);
  }
  if (type == kAffinity) {
    const uint32_t opts_c = dom & pd & pos & zs;
    const bool boot = self && (pos == 0 || (pd & pos) == 0);
    return opts_c ? opts_c : (boot ? argmin_onehot(dom & pd & zs, m.vrank + v * D, D) : 0u);
  }
  return dom & pd & zs & zero;
}

// the warp's max over the types of `row` (words) of cap[t, r] for every r,
// into out[r] (0 where the row is empty); lane-parallel over the types
__device__ __forceinline__ void row_max(const Gang& p, const Plan& L, const Smem& m, const uint32_t* row,
                                        float* out) {
  const int lane = threadIdx.x & 31, R = p.R;
  for (int r0 = 0; r0 < R; r0 += 4) {
    int32_t k[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) k[i] = ord(-INFINITY);
    for (int kk = 0; kk < L.TW; ++kk) {
      const int t = kk * 32 + lane;
      if (!((row[kk] >> lane) & 1u)) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (r0 + i < R) k[i] = max(k[i], ord(m.cap[(int64_t)t * R + r0 + i]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i >= R) break;
      const float x = unord(__reduce_max_sync(kFull, k[i]));
      if (lane == i) out[r0 + i] = isfinite(x) ? x : 0.0f;
    }
  }
}

// a type row's max caps, folded as the row's types are found (kN >= R:
// each lane's maxima in registers, then a warp max per resource), or by
// row_max over the finished row in shared memory (kN = 0)
template <int kN>
struct CapMax {
  int32_t k[kN > 0 ? kN : 1];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < (kN > 0 ? kN : 1); ++r) k[r] = ord(-INFINITY);
  }
  __device__ __forceinline__ void add(const float* cap, int t, int R) {
    if constexpr (kN > 0) {
      float c[kN];
      if (kN == 4 && R == 4) {  // one 16-byte load: cap rows are 16-byte aligned
        const float4 v = *reinterpret_cast<const float4*>(cap + 4 * (int64_t)t);
        c[0] = v.x, c[1] = v.y, c[2] = v.z, c[kN - 1] = v.w;
      } else {
        load_row(cap + (int64_t)t * R, R, c);
      }
#pragma unroll
      for (int r = 0; r < kN; ++r) k[r] = max(k[r], ord(c[r]));
    }
  }
  // fold another row's maxima in (its types within this row's)
  __device__ __forceinline__ void join(const CapMax& o) {
    if constexpr (kN > 0) {
#pragma unroll
      for (int r = 0; r < kN; ++r) k[r] = max(k[r], o.k[r]);
    }
  }
  // out[r] for r < R, 0 for an empty row; `row` complete in shared memory
  __device__ __forceinline__ void finish(const Gang& p, const Plan& L, const Smem& m, const uint32_t* row,
                                         float* out) {
    if constexpr (kN > 0) {
      const int lane = threadIdx.x & 31;
#pragma unroll
      for (int r = 0; r < kN; ++r) {
        if (r >= p.R) break;
        const float x = unord(__reduce_max_sync(kFull, k[r]));
        if (lane == r) out[r] = isfinite(x) ? x : 0.0f;
      }
    } else {
      row_max(p, L, m, row, out);
    }
  }
};

// the hostname groups of rank block j (lane-parallel over the blocks) at
// slot E + n_open + j, the block's counts as at the segment's start;
// an affinity group is non-empty for j > 0 once block 0 recorded on it
__device__ __forceinline__ bool hg_ok_block(const Gang& p, const Smem& m, const Slot& sl, int32_t n_open, int j) {
  const int NGh = p.NGh;
  const int64_t slot = (int64_t)p.E + n_open + j;
  bool ok = true;
  for (int h = 0; h < NGh && ok; ++h) {
    if (!sl.hg[h]) continue;
    const int32_t c = p.hg_counts[(int64_t)h * p.S + slot];
    const int32_t self = sl.hg[2 * NGh + h];
    const int type = m.hi[h];
    if (type == kSpread) {
      ok = c + self <= m.hi[NGh + h];
    } else if (type == kAffinity) {
      const bool nonempty = m.hne[h] || (j > 0 && sl.hg[NGh + h]);
      ok = c > 0 || (self && !nonempty);
    } else {
      ok = c == 0;
    }
  }
  return ok;
}

// template g's capall flag and capin maxima from its cap words (one warp)
__device__ __forceinline__ void cap_words_meta(const Gang& p, const Plan& L, const Smem& m, int g) {
  const int lane = threadIdx.x & 31, T = p.T, R = p.R, TW = L.TW;
  bool all = true;
  for (int k = 0; k < TW; ++k)
    all = all && m.capw[(int64_t)g * TW + k] == (k < TW - 1 || !(T & 31) ? kFull : (1u << (T & 31)) - 1u);
  for (int r = 0; r < R; ++r) {
    int32_t x = ord(-INFINITY);
    for (int t = lane; t < T; t += 32)
      if ((m.capw[(int64_t)g * TW + (t >> 5)] >> (t & 31)) & 1u) x = max(x, ord(m.cap[(int64_t)t * R + r]));
    x = __reduce_max_sync(kFull, x);
    if (lane == 0) m.capin[(int64_t)g * R + r] = unord(x);
  }
  if (lane == 0) m.capall[g] = all;
}

// does every rank block 0 .. want-1 pass its hostname groups?
__device__ __forceinline__ bool hg_all_blocks(const Gang& p, const Smem& m, const Slot& sl, int32_t n_open,
                                              int want) {
  const int lane = threadIdx.x & 31;
  bool ok = true;
  for (int j0 = 0; j0 < want; j0 += 32) {
    const int j = j0 + lane;
    ok = ok && (j >= want || hg_ok_block(p, m, sl, n_open, j));
  }
  return __all_sync(kFull, ok);
}

template <int kN>
__device__ void walk(const Gang& p, const Plan& L, const Smem& m) {
  const int lane = threadIdx.x & 31;
  const int G = p.G, T = p.T, GR = p.GR, R = p.R, D = p.D, TW = L.TW, NGv = p.NGv, NGh = p.NGh, B = p.B;
  uint32_t* rows_ws = reinterpret_cast<uint32_t*>(p.ws + L.ws_rows);
  int4* recs_ws = reinterpret_cast<int4*>(p.ws + L.ws_recs);
  float* mA = m.mrow;
  float* mB = m.mrow + R;
  int32_t n_open = *p.n_open;
  if (lane == 0) m.misc[1] = n_open;
  // what a segment whose cell terms are the one before's may reuse, while
  // template g's cap words stand: its0w and f (f_g), the two rows and their
  // max caps at (c_A, c_B) (row_g), the keyed rows cached by (zj, c_j)
  // (cache_g, under one key_touched)
  int f_g = -1, row_g = -1, cache_g = -1, n_cache = 0;
  int32_t f_memo = 0, row_cA = 0, row_cB = 0;
  uint32_t row_anyA = 0, row_anyB = 0;
  bool cache_kt = false;
  uint32_t kz[kRowCache];
  int32_t kc[kRowCache];
  for (int b = 0; b < B; ++b) {
    const int s = b % L.NS;
    mbar_wait(&m.full[s], (uint32_t)((b / L.NS) & 1));
    const Slot sl = slot_at(L, m.ring, s);
    const int32_t count = sl.scal[0];
    const bool self_conf = sl.scal[1] != 0, key_touched = sl.scal[2] != 0;
    const uint32_t pd = (uint32_t)sl.scal[3];
    if (!*sl.same) f_g = row_g = cache_g = -1;

    // ---- 1. the slice template: first feasible, or the lowest rank
    int pick = -1;
    int32_t best_rank = kBig;
    for (int g = 0; g < G && count > 0; ++g) {
      if (!(sl.gmeta[g] & 1u) || !(m.nbud[g] >= 1.0f)) continue;
      uint32_t any = 0;
      for (int w = lane; w < TW; w += 32) any |= sl.fitw[(int64_t)g * TW + w] & m.capw[(int64_t)g * TW + w];
      if (!__any_sync(kFull, any != 0)) continue;
      if (!m.rank) {
        pick = g;
        break;
      }
      if (m.rank[g] < best_rank) {
        best_rank = m.rank[g];
        pick = g;
      }
    }
    const int g = pick >= 0 ? pick : 0;
    const bool any_t = pick >= 0 && count > 0;

    // ---- 2. the slice shape on template g
    int32_t f = 0;
    if (any_t && f_g == g) {
      f = f_memo;
    } else if (any_t) {
      for (int w = lane; w < TW; w += 32) m.its0w[w] = sl.fitw[(int64_t)g * TW + w] & m.capw[(int64_t)g * TW + w];
      __syncwarp();
      int32_t best = 0;
      if (m.capall[g]) {  // its0 is fitw: the producers' maxima per word
        for (int w = lane; w < TW; w += 32) best = max(best, sl.fmaxc[(int64_t)g * TW + w]);
      } else {
#pragma unroll 4
        for (int kk = 0; kk < TW; ++kk) {
          const int t = kk * 32 + lane;
          if ((m.its0w[kk] >> lane) & 1u) best = max(best, sl.cellmax[(int64_t)g * T + t]);
        }
      }
      f_memo = __reduce_max_sync(kFull, best);  // f0, before the self-conflict clamp
      f_g = g;
      f = f_memo;
    }
    if (any_t) f = max(self_conf ? min(f, 1) : f, 0);
    const int32_t want = f > 0 ? (count + f - 1) / f : 0;
    const int32_t avail = max(p.NCAP - n_open, 0);
    const bool budget_ok = m.nbud[g] >= (float)want;
    const bool shaped = any_t && f > 0;
    const bool try_place = shaped && want <= avail && budget_ok;
    bool placed = false;

    // ---- 3. the rank blocks: block j holds c_j = f pods, the last the rest
    if (try_place) {
      const int32_t cA = f, cB = count - (want - 1) * f;
      const float* dg = m.daemon + (int64_t)g * R;
      const uint64_t pm = sl.pm[g];
      bool ok = hg_all_blocks(p, m, sl, n_open, want);
      if (!p.has_key && ok && !(row_g == g && row_cA == cA && row_cB == cB)) {
        // two type rows, at c = f and at the remainder, and their max caps
        uint32_t anyA = 0, anyB = 0;
        CapMax<kN> capA, capB;
        capA.init();
        capB.init();
        if (sl.mono[g]) {
          // fits_at(c) is c <= maxfit (maxfit_of), so row A (c = f) lies
          // within row B (c = the remainder <= f): B's own types are folded
          // apart and A's maxima joined to them
          for (int k0 = 0; k0 < TW; k0 += 4) {  // four words' loads in flight at once
            bool bitA[4], bitB[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int kk = k0 + u, t = kk * 32 + lane;
              bitA[u] = bitB[u] = false;
              if (kk >= TW || !((m.its0w[kk] >> lane) & 1u)) continue;
              const int32_t mf = sl.maxfit[(int64_t)g * T + t];
              bitA[u] = cA <= mf;
              bitB[u] = cB <= mf;
              if (bitA[u])
                capA.add(m.cap, t, R);
              else if (bitB[u])
                capB.add(m.cap, t, R);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (k0 + u >= TW) break;
              const uint32_t wA = __ballot_sync(kFull, bitA[u]), wB = __ballot_sync(kFull, bitB[u]);
              if (lane == 0) {
                m.rowA[k0 + u] = wA;
                m.rowB[k0 + u] = wB;
              }
              anyA |= wA;
              anyB |= wB;
            }
          }
          capB.join(capA);
        } else {
          for (int kk = 0; kk < TW; ++kk) {
            const int t = kk * 32 + lane;
            bool bitA = false, bitB = false;
            if ((m.its0w[kk] >> lane) & 1u) {
              for (int gr = 0; gr < GR; ++gr) {
                const int cell = t * GR + gr;
                if (!m.valid[cell] || !(m.zcb[cell] & pm)) continue;
                const float* al = m.alloc + (int64_t)cell * R;
                bitA = bitA || fits_of<kN>(dg, sl.rq, al, R, cA);
                bitB = bitB || fits_of<kN>(dg, sl.rq, al, R, cB);
              }
              if (bitA) capA.add(m.cap, t, R);
              if (bitB) capB.add(m.cap, t, R);
            }
            const uint32_t wA = __ballot_sync(kFull, bitA), wB = __ballot_sync(kFull, bitB);
            if (lane == 0) {
              m.rowA[kk] = wA;
              m.rowB[kk] = wB;
            }
            anyA |= wA;
            anyB |= wB;
          }
        }
        __syncwarp();
        capA.finish(p, L, m, m.rowA, mA);
        capB.finish(p, L, m, m.rowB, mB);
        __syncwarp();
        row_g = g;
        row_cA = cA;
        row_cB = cB;
        row_anyA = anyA;
        row_anyB = anyB;
      }
      if (!p.has_key) {
        ok = ok && (want == 1 || row_anyA != 0) && row_anyB != 0;
        if (ok) {
          for (int r = lane; r < R; r += 32) {
            float d = 0.0f;
            for (int j = 0; j < want; ++j) d = __fadd_rn(d, j < want - 1 ? mA[r] : mB[r]);
            m.debit[r] = d;
          }
          for (int x = lane; x < want * TW; x += 32) {
            const int j = x / TW, w = x - j * TW;
            rows_ws[(int64_t)(n_open + j) * TW + w] = j < want - 1 ? m.rowA[w] : m.rowB[w];
          }
          for (int j = lane; j < want; j += 32) recs_ws[n_open + j] = make_int4(g, j < want - 1 ? cA : cB, b, 0);
          placed = true;
        }
      } else if (ok) {
        // per-domain fit words at both pod counts, and the tentative counts
        const uint32_t z0 = sl.gmeta[g] >> 16;
        const bool win_zinf = ((sl.gmeta[g] >> 1) & 1u) && !key_touched;
        for (int x = lane; x < NGv * D; x += 32) m.vt[x] = m.vc[x];
        for (int r = lane; r < R; r += 32) m.debit[r] = 0.0f;
        __syncwarp();
        if (!(cache_g == g && cache_kt == key_touched)) {
          n_cache = 0;
          cache_g = g;
          cache_kt = key_touched;
        }
        int j = 0;
        for (; j < want; ++j) {
          const int32_t cj = j == want - 1 ? cB : cA;
          // the vocab-key groups on the template's domains, groups over the lanes
          uint32_t upd = kFull;
          bool feasible = true;
          for (int v = lane; v < NGv; v += 32) {
            if (!sl.vg[v]) continue;
            const uint32_t nz = vg_narrow(p, m, sl, v, z0, pd);
            feasible = feasible && nz != 0u;
            upd &= nz;
          }
          const uint32_t zj = z0 & __reduce_and_sync(kFull, upd);
          const bool vg_ok = __all_sync(kFull, feasible);
          // the block's type row and its max caps, cached by (zj, c_j)
          int e = -1;
          for (int i = 0; i < n_cache; ++i)
            if (kz[i] == zj && kc[i] == cj) e = i;
          uint32_t any = 0;
          if (e < 0) {
            e = n_cache < kRowCache ? n_cache++ : kRowCache - 1;
            kz[e] = zj;
            kc[e] = cj;
            uint32_t* row = m.cache + (int64_t)e * TW;
            CapMax<kN> cap;
            cap.init();
            for (int k0 = 0; k0 < TW; k0 += 4) {
              bool bit[4];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int kk = k0 + u, t = kk * 32 + lane;
                bit[u] = kk < TW && ((m.its0w[kk] >> lane) & 1u) && (!key_touched || (m.admitb[t] & zj));
                if (bit[u]) {  // a domain of zj where a cell offers c_j pods
                  uint32_t fd = 0;
                  for (int gr = 0; gr < GR; ++gr) {
                    const int64_t x = ((int64_t)g * T + t) * GR + gr;
                    if (sl.kcnt[x] >= cj) fd |= sl.kdom[x];
                  }
                  bit[u] = (fd & zj) != 0u;
                }
                if (bit[u]) cap.add(m.cap, t, R);
              }
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                if (k0 + u >= TW) break;
                const uint32_t w = __ballot_sync(kFull, bit[u]);
                if (lane == 0) row[k0 + u] = w;
                any |= w;
              }
            }
            __syncwarp();
            cap.finish(p, L, m, row, m.cache_m + (int64_t)e * R);
            __syncwarp();
            if (!any) kc[e] = -1;  // an empty row fails its block: no lookup needs it
          } else {
            const uint32_t* row = m.cache + (int64_t)e * TW;
            for (int w = lane; w < TW; w += 32) any |= row[w];
            any = __reduce_or_sync(kFull, any);
          }
          if (!(vg_ok && any)) break;  // the whole gang spills
          // the block's records land after its add loop: its c_j pods count once
          const bool single = __popc(zj) == 1;
          for (int v = lane; v < NGv; v += 32) {
            if (!sl.vg[NGv + v] || win_zinf || !(m.vi[v] == kAnti || single)) continue;
            for (int d = 0; d < D; ++d)
              if ((zj >> d) & 1u) m.vt[v * D + d] += cj;
          }
          for (int r = lane; r < R; r += 32) m.debit[r] = __fadd_rn(m.debit[r], m.cache_m[(int64_t)e * R + r]);
          for (int w = lane; w < TW; w += 32) rows_ws[(int64_t)(n_open + j) * TW + w] = m.cache[(int64_t)e * TW + w];
          if (lane == 0) recs_ws[n_open + j] = make_int4(g, cj, b, (int32_t)zj);
          __syncwarp();  // the next block may overwrite this block's cache entry
        }
        placed = j == want;
        __syncwarp();
        if (placed)
          for (int x = lane; x < NGv * D; x += 32) m.vc[x] = m.vt[x];
      }
    }

    // ---- 4. all or nothing
    bool refresh = false;
    if (placed) {
      // a type leaves template g's cap words only if the new budget is
      // below the largest cap of the types within them (and a debit never
      // raises a budget: one that does refreshes too)
      for (int r = lane; r < R; r += 32) {
        const float now = __fadd_rn(m.budget[(int64_t)g * R + r], -m.debit[r]);
        refresh = refresh || !(m.debit[r] >= 0.0f) || !(now >= m.capin[(int64_t)g * R + r]);
        m.budget[(int64_t)g * R + r] = now;
      }
      if (lane == 0) m.nbud[g] = m.nbud[g] + -(float)want;
      for (int h = lane; h < NGh; h += 32)
        if (sl.hg[NGh + h]) m.hne[h] = 1u;
      refresh = __any_sync(kFull, refresh);
      __syncwarp();
    }
    if (refresh) {
      // template g's cap words against its new budget
      const float* bud = m.budget + (int64_t)g * R;
      uint32_t moved = 0;
      for (int k0 = 0; k0 < TW; k0 += 4) {
        bool okc[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = (k0 + u) * 32 + lane;
          okc[u] = t < T;
          if constexpr (kN > 0) {
            float c[kN], v[kN];
            load_row(m.cap + (int64_t)min(t, T - 1) * R, R, c);
            load_row(bud, R, v);
#pragma unroll
            for (int r = 0; r < kN; ++r) okc[u] = okc[u] && (r >= R || c[r] <= v[r]);
          } else {
            for (int r = 0; r < R && okc[u]; ++r) okc[u] = m.cap[(int64_t)t * R + r] <= bud[r];
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (k0 + u >= TW) break;
          const uint32_t w = __ballot_sync(kFull, okc[u]);
          moved |= w ^ m.capw[(int64_t)g * TW + k0 + u];
          __syncwarp();
          if (lane == 0) m.capw[(int64_t)g * TW + k0 + u] = w;
        }
      }
      __syncwarp();
      cap_words_meta(p, L, m, g);
      if (moved) {  // its0 changed: what was kept of template g goes
        if (f_g == g) f_g = -1;
        if (row_g == g) row_g = -1;
        if (cache_g == g) cache_g = -1;
      }
    }
    if (lane == 0) {
      p.ys[b] = n_open;
      p.ys[B + b] = placed ? want : 0;
      p.ys[2 * B + b] = f;
      p.ys[3 * B + b] = placed ? g : -1;
      p.ys[4 * B + b] = placed ? 0 : count;
      p.ys[5 * B + b] = (shaped && !budget_ok) || (try_place && !placed) ? kGangSpill : shaped ? kNoRoom : kNoClaim;
    }
    n_open += placed ? want : 0;
    __syncwarp();  // the walker's scratch, written by some lanes, is read by others next
    mbar_arrive(&m.empty[s]);
  }
  if (lane == 0) m.misc[0] = n_open;
}

template <int kN>
__global__ void __launch_bounds__(kThreads, 1) gang_scan_kernel(const __grid_constant__ Gang p, const Plan L) {
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int G = p.G, T = p.T, GR = p.GR, R = p.R, D = p.D, NGv = p.NGv, NGh = p.NGh, TW = L.TW;
  const int TG = T * GR;
  Smem m;
  m.cap = reinterpret_cast<float*>(smem + L.sm_cap);
  m.alloc = reinterpret_cast<float*>(smem + L.sm_alloc);
  m.valid = reinterpret_cast<uint8_t*>(smem + L.sm_valid);
  m.zc = reinterpret_cast<uint8_t*>(smem + L.sm_zc);
  m.zcb = reinterpret_cast<uint64_t*>(smem + L.sm_zcb);
  m.daemon = reinterpret_cast<float*>(smem + L.sm_daemon);
  m.budget = reinterpret_cast<float*>(smem + L.sm_budget);
  m.nbud = reinterpret_cast<float*>(smem + L.sm_nbud);
  m.capw = reinterpret_cast<uint32_t*>(smem + L.sm_capw);
  m.capall = reinterpret_cast<uint32_t*>(smem + L.sm_capall);
  m.capin = reinterpret_cast<float*>(smem + L.sm_capin);
  m.admitb = reinterpret_cast<uint32_t*>(smem + L.sm_admit);
  m.rank = p.rank ? reinterpret_cast<int32_t*>(smem + L.sm_rank) : nullptr;
  m.vdom = reinterpret_cast<uint32_t*>(smem + L.sm_vdom);
  m.vrank = reinterpret_cast<int32_t*>(smem + L.sm_vrank);
  m.vi = reinterpret_cast<int32_t*>(smem + L.sm_vi);
  m.hi = reinterpret_cast<int32_t*>(smem + L.sm_hi);
  m.hne = reinterpret_cast<uint32_t*>(smem + L.sm_hne);
  m.vc = reinterpret_cast<int32_t*>(smem + L.sm_vc);
  m.vt = reinterpret_cast<int32_t*>(smem + L.sm_vt);
  m.its0w = reinterpret_cast<uint32_t*>(smem + L.sm_its0);
  m.rowA = reinterpret_cast<uint32_t*>(smem + L.sm_rowA);
  m.rowB = reinterpret_cast<uint32_t*>(smem + L.sm_rowB);
  m.cache = reinterpret_cast<uint32_t*>(smem + L.sm_cache);
  m.cache_m = reinterpret_cast<float*>(smem + L.sm_cache_m);
  m.debit = reinterpret_cast<float*>(smem + L.sm_misc);
  m.mrow = m.debit + R;
  m.misc = reinterpret_cast<int32_t*>(m.mrow + 2 * R);
  m.stage_bar = reinterpret_cast<uint64_t*>(smem + L.sm_bars);
  m.full = m.stage_bar + 1;
  m.empty = m.full + kRing;
  m.ring = L.ring_in_smem ? smem + L.sm_ring : p.ws + L.ws_ring;

  // ---- staging, once per launch --------------------------------------------
  if (tid == 0) {
    mbar_init(m.stage_bar, 1);
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&m.full[s], kProducers);  // every producer thread releases its own stores
      mbar_init(&m.empty[s], 32);         // every walker lane its own loads
    }
    mbar_fence_init();
  }
  __syncthreads();
  {
    const Piece pieces[4] = {{m.cap, p.cap, 4 * (size_t)T * R},
                             {m.alloc, p.alloc, 4 * (size_t)TG * R},
                             {m.valid, p.group_valid, (size_t)TG},
                             {m.zc, p.zc_avail, (size_t)TG * p.Z * p.C}};
    uint32_t tx = 0;
    for (const Piece& c : pieces) {
      if (c.bulk()) {
        tx += (uint32_t)c.bytes;
      } else {
        for (size_t i = tid; i < c.bytes; i += kThreads)
          static_cast<uint8_t*>(c.dst)[i] = static_cast<const uint8_t*>(c.src)[i];
      }
    }
    if (tid == 0) {
      mbar_arrive_tx(m.stage_bar, tx);
      for (const Piece& c : pieces)
        if (c.bulk()) bulk_copy(c.dst, c.src, (uint32_t)c.bytes, m.stage_bar);
    }
  }
  for (int i = tid; i < G * R; i += kThreads) {
    m.daemon[i] = p.daemon[i];
    m.budget[i] = p.budget[i];
  }
  for (int g = tid; g < G; g += kThreads) {
    m.nbud[g] = p.nodes_budget[g];
    if (m.rank) m.rank[g] = p.rank[g];
  }
  for (int t = tid; t < T; t += kThreads) {
    uint32_t a = 0;
    if (p.has_key)
      for (int d = 0; d < D; ++d)
        if (p.admit[(int64_t)t * D + d]) a |= 1u << d;
    m.admitb[t] = a;
  }
  for (int v = tid; v < NGv; v += kThreads) {
    uint32_t dom = 0;
    for (int d = 0; d < D; ++d) {
      if (p.vg_domains[(int64_t)v * p.V + d]) dom |= 1u << d;
      m.vrank[v * D + d] = p.vg_rank[(int64_t)v * p.V + d];
      m.vc[v * D + d] = p.vg_counts[(int64_t)v * p.V + d];
    }
    m.vdom[v] = dom;
    m.vi[v] = p.vg_type[v];
    m.vi[NGv + v] = p.vg_skew[v];
    m.vi[2 * NGv + v] = p.vg_mind[v];
  }
  if (tid == 0) m.misc[2] = 0;  // the producers' "inputs differ" flag
  for (int h = tid; h < NGh; h += kThreads) {
    m.hi[h] = p.hg_type[h];
    m.hi[NGh + h] = p.hg_skew[h];
    m.hne[h] = p.hg_extra[h] ? 1u : 0u;
  }
  mbar_wait(m.stage_bar, 0);
  __syncthreads();
  // an affinity hostname group is non-empty once any slot holds a count
  // (the walk reads no other group's flag): a warp a group
  for (int h = warp; h < NGh; h += kThreads / 32) {
    if (m.hi[h] != kAffinity) continue;
    const int32_t* c = p.hg_counts + (int64_t)h * p.S;
    int any = 0;
#pragma unroll 8
    for (int x = tid & 31; x < p.S; x += 32) any |= c[x] > 0;
    if (__any_sync(kFull, any) && (tid & 31) == 0) m.hne[h] = 1u;
  }
  for (int cell = tid; cell < TG; cell += kThreads) {
    uint64_t bits = 0;
    const uint8_t* zc = m.zc + (int64_t)cell * p.Z * p.C;
    for (int i = 0; i < p.Z * p.C; ++i)
      if (zc[i]) bits |= 1ull << i;
    m.zcb[cell] = bits;
  }
  for (int x = tid; x < G * TW; x += kThreads) {
    const int g = x / TW, k = x - g * TW;
    uint32_t w = 0;
    for (int i = 0; i < 32; ++i) {
      const int t = k * 32 + i;
      bool ok = t < T;
      for (int r = 0; r < R && ok; ++r) ok = m.cap[(int64_t)t * R + r] <= m.budget[(int64_t)g * R + r];
      if (ok) w |= 1u << i;
    }
    m.capw[x] = w;
  }
  __syncthreads();
  // capall[g]: every type's caps within template g's budget; capin[g, r]:
  // the largest cap[t, r] of the types within it (-inf when none), a warp
  // a template. Only the walk reads them, after its first wait on a full
  // slot, which every producer thread's arrival releases (and warp 0's own
  // are in its program order): no barrier here.
  for (int g = warp; g < G; g += kThreads / 32) cap_words_meta(p, L, m, g);

  // ---- the walk and its producers -----------------------------------------
  if (warp == 0) {
    walk<kN>(p, L, m);
  } else {
    for (int b = 0; b < p.B; ++b) {
      const int s = b % L.NS, k = b / L.NS;
      if (k > 0) mbar_wait_idle(&m.empty[s], (uint32_t)((k - 1) & 1));
      produce<kN>(p, L, m, slot_at(L, m.ring, s), b);
      mbar_arrive(&m.full[s]);
    }
  }
  __syncthreads();

  // ---- the bank rows of the run's placements, then the carry's scalars -----
  const int32_t n0 = m.misc[1], n1 = m.misc[0];
  const uint32_t* rows_ws = reinterpret_cast<const uint32_t*>(p.ws + L.ws_rows);
  const int4* recs_ws = reinterpret_cast<const int4*>(p.ws + L.ws_recs);
  const int64_t nrows = n1 - n0;
  if ((T & 3) == 0 && (((uintptr_t)p.bank_its) & 3) == 0) {
    const int T4 = T / 4;
    for (int64_t x = tid; x < nrows * T4; x += kThreads) {
      const int64_t row = n0 + x / T4;
      const int t = (int)(x % T4) * 4;
      const uint32_t bits = rows_ws[row * TW + (t >> 5)] >> (t & 31);
      reinterpret_cast<uint32_t*>(p.bank_its + row * T)[t >> 2] =
          (bits & 1u) | ((bits >> 1) & 1u) << 8 | ((bits >> 2) & 1u) << 16 | ((bits >> 3) & 1u) << 24;
    }
  } else {
    for (int64_t x = tid; x < nrows * T; x += kThreads) {
      const int64_t row = n0 + x / T;
      const int t = (int)(x % T);
      p.bank_its[row * T + t] = (uint8_t)((rows_ws[row * TW + (t >> 5)] >> (t & 31)) & 1u);
    }
  }
  for (int64_t x = tid; x < nrows * R; x += kThreads) {
    const int64_t row = n0 + x / R;
    const int r = (int)(x % R);
    const int4 rec = recs_ws[row];
    p.bank_used[row * R + r] = __fmaf_rn((float)rec.y, p.requests[(int64_t)rec.z * R + r], p.daemon[(int64_t)rec.x * R + r]);
  }
  for (int64_t row = n0 + tid; row < n1; row += kThreads) {
    const int4 rec = recs_ws[row];
    const int64_t bg = (int64_t)rec.z * G + rec.x;
    p.bank_frozen[row] = 1;
    p.bank_template[row] = rec.x;
    if (p.tk_idx >= 0) {
      const bool kt = p.key_touched[rec.z];
      p.bank_tk_inf[row * p.TK + p.tk_idx] = p.zinf[bg] && !kt;
      p.bank_tk_def[row * p.TK + p.tk_idx] = p.zdef[bg] || kt;
      uint8_t* mask = p.bank_tk_mask + (row * p.TK + p.tk_idx) * p.V;
      for (int v = 0; v < p.V; ++v) mask[v] = v < D ? (uint8_t)(((uint32_t)rec.w >> v) & 1u) : p.kmask[bg * p.V + v];
    }
    for (int h = 0; h < NGh; ++h)
      if (p.hg_rec[(int64_t)rec.z * NGh + h]) p.hg_counts[(int64_t)h * p.S + p.E + row] += rec.y;
  }
  for (int i = tid; i < G * R; i += kThreads) p.budget[i] = m.budget[i];
  for (int g = tid; g < G; g += kThreads) p.nodes_budget[g] = m.nbud[g];
  for (int x = tid; x < NGv * D; x += kThreads) p.vg_counts[(int64_t)(x / D) * p.V + x % D] = m.vc[x];
  if (tid == 0) *p.n_open = n1;
}

void set_dims(Gang* p, const int64_t* dims) {
  int* const fields[] = {&p->B, &p->G, &p->T, &p->GR, &p->R, &p->Z, &p->C, &p->V, &p->D, &p->NGv, &p->NGh, &p->S, &p->E,
                         &p->NCAP, &p->maxg, &p->TK, &p->tk_idx, &p->has_key, &p->key_is_zone};
  for (int i = 0; i < 19; ++i) *fields[i] = (int)dims[i];
}

bool dims_ok(const Gang& p) {
  return p.B >= 1 && p.G >= 1 && p.T >= 1 && p.GR >= 1 && p.R >= 1 && p.D >= 1 && p.D <= kMaxD &&
         p.Z * p.C <= kMaxZC && !(p.has_key && p.key_is_zone && p.D > p.Z) && p.maxg >= 1;
}

}  // namespace

// dims: B, G, T, GR, R, Z, C, V, D, NGv, NGh, S, E, NCAP, maxg, TK, tk_idx,
// has_key, key_is_zone. out[0]: the device workspace's bytes a launch with
// these dims needs; out[1]: its shared memory. The stream is not used.
extern "C" int gang_scan_workspace(const int64_t* dims, int64_t* out, void* stream) {
  (void)stream;
  Gang p;
  memset(&p, 0, sizeof(p));
  set_dims(&p, dims);
  if (!dims_ok(p)) return (int)cudaErrorInvalidValue;
  const Plan L = plan(p);
  out[0] = (int64_t)L.ws;
  out[1] = (int64_t)L.smem;
  return L.smem > kSmemMax ? (int)cudaErrorInvalidValue : (int)cudaSuccess;
}

// ptrs: a host array of the 48 device pointers in Gang's field order (0
// for rank in lexical order; the last, the workspace of
// gang_scan_workspace's bytes); dims as gang_scan_workspace's.
extern "C" int gang_scan(const int64_t* ptrs, int n_ptrs, const int64_t* dims, void* stream) {
  static_assert(offsetof(Gang, B) == kPtrs * sizeof(void*), "Gang: pointers first");
  if (n_ptrs != kPtrs) return (int)cudaErrorInvalidValue;
  Gang p;
  memcpy(&p, ptrs, kPtrs * sizeof(void*));
  set_dims(&p, dims);
  if (!dims_ok(p)) return (int)cudaErrorInvalidValue;
  const Plan L = plan(p);
  if (L.smem > kSmemMax) return (int)cudaErrorInvalidValue;
  // the kernel with the resources in registers: R up to 4, 8 or 16, else read in place
  using Kernel = void (*)(const Gang, const Plan);
  const int v = p.R <= 4 ? 0 : p.R <= 8 ? 1 : p.R <= 16 ? 2 : 3;
  const Kernel kernels[4] = {gang_scan_kernel<4>, gang_scan_kernel<8>, gang_scan_kernel<16>, gang_scan_kernel<0>};
  static bool smem_set[4] = {false, false, false, false};
  if (L.smem > 48 * 1024 && !smem_set[v]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernels[v], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (e != cudaSuccess) return (int)e;
    smem_set[v] = true;
  }
  const Kernel k = kernels[v];
  k<<<1, kThreads, L.smem, (cudaStream_t)stream>>>(p, L);
  return (int)cudaGetLastError();
}

extern "C" const char* gang_scan_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
