// H3 water_fill — replaces the JAX package's ops/solver.py `_water_fill`
// (solver.py:1402): distribute `rem` pods over N claims fewest-pods-first
// with earliest-slot tie-break, in closed form.
//
//   f     = min(f, rem)
//   L     = smallest level with sum(min(f, max(0, L - p))) >= rem, found by
//           exactly 24 bisection steps on [0, max(p) + rem + 1], each mid
//           (lo + hi) >> 1
//   base  = min(f, max(0, L - 1 - p));  r0 = rem - sum(base)
//   elig  = (f > 0) & (p + base == L - 1) & (base < f)
//   fill  = base + (elig & exclusive_rank(elig) < r0)
//   out   = sum(f) <= rem ? f : fill
// All int32 arithmetic wraps in two's complement, as in the reference.
//
// Bound on an H100: reads p and f and writes the result, 48 KB at
// N=4096, about 15 ns of memory time; the bisection's dependent
// block-wide reductions make it latency-bound. Design: one block of 256
// threads.
//  - Up to 4096 rows (the window) a thread takes rows t, t + 256, ..., so
//    every load and store coalesces, and holds them in registers. The first
//    pass gives sum(f) and max(p) in one block fold;
//    with sum(f) <= rem the kernel writes f and ends. A row with f <= 0
//    adds f to every level's sum whatever the level, so the bisection runs
//    over the live rows alone, which each warp compacts among its lanes
//    (ballots and shared memory, no block barrier) and holds in registers,
//    with the other rows' sum added as a constant. A row's placed count is
//    one Hopper DPX instruction, max(min(L + (-p), f), 0).
//  - The bisection runs in rounds of k levels: the 2^k - 1 mids the next k
//    levels can visit follow from (lo, hi) alone, so one pass sums every
//    mid's placed count, one warp reduction (redux.sync) per mid and one
//    barrier fold them over the block, and each thread walks the k levels
//    on the sums (sums mod 2^32 do not depend on their order, and every
//    (lo, hi) is the 24-step bisection's own, so the level equals it for
//    every input, the bisection that stops short of the level included).
//    On the live rows k is 2 (12 rounds): a round's latency, not its sums,
//    bounds the window, and past 2 levels the 2^k sums and their reductions
//    cost about what the rounds they save do.
//  - The final pass: base and eligibility a row, a row's exclusive rank
//    from one ballot a tile of 256 rows (the tiles, the warps before it in
//    its tile, the lanes before it in its warp) and one barrier.
//  - Past 4096 rows a thread owns a contiguous chunk and walks it in device
//    memory every round (k = 5, the last round 4, as each round reads the
//    chunk again); the rank is a chunk-local walk after one block scan.
// Every fold is one barrier: each warp writes its partials, every warp
// reads them all, and a fold's buffer is reused only two folds later.
// `rem` is read from device memory, so the solve never syncs with the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRegRows = 16;                    // a thread's rows in registers
constexpr int kRegCap = kThreads * kRegRows;    // rows held in registers
constexpr int kLevels = 24;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wsub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }

// a row's placed count at level L given -p, in one DPX instruction:
// max(min(L + (-p), f), 0), which is min(f, max(0, L - p)) for f >= 0 and
// 0 for f <= 0 (such a row's f is added to every level as a constant)
__device__ __forceinline__ int placed(int L, int neg_p, int f) { return __viaddmin_s32_relu(L, neg_p, f); }

// the round of K levels from (lo, hi): every mid's placed count over the
// thread's rows — its live rows in registers (kLive: -p in lp, f in lf, ln
// of them) or its chunk [lo_i, hi_i) in device memory — folded over the
// block, then the K levels walked. `red` is this round's [kWarps][32]
// buffer; c0 is added to every sum.
template <int K, bool kLive>
__device__ __forceinline__ void round_levels(const int (&lp)[kRegRows], const int (&lf)[kRegRows], int ln,
                                             const int32_t* __restrict__ p, const int32_t* __restrict__ f_in,
                                             int lo_i, int hi_i, int rem, unsigned c0, unsigned* red, int& lo,
                                             int& hi) {
  constexpr int M = (1 << K) - 1;  // the mids, heap order: node j at index j - 1
  int nlo[M + 1], nhi[M + 1], mids[M + 1];
  nlo[1] = lo;
  nhi[1] = hi;
#pragma unroll
  for (int j = 1; j <= M; ++j) {
    if (j > 1) {
      const int par = j >> 1;
      nlo[j] = (j & 1) ? wadd(mids[par], 1) : nlo[par];
      nhi[j] = (j & 1) ? nhi[par] : mids[par];
    }
    mids[j] = wadd(nlo[j], nhi[j]) >> 1;
  }
  unsigned v[M];
#pragma unroll
  for (int j = 0; j < M; ++j) v[j] = 0u;
  if (kLive) {
#pragma unroll
    for (int r = 0; r < kRegRows; ++r) {
      if (r < ln) {
#pragma unroll
        for (int j = 1; j <= M; ++j) v[j - 1] += (unsigned)placed(mids[j], lp[r], lf[r]);
      }
    }
  } else {
    for (int i = lo_i; i < hi_i; ++i) {
      const int np = wsub(0, p[i]), fi = min(f_in[i], rem);
#pragma unroll
      for (int j = 1; j <= M; ++j) v[j - 1] += (unsigned)placed(mids[j], np, fi);
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < M; ++j) v[j] = __reduce_add_sync(kFull, v[j]);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < M; ++j) red[warp * 32 + j] = v[j];
  }
  __syncthreads();
  unsigned sum = c0;
  if (lane < M) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w * 32 + lane];
  }
  // walk the K levels: lane j - 1 holds node j's sum
  int node = 1;
#pragma unroll
  for (int level = 0; level < K; ++level) {
    const int s = __shfl_sync(kFull, (int)sum, node - 1);
    const int mid = wadd(lo, hi) >> 1;
    if (s >= rem) {
      hi = mid;
      node = 2 * node;
    } else {
      lo = wadd(mid, 1);
      node = 2 * node + 1;
    }
  }
}

// the 24 levels: rounds of 2 on the live rows in registers, of 5 (the last
// 4) on a chunk walk
template <bool kLive>
__device__ __forceinline__ void bisect(const int (&lp)[kRegRows], const int (&lf)[kRegRows], int ln,
                                       const int32_t* __restrict__ p, const int32_t* __restrict__ f_in, int lo_i,
                                       int hi_i, int rem, unsigned c0, unsigned (*red)[kWarps * 32], int& lo,
                                       int& hi) {
  constexpr int K = kLive ? 2 : 5;
  constexpr int kRounds = kLevels / K, kLast = kLevels - kRounds * K;
  int buf = 0;
  for (int r = 0; r < kRounds; ++r, buf ^= 1)
    round_levels<K, kLive>(lp, lf, ln, p, f_in, lo_i, hi_i, rem, c0, red[buf], lo, hi);
  if constexpr (kLast > 0) round_levels<kLast, kLive>(lp, lf, ln, p, f_in, lo_i, hi_i, rem, c0, red[buf], lo, hi);
}

// the block's fold of one record a thread: a, b summed (mod 2^32), c max'd,
// and d's exclusive prefix over the threads in order (returned in d) and
// total (returned in e). `rec` is this fold's [kWarps][4] buffer.
__device__ __forceinline__ void block_fold(unsigned& a, unsigned& b, int& c, int& d, int& e, unsigned* rec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = d;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += n;
  }
  const unsigned wa = __reduce_add_sync(kFull, a), wb = __reduce_add_sync(kFull, b);
  const int wc = __reduce_max_sync(kFull, c);
  if (lane == 31) {
    rec[warp * 4] = wa;
    rec[warp * 4 + 1] = wb;
    rec[warp * 4 + 2] = (unsigned)wc;
    rec[warp * 4 + 3] = (unsigned)incl;
  }
  __syncthreads();
  a = 0u;
  b = 0u;
  c = INT32_MIN;
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    a += rec[w * 4];
    b += rec[w * 4 + 1];
    c = max(c, (int)rec[w * 4 + 2]);
    const int n = (int)rec[w * 4 + 3];
    before += w < warp ? n : 0;
    total += n;
  }
  d = before + incl - d;
  e = total;
}

// N <= kRegCap: row t + kThreads*r of thread t, in registers
__global__ void __launch_bounds__(kThreads) water_fill_rows(const int32_t* __restrict__ p,
                                                            const int32_t* __restrict__ f_in,
                                                            const int32_t* __restrict__ rem_ptr, int N,
                                                            int32_t* __restrict__ out) {
  __shared__ int live_np[kRegCap], live_f[kRegCap];  // per warp, its lanes' live rows
  __shared__ unsigned red[2][kWarps * 32];
  __shared__ unsigned rec[kWarps * 4];
  __shared__ int tiles[kRegRows * kWarps];
  __shared__ unsigned tile_sb[kWarps];
  const int rem = *rem_ptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t lt = (1u << lane) - 1u;
  const int n = (N - (int)threadIdx.x + kThreads - 1) / kThreads;
  // pass 1: sum(f), the sum of the rows with f <= 0 (a constant at every
  // level), max(p)
  unsigned tot = 0u, c0 = 0u;
  int pmax = INT32_MIN, zero = 0, unused_n = 0;
#pragma unroll
  for (int r = 0; r < kRegRows; ++r) {
    if (r < n) {
      const int i = (int)threadIdx.x + r * kThreads;
      const int pi = p[i], fi = min(f_in[i], rem);
      tot += (unsigned)fi;
      c0 += fi <= 0 ? (unsigned)fi : 0u;
      pmax = max(pmax, pi);
    }
  }
  block_fold(tot, c0, pmax, zero, unused_n, rec);
  if ((int)tot <= rem) {
#pragma unroll
    for (int r = 0; r < kRegRows; ++r)
      if (r < n) out[threadIdx.x + r * kThreads] = min(f_in[threadIdx.x + r * kThreads], rem);
    return;
  }
  int pr[kRegRows], fr[kRegRows];
#pragma unroll
  for (int r = 0; r < kRegRows; ++r) {
    pr[r] = fr[r] = 0;
    if (r < n) {
      const int i = (int)threadIdx.x + r * kThreads;
      pr[r] = p[i];
      fr[r] = min(f_in[i], rem);
    }
  }
  // each warp compacts its live rows (-p and f) in shared memory, then
  // lane l takes l, l + 32, ...
  int* wnp = live_np + warp * 32 * kRegRows;
  int* wf = live_f + warp * 32 * kRegRows;
  int c_w = 0;
#pragma unroll
  for (int r = 0; r < kRegRows; ++r) {
    const bool live = r < n && fr[r] > 0;
    const uint32_t m = __ballot_sync(kFull, live);
    if (live) {
      const int at = c_w + __popc(m & lt);
      wnp[at] = wsub(0, pr[r]);
      wf[at] = fr[r];
    }
    c_w += __popc(m);
  }
  __syncwarp();
  int lp[kRegRows], lf[kRegRows], ln = 0;
#pragma unroll
  for (int r = 0; r < kRegRows; ++r) {
    const int j = lane + 32 * r;
    lp[r] = lf[r] = 0;
    if (j < c_w) {
      lp[r] = wnp[j];
      lf[r] = wf[j];
      ++ln;
    }
  }
  int lo = 0, hi = wadd(wadd(pmax, rem), 1);
  bisect<true>(lp, lf, ln, p, f_in, 0, 0, rem, c0, red, lo, hi);
  const int L1 = wsub(lo, 1);

  // base and eligibility; row t + kThreads*r ranks after the eligible rows
  // of tiles before r, of the warps before in tile r, and of the lanes
  // before in the warp
  unsigned sb = 0u;
  uint32_t m[kRegRows];
#pragma unroll
  for (int r = 0; r < kRegRows; ++r) {
    const int base = min(fr[r], max(0, wsub(L1, pr[r])));
    const bool here = r < n;
    sb += here ? (unsigned)base : 0u;
    m[r] = __ballot_sync(kFull, here && fr[r] > 0 && wadd(pr[r], base) == L1 && base < fr[r]);
    if (lane == 0) tiles[r * kWarps + warp] = __popc(m[r]);
  }
  sb = __reduce_add_sync(kFull, sb);
  if (lane == 0) tile_sb[warp] = sb;
  __syncthreads();
  sb = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sb += tile_sb[w];
  const int r0 = wsub(rem, (int)sb);
  // lane r < kRegRows: where this warp's eligible rows of tile r start (the
  // tiles before, then the warps before in tile r)
  int tile = 0, in_tile = 0;
  if (lane < kRegRows) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = tiles[lane * kWarps + w];
      tile += c;
      in_tile += w < warp ? c : 0;
    }
  }
  int incl = tile;
#pragma unroll
  for (int off = 1; off < kRegRows; off <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  const int start = incl - tile + in_tile;
#pragma unroll
  for (int r = 0; r < kRegRows; ++r) {
    const int rank = __shfl_sync(kFull, start, r) + __popc(m[r] & lt);
    if (r < n) {
      const int base = min(fr[r], max(0, wsub(L1, pr[r])));
      out[threadIdx.x + r * kThreads] = wadd(base, (((m[r] >> lane) & 1u) && rank < r0) ? 1 : 0);
    }
  }
}

// N > kRegCap: a contiguous chunk of each thread, read from device memory
__global__ void __launch_bounds__(kThreads) water_fill_chunks(const int32_t* __restrict__ p,
                                                              const int32_t* __restrict__ f_in,
                                                              const int32_t* __restrict__ rem_ptr, int N,
                                                              int32_t* __restrict__ out) {
  __shared__ unsigned red[2][kWarps * 32];
  __shared__ unsigned rec[2][kWarps * 4];
  const int rem = *rem_ptr;
  const int per = (N + kThreads - 1) / kThreads;
  const int lo_i = min(N, (int)threadIdx.x * per);
  const int hi_i = min(N, lo_i + per);
  unsigned tot = 0u, c0 = 0u, unused = 0u;
  int pmax = INT32_MIN, zero = 0, unused_n = 0;
  for (int i = lo_i; i < hi_i; ++i) {
    const int fi = min(f_in[i], rem);
    tot += (unsigned)fi;
    c0 += fi <= 0 ? (unsigned)fi : 0u;
    pmax = max(pmax, p[i]);
  }
  block_fold(tot, c0, pmax, zero, unused_n, rec[0]);
  if ((int)tot <= rem) {
    for (int i = lo_i; i < hi_i; ++i) out[i] = min(f_in[i], rem);
    return;
  }
  int lo = 0, hi = wadd(wadd(pmax, rem), 1);
  int none[kRegRows] = {};
  bisect<false>(none, none, 0, p, f_in, lo_i, hi_i, rem, c0, red, lo, hi);
  const int L1 = wsub(lo, 1);
  unsigned sb = 0u;
  int ne = 0, n_elig = 0, unused_max = 0;
  for (int i = lo_i; i < hi_i; ++i) {
    const int pi = p[i], fi = min(f_in[i], rem);
    const int base = min(fi, max(0, wsub(L1, pi)));
    sb += (unsigned)base;
    ne += (fi > 0 && wadd(pi, base) == L1 && base < fi) ? 1 : 0;
  }
  int rank = ne;
  block_fold(sb, unused, unused_max, rank, n_elig, rec[1]);
  const int r0 = wsub(rem, (int)sb);
  for (int i = lo_i; i < hi_i; ++i) {
    const int pi = p[i], fi = min(f_in[i], rem);
    const int base = min(fi, max(0, wsub(L1, pi)));
    const bool elig = fi > 0 && wadd(pi, base) == L1 && base < fi;
    out[i] = wadd(base, (elig && rank < r0) ? 1 : 0);
    rank += elig ? 1 : 0;
  }
}

}  // namespace

extern "C" int water_fill(const void* p, const void* f, const void* rem, int N, void* out, void* stream) {
  if (N == 0) return 0;
  if (N < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* pp = (const int32_t*)p;
  const int32_t* pf = (const int32_t*)f;
  const int32_t* pr = (const int32_t*)rem;
  int32_t* po = (int32_t*)out;
  void (*const fn)(const int32_t*, const int32_t*, const int32_t*, int, int32_t*) =
      N <= kRegCap ? water_fill_rows : water_fill_chunks;
  fn<<<1, kThreads, 0, s>>>(pp, pf, pr, N, po);
  return (int)cudaGetLastError();
}

extern "C" const char* water_fill_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
