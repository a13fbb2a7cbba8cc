// H10 retract_tail — replaces the JAX package's ops/solver.py `retract_tail`
// (solver.py:897-945), the resident session's suffix undo: every claim with
// a global id at or past `cut` goes away.
//
// One launch, out of place (the input state stays intact: a resident
// session's state must not alias the next base solve's):
//   window blocks: a row is alive when open[i] && slot_of[i] < cut. Each
//           block reduces the alive flags of the whole window (the count
//           before its rows and the total), scans its own rows with warp
//           ballots, moves every alive source row of every window column
//           (the six requirement components, used, its, template, open,
//           pods, slot_of, claim_ports, held) to its stable-compacted
//           position, and writes the unused-row value (identity
//           requirements, zeros, the NCAP sentinel in slot_of) into its
//           destination rows at or past the total. Each destination row
//           has exactly one writer: the compaction is a bijection from
//           the alive rows onto [0, total). A (column, row) pair is one
//           thread's task; neighbouring threads take neighbouring rows of
//           one column.
//   bank blocks: bank rows below `cut` are copied, rows at or past it
//           cleared (bank_frozen, bank_template, bank_its, bank_used,
//           bank_held, bank_tk_mask / inf / def).
//   block 0 also writes n_open = cut and w_open = total; w_hw and spills
//   are the caller's and do not change.
// There is no arithmetic: the kernel only moves bytes, and the
// compaction is stable, so no tie arises.
//
// Bound on an H100: bytes — the window rows read and written once and the
// bank rows at or past the cut cleared (about 2 x 2.3 MB and 1 MB for the
// resident cells' W = NB = 8192 rows at T = 100), under 2 us at
// 3.35 TB/s. Design: each thread moves whole rows in the widest word
// (16, 4 or 1 bytes) that the row length and both addresses allow; the
// per-block reduction of the alive flags reads W x 5 bytes from L2. A
// first version walked a block's rows one at a time with all its threads
// on each (short) row: 0.23 ms a launch on an H100 at W = 8192.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWin = 16;
constexpr int kMaxBank = 12;
constexpr int kThreads = 256;
constexpr int kRows = 64;       // window rows per block (two warps' ballots)
constexpr int kBankRows = 64;   // bank rows per block

struct Params {
  const uint8_t* src[kMaxWin];
  uint8_t* dst[kMaxWin];
  int64_t row_bytes[kMaxWin];
  uint32_t fill[kMaxWin];  // the unused-row value, a 4-byte pattern
  const uint8_t* bsrc[kMaxBank];
  uint8_t* bdst[kMaxBank];
  int64_t brow_bytes[kMaxBank];
  const uint8_t* open;
  const int32_t* slot_of;
  int32_t* w_open;
  int32_t* n_open;
  int n_win, n_bank, W, NB, cut, win_blocks;
};

// one thread moves one row of rb bytes
__device__ __forceinline__ void copy_row(const uint8_t* s, uint8_t* o, int64_t rb) {
  const uintptr_t a = (uintptr_t)s | (uintptr_t)o;
  if ((rb % 16) == 0 && (a % 16) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(s);
    int4* o4 = reinterpret_cast<int4*>(o);
    for (int64_t k = 0; k < rb / 16; ++k) o4[k] = s4[k];
  } else if ((rb % 4) == 0 && (a % 4) == 0) {
    const uint32_t* s1 = reinterpret_cast<const uint32_t*>(s);
    uint32_t* o1 = reinterpret_cast<uint32_t*>(o);
    for (int64_t k = 0; k < rb / 4; ++k) o1[k] = s1[k];
  } else {
    for (int64_t k = 0; k < rb; ++k) o[k] = s[k];
  }
}

// one thread writes one row of rb bytes with the 4-byte pattern `pat`
// (4-byte columns have rows of whole words; 1-byte columns repeat one byte)
__device__ __forceinline__ void fill_row(uint8_t* o, int64_t rb, uint32_t pat) {
  if ((rb % 16) == 0 && ((uintptr_t)o % 16) == 0) {
    const int v = (int)pat;
    int4* o4 = reinterpret_cast<int4*>(o);
    for (int64_t k = 0; k < rb / 16; ++k) o4[k] = make_int4(v, v, v, v);
  } else if ((rb % 4) == 0 && ((uintptr_t)o % 4) == 0) {
    uint32_t* o1 = reinterpret_cast<uint32_t*>(o);
    for (int64_t k = 0; k < rb / 4; ++k) o1[k] = pat;
  } else {
    for (int64_t k = 0; k < rb; ++k) o[k] = (uint8_t)(pat >> (8 * (int)(k & 3)));
  }
}

__device__ __forceinline__ int block_sum(int v, int* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
  return total;
}

__global__ void __launch_bounds__(kThreads) retract_tail_kernel(const __grid_constant__ Params p) {
  __shared__ int red[kThreads / 32];
  __shared__ int pos[kRows];
  __shared__ int lo_before;
  if ((int)blockIdx.x < p.win_blocks) {
    const int lo = blockIdx.x * kRows;
    const int hi = min(lo + kRows, p.W);
    // the alive count before this block's rows, and in the whole window
    int before = 0, all = 0;
    for (int i = threadIdx.x; i < p.W; i += blockDim.x) {
      const int a = (p.open[i] && p.slot_of[i] < p.cut) ? 1 : 0;
      all += a;
      before += (i < lo) ? a : 0;
    }
    const int total = block_sum(all, red);
    const int pre = block_sum(before, red);
    if (threadIdx.x == 0) lo_before = pre;
    __syncthreads();
    // stable positions of this block's rows: two warps' ballots
    if (threadIdx.x < kRows) {
      const int t = threadIdx.x;
      const int i = lo + t;
      const int a = (i < hi && p.open[i] && p.slot_of[i] < p.cut) ? 1 : 0;
      const unsigned bal = __ballot_sync(0xffffffffu, a);
      const int lane = t & 31;
      const int below = __popc(bal & ((1u << lane) - 1u));
      pos[t] = a ? below : -1;
      // the first warp's count, for the second warp
      if (t == 31) red[0] = __popc(bal);
    }
    __syncthreads();
    if (threadIdx.x < kRows && pos[threadIdx.x] >= 0)
      pos[threadIdx.x] += lo_before + (threadIdx.x >= 32 ? red[0] : 0);
    __syncthreads();
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      *p.w_open = total;
      *p.n_open = p.cut;
    }
    const int n = hi - lo;
    for (int t = threadIdx.x; t < n * p.n_win; t += blockDim.x) {
      const int f = t / n, j = t - f * n;
      const int i = lo + j;
      const int d = pos[j];
      const int64_t rb = p.row_bytes[f];
      if (d >= 0) copy_row(p.src[f] + (int64_t)i * rb, p.dst[f] + (int64_t)d * rb, rb);
      if (i >= total) fill_row(p.dst[f] + (int64_t)i * rb, rb, p.fill[f]);
    }
    return;
  }
  const int lo = (blockIdx.x - p.win_blocks) * kBankRows;
  const int n = min(lo + kBankRows, p.NB) - lo;
  for (int t = threadIdx.x; t < n * p.n_bank; t += blockDim.x) {
    const int f = t / n, r = lo + (t - f * n);
    const int64_t rb = p.brow_bytes[f];
    if (r < p.cut)
      copy_row(p.bsrc[f] + (int64_t)r * rb, p.bdst[f] + (int64_t)r * rb, rb);
    else
      fill_row(p.bdst[f] + (int64_t)r * rb, rb, 0u);
  }
}

}  // namespace

// srcs / dsts / row_bytes / fill are HOST arrays of n_win window columns,
// bsrcs / bdsts / brow_bytes of n_bank bank columns; open and slot_of are
// the device window columns the alive flags read; w_open and n_open are
// device int32 scalars the kernel writes.
extern "C" int retract_tail(int W, int NB, int cut, int n_win, const void* const* srcs,
                            void* const* dsts, const int64_t* row_bytes, const uint32_t* fill,
                            int n_bank, const void* const* bsrcs, void* const* bdsts,
                            const int64_t* brow_bytes, const void* open, const void* slot_of,
                            void* w_open, void* n_open, void* stream) {
  if (n_win > kMaxWin || n_win < 1 || n_bank > kMaxBank || n_bank < 0 || W < 0 || NB < 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.n_win = n_win;
  p.n_bank = n_bank;
  p.W = W;
  p.NB = NB;
  p.cut = cut;
  for (int f = 0; f < n_win; ++f) {
    p.src[f] = (const uint8_t*)srcs[f];
    p.dst[f] = (uint8_t*)dsts[f];
    p.row_bytes[f] = row_bytes[f];
    p.fill[f] = fill[f];
  }
  for (int f = 0; f < n_bank; ++f) {
    p.bsrc[f] = (const uint8_t*)bsrcs[f];
    p.bdst[f] = (uint8_t*)bdsts[f];
    p.brow_bytes[f] = brow_bytes[f];
  }
  p.open = (const uint8_t*)open;
  p.slot_of = (const int32_t*)slot_of;
  p.w_open = (int32_t*)w_open;
  p.n_open = (int32_t*)n_open;
  // at least one window block, so that block 0 writes the scalars
  p.win_blocks = W > 0 ? (W + kRows - 1) / kRows : 1;
  const int bank_blocks = (NB + kBankRows - 1) / kBankRows;
  retract_tail_kernel<<<p.win_blocks + bank_blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* retract_tail_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
