// H4 compact_scatter — replaces the row movement of the JAX package's
// ops/solver.py `compact_state` (solver.py:870-893, the stable compaction
// by argsort(~alive)), `_bank_rows` (:814) and `global_template` /
// `global_claims` (:952 / :961), the `.at[idx].set(..., mode="drop")`
// scatters.
//
// Each call moves the rows of up to kMaxFields window fields (every field
// a [n_rows, row_bytes] byte matrix: requirement masks, usage, viable-type
// masks, counters) to destination rows:
//   mode 0 (compact): row i goes to the exclusive prefix count of `alive`
//           at i, if alive[i] — the stable compaction; dead rows drop;
//   mode 1 (drop):    row i goes to ids[i] when 0 <= ids[i] < n_dst_rows,
//           else drops (the reference's mode="drop" scatter).
// Destination rows nobody writes keep what the caller put there (the
// identity / zero fill for compaction, the bank for the scatters).
// A field may instead move only some key rows of its source row: with
// seg_bytes > 0 the destination row is the n_tk segments of seg_bytes
// bytes at source offsets tk[j] * seg_bytes — the topology-key mode, which
// banks `reqs.mask[:, topo_kids, :]`, `inf[:, topo_kids]` and
// `defined[:, topo_kids]` (the reference's `_bank_rows` tk rows, :824-836)
// in the same launch as the other bank columns.
//
// Bound on an H100: bytes — each moved row is read once and written once,
// about 4.6 MB each way for a full [4096, T=1000] window, about 2.8 us;
// at the north star's W = 4096 the launch itself (a few us) is the floor.
// Design: ONE launch in both modes, nothing allocated per call. A block
// owns a tile of kTile = 32 rows. In mode 0 its first warp ballots the
// tile's alive bytes and finds the tile's base by a single-pass scan with
// decoupled look-back: each tile publishes its count (and, once known,
// its inclusive prefix) in a flag word of a workspace the launcher
// allocates once; tiles are numbered in the order blocks start (an atomic
// ticket), so a block only waits on blocks already running; the last
// block to finish its look-back zeroes the workspace for the next call.
// The tile's live rows are then listed in shared memory, and every
// field's chunks of a row are laid end to end: (row, chunk) pairs spread
// over the block's 512 threads, consecutive threads on consecutive chunks
// of one destination row, so a warp covers several rows' small fields,
// and each thread reads kUnroll = 4 chunks before it writes them, to keep
// loads in flight. A chunk is the widest of 16, 8, 4, 2 or 1 bytes that
// divides the field's row, stride, segment and both base addresses (the
// host side works it out per call).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFields = 16;
constexpr int kMaxTk = 16;
constexpr int kTile = 32;  // rows a block owns: one warp's ballot
constexpr int kThreads = 512;
constexpr int kUnroll = 4;  // chunks a thread reads before it writes them
// a look-back flag: status in the top two bits, a row count below them
constexpr unsigned kAggregate = 1u << 30;
constexpr unsigned kInclusive = 2u << 30;
constexpr unsigned kStatus = 3u << 30;
constexpr unsigned kValue = kAggregate - 1;

struct Field {
  const uint8_t* src;
  uint8_t* dst;
  int64_t src_stride;  // source row bytes
  int64_t row_bytes;   // destination row bytes
  int64_t seg;         // 0 = whole row, else bytes of one key row
  int shift;           // log2 of the chunk's bytes
  int chunks;          // row_bytes >> shift
};

struct Params {
  Field f[kMaxFields];
  int chunk_end[kMaxFields];  // the fields' chunks laid end to end: each one's end
  int tk[kMaxTk];
  const void* sel;  // [n_rows] bool alive (mode 0) or int32 ids (mode 1)
  int* ws;          // mode 0: [0] ticket, [1] finished, [2..] tile flags
  int n_fields, n_rows, n_dst, n_tiles;
};

__device__ __forceinline__ unsigned load_flag(const int* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ void store_flag(int* p, unsigned v) {
  *reinterpret_cast<volatile unsigned*>(p) = v;
}

// Warp 0: the count of alive rows in tiles [0, tile), by decoupled
// look-back over the flags (each lane waits on one predecessor, nearest
// first; the nearest inclusive prefix ends the walk). Publishes this
// tile's aggregate before and its inclusive prefix after.
__device__ int look_back(int* flags, int tile, int count, int lane) {
  if (lane == 0) store_flag(flags + tile, (tile == 0 ? kInclusive : kAggregate) | (unsigned)count);
  int prefix = 0;
  for (int top = tile - 1; top >= 0; top -= 32) {
    const int j = top - lane;
    unsigned f = kInclusive;  // before tile 0: an inclusive 0
    if (j >= 0) {
      do {
        f = load_flag(flags + j);
      } while ((f & kStatus) == 0);
    }
    const unsigned incl = __ballot_sync(0xffffffffu, (f & kStatus) == kInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    int v = lane <= stop ? (int)(f & kValue) : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    prefix += v;
    if (incl) break;
  }
  if (lane == 0 && tile > 0) store_flag(flags + tile, kInclusive | (unsigned)(prefix + count));
  return prefix;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) compact_scatter_kernel(const __grid_constant__ Params p) {
  __shared__ int s_src[kTile], s_dst[kTile];
  __shared__ int s_tile, s_live;
  const int tid = threadIdx.x, lane = tid & 31;
  if (kMode == 0) {
    if (tid == 0) s_tile = atomicAdd(p.ws, 1);
    __syncthreads();
  }
  const int tile = kMode == 0 ? s_tile : (int)blockIdx.x;
  if (tid < 32) {
    const int i = tile * kTile + lane;
    int d = -1;
    if (kMode == 0) {
      const bool a = i < p.n_rows && static_cast<const uint8_t*>(p.sel)[i] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, a);
      const int base = look_back(p.ws + 2, tile, __popc(bal), lane);
      if (a) d = base + __popc(bal & ((1u << lane) - 1u));
      // this block reads no flag from here on: count it finished; the
      // last one resets the workspace (every flag write is fenced before
      // its block's count, so none lands after the reset)
      int last = 0;
      if (lane == 0) {
        __threadfence();
        last = atomicAdd(p.ws + 1, 1) == p.n_tiles - 1;
      }
      if (__shfl_sync(0xffffffffu, last, 0)) {
        for (int t = lane; t < p.n_tiles; t += 32) store_flag(p.ws + 2 + t, 0u);
        if (lane == 0) {
          store_flag(p.ws, 0u);
          store_flag(p.ws + 1, 0u);
        }
      }
    } else if (i < p.n_rows) {
      d = static_cast<const int32_t*>(p.sel)[i];
    }
    if (d >= p.n_dst) d = -1;
    const unsigned live = __ballot_sync(0xffffffffu, d >= 0);
    if (d >= 0) {
      const int j = __popc(live & ((1u << lane) - 1u));
      s_src[j] = i;
      s_dst[j] = d;
    }
    if (lane == 0) s_live = __popc(live);
  }
  __syncthreads();
  const int n_live = s_live;
  if (n_live == 0) return;
  // (row, chunk) pairs over the fields' chunks laid end to end: pair q is
  // chunk q % C of live row q / C; kUnroll chunks a thread are read
  // before any is written, so that each thread keeps several in flight
  const int C = p.chunk_end[p.n_fields - 1];
  const int total = n_live * C;
  for (int q0 = tid; q0 < total; q0 += kUnroll * kThreads) {
    int4 v[kUnroll];
    uint8_t* to[kUnroll];
    int sh[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * kThreads;
      sh[u] = -1;
      if (q >= total) continue;
      const int j = q / C;
      int c = q - j * C, f = 0;
      while (c >= p.chunk_end[f]) ++f;
      const Field& F = p.f[f];
      c -= f ? p.chunk_end[f - 1] : 0;
      const int64_t o = (int64_t)c << F.shift;
      int64_t so = o;
      if (F.seg > 0) {
        const int64_t k = o / F.seg;
        so = (int64_t)p.tk[k] * F.seg + (o - k * F.seg);
      }
      const uint8_t* from = F.src + (int64_t)s_src[j] * F.src_stride + so;
      to[u] = F.dst + (int64_t)s_dst[j] * F.row_bytes + o;
      sh[u] = F.shift;
      switch (F.shift) {
        case 4: v[u] = *reinterpret_cast<const int4*>(from); break;
        case 3: {
          const uint64_t w = *reinterpret_cast<const uint64_t*>(from);
          v[u].x = (int)(uint32_t)w;
          v[u].y = (int)(uint32_t)(w >> 32);
          break;
        }
        case 2: v[u].x = *reinterpret_cast<const int32_t*>(from); break;
        case 1: v[u].x = *reinterpret_cast<const uint16_t*>(from); break;
        default: v[u].x = *from;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      switch (sh[u]) {
        case 4: *reinterpret_cast<int4*>(to[u]) = v[u]; break;
        case 3:
          *reinterpret_cast<uint64_t*>(to[u]) = (uint64_t)(uint32_t)v[u].x | (uint64_t)(uint32_t)v[u].y << 32;
          break;
        case 2: *reinterpret_cast<int32_t*>(to[u]) = v[u].x; break;
        case 1: *reinterpret_cast<uint16_t*>(to[u]) = (uint16_t)v[u].x; break;
        case 0: *to[u] = (uint8_t)v[u].x; break;
        default: break;
      }
    }
  }
}

// log2 of the widest chunk (<= 16 bytes) dividing every value of `bits`
int chunk_shift(uint64_t bits) {
  int s = 0;
  while (s < 4 && (bits & ((2ull << s) - 1)) == 0) ++s;
  return s;
}

}  // namespace

// `ptrs` is a HOST array of 2 * n_fields addresses (src, dst of each
// field), `layout` a HOST array of 3 * n_fields values (row_bytes,
// src_row_bytes, seg_bytes of each field) and `tk` a HOST array of n_tk
// key ids; `sel` is the device alive mask (mode 0) or the device int32
// destination ids (mode 1); `ws` is the device workspace of mode 0 (2 +
// ws_tiles zeroed int32, left zeroed by every launch), ws_tiles >= the
// call's tiles, ceil(n_rows / 32).
extern "C" int compact_scatter(int mode, int n_rows, const void* sel, int n_dst_rows, int n_fields,
                               const int64_t* ptrs, const int64_t* layout, int n_tk, const int* tk, void* ws,
                               int ws_tiles, void* stream) {
  if (n_fields > kMaxFields || n_fields < 0) return (int)cudaErrorInvalidValue;
  if (n_tk > kMaxTk || n_tk < 0) return (int)cudaErrorInvalidValue;
  if (n_rows < 0 || n_rows >= (int)kAggregate) return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || n_fields == 0) return 0;
  Params p;
  p.n_fields = n_fields;
  p.n_rows = n_rows;
  p.n_dst = n_dst_rows;
  p.n_tiles = (n_rows + kTile - 1) / kTile;
  p.sel = sel;
  p.ws = (int*)ws;
  for (int j = 0; j < kMaxTk; ++j) p.tk[j] = j < n_tk ? tk[j] : 0;
  for (int f = 0; f < n_fields; ++f) {
    Field& F = p.f[f];
    F.src = (const uint8_t*)ptrs[2 * f];
    F.dst = (uint8_t*)ptrs[2 * f + 1];
    F.row_bytes = layout[3 * f];
    F.src_stride = layout[3 * f + 1];
    F.seg = layout[3 * f + 2];
    if (F.seg > 0 && F.row_bytes != n_tk * F.seg) return (int)cudaErrorInvalidValue;
    F.shift = chunk_shift((uint64_t)F.row_bytes | (uint64_t)F.src_stride | (uint64_t)F.seg |
                          (uint64_t)ptrs[2 * f] | (uint64_t)ptrs[2 * f + 1]);
    F.chunks = (int)(F.row_bytes >> F.shift);
    p.chunk_end[f] = (f ? p.chunk_end[f - 1] : 0) + F.chunks;
  }
  if (mode == 0 && (ws == nullptr || ws_tiles < p.n_tiles)) return (int)cudaErrorInvalidValue;
  void (*kern)(const Params) = mode == 0 ? compact_scatter_kernel<0> : compact_scatter_kernel<1>;
  kern<<<p.n_tiles, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* compact_scatter_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
