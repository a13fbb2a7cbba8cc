// H2 fill_count_grid — replaces the JAX package's ops/solver.py
// `_claim_fill_caps` (solver.py:1355) with the offering mask `_off_for`
// (:1478) fused in, and `_fits_off_counted` (:1333).
//
// Over the (row b, type t, allocatable group g) grid:
//   off(b,t,g) = any over (z, c) of zc_avail[t,g,z,c] & zmask[b,z] & cmask[b,c]
//                (the exact boolean form of the reference's bf16 einsum > 0)
//   okc        = off & group_valid[t,g]
//   fits(c)    = AND over r of (used[b,r] + c*req[r] <= alloc[t,g,r])
//                              | (used[b,r] + c*req[r] == 0)
// Mode 0 (max-count, tier-2 caps and tier-3 f_new0): for each viable cell
// the +/-1-verified count estimate of _claim_fill_caps, max-reduced over
// (t, g) to out_count[b] (int32).
// Mode 1 (fits-at-count, fits_final / fits_off0 / fits_new and the
// compact_state liveness test): out_fits[b,t] = any over g of
// okc & fits(counts[b]) (bool). gate_offering = 0 drops the offering term
// (compact_state's rule).
//
// Numerics: the charge used + c*req rounds ONCE (__fmaf_rn), as the JAX
// package's compiled step computes it (XLA fuses that multiply-add);
// head = alloc - used and the estimate head / req use __fsub_rn and the
// IEEE __fdiv_rn (the per-cell count lives in count_cell.cuh, shared with
// H5 kscan_grid). Never build with --use_fast_math.
//
// Bound on an H100: each launch at W=4096, T=1000 reads at least the
// [W, T] viable mask or writes the [W, T] fits mask, about 4 MB, so about
// 1.2 us of memory time; mode 0's per-cell count (R divisions and two
// R-wide fma checks) over the viable cells is of the same order at the
// 67 TFLOP/s f32 rate. Design:
//  - the catalog arrives packed (ops/cuda.py fill_grid_catalog, built once
//    per catalog): tiles of TT types, each [GR][TT] cells of allocatable
//    floats padded to 4, 8 or 16 (whole 16-byte loads), [NWZ][GR][TT]
//    64-bit words of available (zone, capacity-type) pairs, [GR][TT]
//    validity bytes, so lanes reading types t + lane meet no bank
//    conflict; a cell's allocatable, the row's usage and the request sit
//    in registers while the count runs (count_cell.cuh's register form);
//  - persistent blocks (a few per SM) stage a tile into shared memory with
//    one bulk asynchronous copy completing on an mbarrier, then walk many
//    rows; a catalog past shared memory is tiled over T within the launch
//    (mode 0 folds each tile's max into out[b], the same warp owning row b
//    in every tile), and a single type past it is read from device memory;
//  - a warp per row (up to 16 for launches of few rows): the row's
//    admitted (zone, capacity-type) word, built
//    once from its mask rows, makes the offering test one AND per cell;
//    the viable row is read as aligned 16-byte vectors; mode 0 queues the
//    viable, valid, offered cells in shared memory and counts 32 at a
//    time, so no lane idles on a non-viable type, then max-reduces by warp
//    shuffles (a block barrier only where a row's warps fold); mode 1
//    gathers 512 verdicts by ballots
//    and each lane writes its 16 bytes as one aligned 16-byte store (byte
//    stores only at a row's or a tile's ragged ends);
//  - rows of `used` and of the mask may be broadcast (stride 0), so tier
//    3's single template row needs no copy.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "count_cell.cuh"

namespace {

using ktpu::cell_count_t;
using ktpu::fits_at_t;
using ktpu::kMaxR;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kQueue = 64;                 // cells queued per warp (mode 0)
constexpr uint32_t kCopyChunk = 32768;     // bytes per bulk copy instruction
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const char* cat;            // packed catalog: ntiles x tile_bytes
  const float* req;           // [R]
  const float* used;          // [B or 1, R], row stride used_stride
  const uint8_t* zmask;       // mask + zone_kid*V, row stride mask_stride
  const uint8_t* cmask;       // mask + ct_kid*V, row stride mask_stride
  const uint8_t* viable;      // [B, T] (mode 0)
  const int32_t* counts;      // [B] (mode 1)
  void* out;                  // [B] int32 (mode 0) / [B, T] bool (mode 1)
  int64_t used_stride, mask_stride;
  int B, T, GR, R, Z, C, NWZ, TT, ntiles, tile_bytes, staged, gate, grid, wpr;
  int off_zc, off_valid;      // section offsets inside a tile
};

__host__ __device__ __forceinline__ int pad16(int64_t n) { return (int)((n + 15) / 16 * 16); }

// the resources of a catalog cell: R rounded up to 4, 8 or 16
__host__ __device__ __forceinline__ int r_bucket(int R) { return R <= 4 ? 4 : R <= 8 ? 8 : 16; }

// ---- the bulk asynchronous copy of one catalog tile ------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void stage_tile(const char* src, char* dst, uint32_t bytes, uint64_t* bar,
                                           int k) {
  const uint32_t b = smem_addr(bar);
  if (k == 0) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(1u) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes) : "memory");
    for (uint32_t off = 0; off < bytes; off += kCopyChunk) {
      const uint32_t n = min(kCopyChunk, bytes - off);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
              smem_addr(dst + off)),
          "l"(src + off), "r"(n), "r"(b)
          : "memory");
    }
  }
}

__device__ __forceinline__ void wait_tile(uint64_t* bar, int k) {
  const uint32_t b = smem_addr(bar);
  const uint32_t parity = (uint32_t)(k & 1);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
}

// ---- helpers ---------------------------------------------------------------
// bit j of the result: byte j of the 16 bytes is non-zero
__device__ __forceinline__ uint32_t nonzero_bits(int4 v) {
  const int w[4] = {v.x, v.y, v.z, v.w};
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = (uint32_t)w[i];
    const uint32_t h = (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
    bits |= (((h >> 7) & 1u) | ((h >> 14) & 2u) | ((h >> 21) & 4u) | ((h >> 28) & 8u)) << (4 * i);
  }
  return bits;
}

// four bits -> four 0/1 bytes
__device__ __forceinline__ int nibble_bytes(uint32_t x) { return (int)(((x & 0xfu) * 0x00204081u) & 0x01010101u); }

// bit j: type t0 + j lies in [t_lo, t_hi)
__device__ __forceinline__ uint32_t range_bits(int64_t t0, int t_lo, int t_hi) {
  const int64_t lo = max((int64_t)t_lo - t0, (int64_t)0), hi = min((int64_t)t_hi - t0, (int64_t)16);
  return hi <= lo ? 0u : ((1u << (int)hi) - 1u) & ~((1u << (int)lo) - 1u);
}

// a tile's sections
struct Tile {
  const float4* alloc;    // [GR][TT][kN / 4] (a cell's resources, padded to kN)
  const uint64_t* zc;     // [NWZ][GR][TT]
  const uint8_t* valid;   // [GR][TT]
  int cells;              // GR * TT
};

template <int kN>
__device__ __forceinline__ void load_alloc(const Tile& tl, int cell, float (&al)[kN]) {
  const float4* p = tl.alloc + (int64_t)cell * (kN / 4);
#pragma unroll
  for (int i = 0; i < kN / 4; ++i) {
    const float4 v = p[i];
    al[4 * i] = v.x;
    al[4 * i + 1] = v.y;
    al[4 * i + 2] = v.z;
    al[4 * i + 3] = v.w;
  }
}

// the row's admitted pairs: the first two words in registers, the rest in
// the warp's shared memory
struct Adm {
  uint64_t w0, w1;
  const uint64_t* rest;
};

__device__ __forceinline__ bool offered(const Args& a, const Tile& tl, const Adm& ad, int cell) {
  if (!a.gate) return true;
  if (tl.zc[cell] & ad.w0) return true;
  if (a.NWZ > 1 && (tl.zc[tl.cells + cell] & ad.w1)) return true;
  for (int w = 2; w < a.NWZ; ++w)
    if (tl.zc[(int64_t)w * tl.cells + cell] & ad.rest[w]) return true;
  return false;
}

// the row's admitted (zone, capacity-type) pairs: bit z*C + c of the NWZ
// words, written by the warp into adm
__device__ __forceinline__ Adm admitted(const Args& a, int64_t b, uint64_t* adm, int lane) {
  const uint8_t* zm = a.zmask + b * a.mask_stride;
  const uint8_t* cm = a.cmask + b * a.mask_stride;
  const int ZC = a.Z * a.C;
  for (int base = 0; base < a.NWZ * 64; base += 32) {
    const int k = base + lane;
    const bool bit = k < ZC && zm[k / a.C] && cm[k % a.C];
    const uint32_t m = __ballot_sync(kFull, bit);
    if (lane == 0) reinterpret_cast<uint32_t*>(adm)[base / 32] = m;
  }
  __syncwarp();
  return Adm{adm[0], a.NWZ > 1 ? adm[1] : 0ull, adm};
}

// ---- the kernel -------------------------------------------------------------
// A group of wpr warps takes a row (wpr > 1 for launches of few rows: the
// group's warps split each 512-type block's 16 rounds; in mode 0 they
// fold their maxima, in mode 1 their ballots, through shared memory). The
// row's usage, the request and a cell's allocatable live in registers
// (kN >= R entries). Dynamic shared memory: the staged tile, then the
// mbarrier, the groups' partial maxima [2][kWarps], their ballots
// [2][kWarps][16], per warp the row's admitted words [NWZ] and the queue
// of cells [kQueue].
template <int kMode, int kN>
__global__ void __launch_bounds__(kThreads) fill_grid_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpr = a.wpr, gpb = kWarps / wpr, group = warp / wpr, wig = warp % wpr;
  char* tile_s = smem;
  char* tail = smem + (a.staged ? a.tile_bytes : 0);
  uint64_t* bar = reinterpret_cast<uint64_t*>(tail);
  int* part = reinterpret_cast<int*>(tail + 16);
  uint32_t* words = reinterpret_cast<uint32_t*>(part + 2 * kWarps);
  uint64_t* adm_all = reinterpret_cast<uint64_t*>(words + 2 * kWarps * 16);
  uint64_t* adm = adm_all + warp * a.NWZ;
  int* queue = reinterpret_cast<int*>(adm_all + kWarps * a.NWZ) + warp * kQueue;
  float q[kN], u[kN], al[kN];
#pragma unroll
  for (int r = 0; r < kN; ++r) q[r] = r < a.R ? a.req[r] : 0.0f;
  const uint32_t lt = (1u << lane) - 1u;
  // the row's bytes are addressed from these bases, so that a chunk is an
  // aligned 16 bytes whatever the tensor's offset
  const int64_t vbase = (int64_t)(uintptr_t)(kMode == 0 ? (const void*)a.viable : (const void*)a.out);
  int par = 0;

  for (int k = 0; k < a.ntiles; ++k) {
    const char* base;
    if (a.staged) {
      if (k) __syncthreads();  // every warp is done with tile k - 1
      stage_tile(a.cat + (int64_t)k * a.tile_bytes, tile_s, (uint32_t)a.tile_bytes, bar, k);
      wait_tile(bar, k);
      base = tile_s;
    } else {
      base = a.cat + (int64_t)k * a.tile_bytes;
    }
    const Tile tl{reinterpret_cast<const float4*>(base), reinterpret_cast<const uint64_t*>(base + a.off_zc),
                  reinterpret_cast<const uint8_t*>(base + a.off_valid), a.GR * a.TT};
    const int t_lo = k * a.TT, t_hi = min(a.T, t_lo + a.TT);
    // 32-chunk blocks that any row's span of the tile can cover
    const int nblk = ((t_hi - t_lo + 15) / 16 + 1 + 31) / 32;

    // the same trip counts for every warp of the block (its barriers below)
    for (int64_t rb = (int64_t)blockIdx.x * gpb; rb < a.B; rb += (int64_t)a.grid * gpb) {
      const int64_t b = rb + group;
      const bool live = b < a.B;
      // the row's aligned 16-byte chunks over [t_lo, t_hi)
      const int64_t rbase = vbase + b * a.T;
      const int64_t c_first = (rbase + t_lo) >> 4, c_end = (rbase + t_hi + 15) >> 4;
      Adm ad{~0ull, ~0ull, adm};
      if (live) {
#pragma unroll
        for (int r = 0; r < kN; ++r) u[r] = r < a.R ? a.used[b * a.used_stride + r] : 0.0f;
        if (a.gate) ad = admitted(a, b, adm, lane);
      }
      if (kMode == 0) {
        int best = 0, qn = 0;
        for (int64_t c0 = c_first; live && c0 < c_end; c0 += 32) {
          const int64_t c = c0 + lane;
          uint32_t vb = 0;
          if (c < c_end)
            vb = nonzero_bits(*reinterpret_cast<const int4*>((uintptr_t)(c * 16))) &
                 range_bits(c * 16 - rbase, t_lo, t_hi);
          if (!__any_sync(kFull, vb != 0)) continue;
          const int tb = (int)(c0 * 16 - rbase);
          for (int j2 = wig; j2 < 16; j2 += wpr) {
            // round j2: type tb + 32 j2 + lane, its viable bit from the lane that read it
            const uint32_t src = __shfl_sync(kFull, vb, 2 * j2 + (lane >> 4));
            const bool v = (src >> (lane & 15)) & 1u;
            if (!__any_sync(kFull, v)) continue;
            const int tl_idx = tb + 32 * j2 + lane - t_lo;
            for (int g = 0; g < a.GR; ++g) {
              const int cell = g * a.TT + tl_idx;
              const bool ok = v && tl.valid[cell] && offered(a, tl, ad, cell);
              const uint32_t m = __ballot_sync(kFull, ok);
              if (!m) continue;
              if (ok) queue[qn + __popc(m & lt)] = cell;
              qn += __popc(m);
              __syncwarp();
              if (qn >= 32) {
                load_alloc(tl, queue[lane], al);
                best = max(best, cell_count_t<kN>(u, q, al, a.R));
                __syncwarp();
                if (lane < qn - 32) queue[lane] = queue[lane + 32];
                qn -= 32;
                __syncwarp();
              }
            }
          }
        }
        if (lane < qn) {
          load_alloc(tl, queue[lane], al);
          best = max(best, cell_count_t<kN>(u, q, al, a.R));
        }
        for (int off = 16; off > 0; off >>= 1) best = max(best, __shfl_xor_sync(kFull, best, off));
        int32_t* out = static_cast<int32_t*>(a.out);
        if (wpr == 1) {
          if (live && lane == 0) out[b] = k ? max(out[b], best) : best;
        } else {
          if (lane == 0) part[par * kWarps + warp] = best;
          __syncthreads();
          if (live && wig == 0 && lane == 0) {
            for (int w = 1; w < wpr; ++w) best = max(best, part[par * kWarps + warp + w]);
            out[b] = k ? max(out[b], best) : best;
          }
          par ^= 1;
        }
        __syncwarp();
      } else {
        const int cnt = live ? a.counts[b] : 0;
        uint8_t* out = reinterpret_cast<uint8_t*>(a.out);
        const int64_t obase = b * a.T;  // out[obase + t] is at address rbase + t
        for (int it = 0; it < nblk; ++it) {
          const int64_t c0 = c_first + 32 * it;
          const bool active = live && c0 < c_end;
          const int tb = (int)(c0 * 16 - rbase);
          uint32_t mine = 0;  // this lane's 16 verdicts: types tb + 16 lane + j
          for (int j2 = wig; active && j2 < 16; j2 += wpr) {
            const int t = tb + 32 * j2 + lane;
            bool any = false;
            if (t >= t_lo && t < t_hi) {
              for (int g = 0; g < a.GR && !any; ++g) {
                const int cell = g * a.TT + (t - t_lo);
                if (tl.valid[cell] && offered(a, tl, ad, cell)) {
                  load_alloc(tl, cell, al);
                  any = fits_at_t<kN>(u, q, al, a.R, cnt);
                }
              }
            }
            const uint32_t m = __ballot_sync(kFull, any);
            if (wpr == 1) {
              if (j2 == (lane >> 1)) mine = (m >> ((lane & 1) * 16)) & 0xffffu;
            } else if (lane == 0) {
              words[(par * kWarps + group) * 16 + j2] = m;
            }
          }
          if (wpr > 1) {
            __syncthreads();
            mine = (words[(par * kWarps + group) * 16 + (lane >> 1)] >> ((lane & 1) * 16)) & 0xffffu;
            par ^= 1;
          }
          const int64_t c = c0 + lane;
          if (active && wig == 0 && c < c_end) {
            const int64_t t0 = c * 16 - rbase;
            const uint32_t in = range_bits(t0, t_lo, t_hi);
            if (in == 0xffffu) {
              *reinterpret_cast<int4*>((uintptr_t)(c * 16)) = make_int4(
                  nibble_bytes(mine), nibble_bytes(mine >> 4), nibble_bytes(mine >> 8), nibble_bytes(mine >> 12));
            } else {
              for (int j = 0; j < 16; ++j)
                if ((in >> j) & 1u) out[obase + t0 + j] = (mine >> j) & 1u;
            }
          }
        }
        __syncwarp();
      }
    }
  }
}

// dynamic shared memory of a launch: the staged tile, then the tail above
__host__ __device__ __forceinline__ size_t smem_bytes(int staged, int tile_bytes, int NWZ) {
  return (staged ? (size_t)tile_bytes : 0) + 16 + 4 * 2 * kWarps + 4 * 2 * kWarps * 16 + 8 * kWarps * NWZ +
         4 * kWarps * kQueue;
}

int g_sms = 0;
size_t g_opted[2][3] = {{0, 0, 0}, {0, 0, 0}};
// per instantiation, the shared memory of its last launch and the blocks an
// SM then keeps resident (the occupancy query runs once per catalog shape)
size_t g_occ_smem[2][3] = {{0, 0, 0}, {0, 0, 0}};
int g_occ[2][3] = {{0, 0, 0}, {0, 0, 0}};

}  // namespace

// dims: T, GR, R, Z, C, NWZ, TT, staged (the catalog's, from
// ops/cuda.py fill_grid_catalog). cat: ceil(T / TT) tiles of the packed
// layout, 16-byte aligned. Returns cudaGetLastError() of the launch.
extern "C" int fill_count_grid(int mode, const void* cat, const void* req, const void* used, int64_t used_stride,
                               const void* zmask, const void* cmask, int64_t mask_stride, int gate,
                               const void* viable, const void* counts, void* out, int B, const int* dims,
                               void* stream) {
  Args a;
  a.cat = (const char*)cat;
  a.req = (const float*)req;
  a.used = (const float*)used;
  a.zmask = (const uint8_t*)zmask;
  a.cmask = (const uint8_t*)cmask;
  a.viable = (const uint8_t*)viable;
  a.counts = (const int32_t*)counts;
  a.out = out;
  a.used_stride = used_stride;
  a.mask_stride = mask_stride;
  a.B = B;
  a.T = dims[0];
  a.GR = dims[1];
  a.R = dims[2];
  a.Z = dims[3];
  a.C = dims[4];
  a.NWZ = dims[5];
  a.TT = dims[6];
  a.staged = dims[7];
  a.gate = gate;
  if (a.R > kMaxR || a.R < 0 || a.TT < 1 || a.NWZ < 1 || (mode != 0 && mode != 1)) return (int)cudaErrorInvalidValue;
  const int64_t cells = (int64_t)a.GR * a.TT;
  const int kn = r_bucket(a.R);
  a.off_zc = pad16(4 * (int64_t)kn * cells);
  a.off_valid = a.off_zc + pad16(8 * (int64_t)a.NWZ * cells);
  a.tile_bytes = a.off_valid + pad16(cells);
  a.ntiles = (a.T + a.TT - 1) / a.TT;
  if (B == 0 || a.T == 0) return 0;
  if (!g_sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  void (*const kernels[2][3])(Args) = {
      {fill_grid_kernel<0, 4>, fill_grid_kernel<0, 8>, fill_grid_kernel<0, 16>},
      {fill_grid_kernel<1, 4>, fill_grid_kernel<1, 8>, fill_grid_kernel<1, 16>}};
  const int kb = kn == 4 ? 0 : kn == 8 ? 1 : 2;
  auto* fn = kernels[mode][kb];
  const size_t smem = smem_bytes(a.staged, a.tile_bytes, a.NWZ);
  if (smem > 48 * 1024 && smem > g_opted[mode][kb]) {
    const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    g_opted[mode][kb] = smem;
  }
  // as many blocks as stay resident (at most 4 an SM), no more than the
  // rows need; a launch of few rows gives each row up to 16 warps
  if (g_occ_smem[mode][kb] != smem || !g_occ[mode][kb]) {
    int per_sm = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    g_occ[mode][kb] = max(1, min(4, per_sm));
    g_occ_smem[mode][kb] = smem;
  }
  const int64_t warps = (int64_t)g_sms * g_occ[mode][kb] * kWarps;
  a.wpr = 1;
  while (a.wpr < kWarps && (int64_t)B * a.wpr * 2 <= warps) a.wpr *= 2;
  a.grid = (int)min(warps / kWarps, ((int64_t)B * a.wpr + kWarps - 1) / kWarps);
  cudaStream_t s = (cudaStream_t)stream;
  fn<<<a.grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* fill_count_grid_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
