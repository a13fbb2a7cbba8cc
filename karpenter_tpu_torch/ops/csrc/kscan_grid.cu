// H5 kscan_grid — replaces the JAX package's ops/solver.py
// `_cap_res_grid` (solver.py:2751) with `_kscan_capd` (:2795) fused, and
// `_kscan_fits_final` (:2844) as a second mode: the per-segment capacity
// grid of the zonal kind scan.
//
// Over the (row n, type t, allocatable group g) grid of one segment:
//   grid(n,t,g) = the +/-1-verified max count of count_cell.cuh for
//                 group_valid cells, 0 elsewhere (the same arithmetic as
//                 H2's, shared, one fma rounding per charge)
//   admit(t,d)  = ~defined[t, key] | mask[t, key, d]  — type t admits
//                 domain d of the scan's key
//   off_d(n,t,g)= the row's capacity-type mask meets an available offering
//                 of (t, g) IN ZONE d (key = zone), or, for another key,
//                 in any zone the row's zone mask admits — exact boolean
//                 anys instead of the reference's bf16 einsums
// Mode 0 (grid): writes grid [N, T, GR] int32 and
//   capd(n, d) = max over (t, g) with viable(n,t) & admit(t,d) & off_d
//                of grid(n,t,g), 0 when none            [N, D] int32
// Mode 1 (capd): the same capd from a given grid (a reused boundary-
//   adjusted grid), which it only reads.
// Mode 2 (fits-final): out(n, t) = any over g of grid(n,t,g) >= placed(n)
//   & off(n,t,g), the offering taken within the final domain set zset(n)
//   (key = zone) or the row's zone mask                   [N, T] bool
//
// Bound on an H100: bytes. Mode 0 at the kind scan's window (N = 4096,
// T = 400, GR = 1) reads the [N, T] viable mask and writes the 6.5 MB
// grid, about 2.5 us of memory time; the per-cell count (R divisions,
// up to three R-wide fma checks) over all N x T x GR cells is of the same
// order at the f32 rate. Design:
//  - the catalog side arrives packed once per catalog (ops/cuda.py
//    kscan_catalog): H2's packed catalog (fill_grid_catalog: tiles of TT
//    types, [GR][TT] cells of allocatable floats padded to 4, 8 or 16,
//    [NWZ][GR][TT] 64-bit words of available (zone, capacity-type) pairs,
//    bit z*C + c, and [GR][TT] validity bytes) and a [T] column of each
//    type's admitted domains of the key as a 32-bit word;
//  - the row side is built once per row, by its warp, as NWZ pair words in
//    shared memory: for the zone key (modes 0 / 1) the row's capacity-type
//    bits at every zone's stride, so domain d is offered where
//    (zc & row) >> d*C has a bit in its low C; otherwise (and in mode 2,
//    from zset on the zone key) zone mask x capacity-type mask, so "any
//    offering" is an AND of words per cell;
//  - persistent 256-thread blocks walk many rows, in mode 0 from a catalog
//    tile they copy into shared memory (modes 1 and 2 read only the pair
//    words, from device memory); a warp takes a row (2-8 warps a row for launches of
//    few rows: tier 3's template rows), consecutive lanes consecutive types,
//    so the viable reads and grid writes coalesce; each lane keeps its
//    running max per domain in registers (D up to 4 or 16, by template)
//    and updates it only for the domains a cell admits and offers; the D
//    maxima fold by a transposed warp reduction (a shared-memory fold where
//    a row has several warps); a catalog past shared memory is tiled over
//    T within the launch (capd folds each tile's max, the same thread
//    owning (n, d) in every tile).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "count_cell.cuh"

namespace {

using ktpu::cell_count_t;
using ktpu::kMaxR;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 16;  // KSCAN_D
constexpr int kUnroll = 4;  // types a lane reads ahead
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const char* cat;         // H2's packed catalog: ntiles x tile_bytes
  const uint32_t* admit;   // [T] admitted domains of the key
  const float* req;        // [R]
  const float* used;       // [N, R]
  const uint8_t* viable;   // [N, T] (modes 0 / 1)
  const uint8_t* zmask;    // row n at zmask + n*mask_stride
  const uint8_t* cmask;    // row n at cmask + n*mask_stride
  const uint8_t* zset;     // [N, D] final domains (mode 2, key = zone)
  const int32_t* placed;   // [N] (mode 2)
  int32_t* grid;           // [N, T, GR]
  void* out;               // capd [N, D] int32 (modes 0 / 1), fits [N, T] bool (mode 2)
  int64_t mask_stride;
  int N, T, GR, R, Z, C, D, zone, NWZ, TT, staged, ntiles, tile_bytes, off_zc, off_valid, blocks, wpr;
};

__host__ __device__ __forceinline__ int pad16(int64_t n) { return (int)((n + 15) / 16 * 16); }

// the resources of a catalog cell: R rounded up to 4, 8 or 16
__host__ __device__ __forceinline__ int r_bucket(int R) { return R <= 4 ? 4 : R <= 8 ? 8 : 16; }

struct Tile {
  const float4* alloc;   // [GR][TT][kN / 4]
  const uint64_t* zc;    // [NWZ][GR][TT]
  const uint8_t* valid;  // [GR][TT]
  int cells;             // GR * TT
};

// the row's NWZ pair words (bit z*C + c) into the warp's `words`: for the
// zone key in modes 0 / 1 every zone with the row's capacity types, else
// the row's zones (zset's first D in mode 2 on the zone key) x its
// capacity types
template <int kMode>
__device__ __forceinline__ void row_words(const Args& a, int64_t n, uint64_t* words, int lane) {
  const uint8_t* cm = a.cmask + n * a.mask_stride;
  const bool every_zone = kMode != 2 && a.zone;
  const bool final_set = kMode == 2 && a.zone;
  const uint8_t* zm = final_set ? a.zset + n * a.D : a.zmask + n * a.mask_stride;
  const int zlim = final_set ? min(a.D, a.Z) : a.Z;
  const int ZC = a.Z * a.C;
  // the bytes of two 32-bit halves read before either is used
  for (int base = 0; base < a.NWZ * 64; base += 64) {
    bool bit[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = base + 32 * h + lane;
      bit[h] = false;
      if (k < ZC) {
        const int z = k / a.C, c = k - z * a.C;
        bit[h] = cm[c] && (every_zone || (z < zlim && zm[z]));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t m = __ballot_sync(kFull, bit[h]);
      if (lane == 0) reinterpret_cast<uint32_t*>(words)[base / 32 + h] = m;
    }
  }
  __syncwarp();
}

// any offering of a cell within the row's pair words
__device__ __forceinline__ bool any_offering(const Tile& tl, int cell, const uint64_t* words, uint64_t w0, int NWZ) {
  if (tl.zc[cell] & w0) return true;
  for (int w = 1; w < NWZ; ++w)
    if (tl.zc[(int64_t)w * tl.cells + cell] & words[w]) return true;
  return false;
}

// the zone key's offered domains of a cell: bit d when (zc & row) has a
// bit in [d*C, d*C + C)
template <int kD>
__device__ __forceinline__ uint32_t zone_domains(const Args& a, const Tile& tl, int cell, const uint64_t* words,
                                                 uint64_t w0) {
  uint32_t dom = 0;
  if (a.NWZ == 1) {  // D <= Z and Z*C <= 64: every shift below 64
    const uint64_t m = tl.zc[cell] & w0;
    const uint64_t low = a.C >= 64 ? ~0ull : ((1ull << a.C) - 1ull);
#pragma unroll
    for (int d = 0; d < kD; ++d)
      if (d < a.D && ((m >> (d * a.C)) & low)) dom |= 1u << d;
    return dom;
  }
  for (int d = 0; d < a.D && a.C > 0; ++d) {
    const int lo = d * a.C, hi = lo + a.C;
    for (int w = lo >> 6; w <= (hi - 1) >> 6; ++w) {
      const uint64_t m = tl.zc[(int64_t)w * tl.cells + cell] & words[w];
      const int b0 = max(lo - 64 * w, 0), b1 = min(hi - 64 * w, 64);
      const uint64_t in = (b1 >= 64 ? ~0ull : ((1ull << b1) - 1ull)) & ~((1ull << b0) - 1ull);
      if (m & in) {
        dom |= 1u << d;
        break;
      }
    }
  }
  return dom;
}

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

// ---- the kernel ------------------------------------------------------------
// kMode 0: grid and capd (kN >= R floats of a cell in registers); 1: capd
// of a given grid; 2: fits-final. kD: the domains a lane keeps a running
// max for (>= D). A group of wpr warps takes a row; dynamic shared memory:
// the staged tile, the groups' partial maxima [2][kWarps][kMaxD], per warp
// the row's pair words [NWZ].
template <int kMode, int kN, int kD>
__global__ void __launch_bounds__(kThreads) kscan_grid_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpr = a.wpr, gpb = kWarps / wpr, group = warp / wpr, wig = warp % wpr;
  // mode 0 reads a cell's allocatable from the staged tile; modes 1 and 2
  // read only the pair words, in device memory
  const bool staged = kMode == 0 && a.staged;
  char* tail = smem + (staged ? a.tile_bytes : 0);
  int* part = reinterpret_cast<int*>(tail);
  uint64_t* words = reinterpret_cast<uint64_t*>(part + 2 * kWarps * kMaxD) + warp * a.NWZ;
  float q[kN > 0 ? kN : 1], u[kN > 0 ? kN : 1], al[kN > 0 ? kN : 1];
#pragma unroll
  for (int r = 0; r < kN; ++r) q[r] = r < a.R ? a.req[r] : 0.0f;
  int par = 0;

  for (int k = 0; k < a.ntiles; ++k) {
    const char* base;
    if (staged) {
      if (k) __syncthreads();  // every warp is done with tile k - 1
      const int4* src = reinterpret_cast<const int4*>(a.cat + (int64_t)k * a.tile_bytes);
      int4* dst = reinterpret_cast<int4*>(smem);
      for (int i = threadIdx.x; i < a.tile_bytes / 16; i += kThreads) dst[i] = src[i];
      __syncthreads();
      base = smem;
    } else {
      base = a.cat + (int64_t)k * a.tile_bytes;
    }
    const Tile tl{reinterpret_cast<const float4*>(base), reinterpret_cast<const uint64_t*>(base + a.off_zc),
                  reinterpret_cast<const uint8_t*>(base + a.off_valid), a.GR * a.TT};
    const int t_lo = k * a.TT, t_hi = min(a.T, t_lo + a.TT);

    // the same trip counts for every warp of the block (its barriers below)
    for (int64_t rb = (int64_t)blockIdx.x * gpb; rb < a.N; rb += (int64_t)a.blocks * gpb) {
      const int64_t n = rb + group;
      const bool live = n < a.N;
      uint64_t w0 = 0;
      if (live) {
#pragma unroll
        for (int r = 0; r < kN; ++r) u[r] = r < a.R ? a.used[n * a.R + r] : 0.0f;
        row_words<kMode>(a, n, words, lane);
        w0 = words[0];
      }
      int best[kD];
#pragma unroll
      for (int d = 0; d < kD; ++d) best[d] = 0;
      const int need = (kMode == 2 && live) ? a.placed[n] : 0;
      // kUnroll types a lane at a time, their device-memory reads issued
      // together (the viable byte, the admit word, the first group's grid
      // cell) before any is used
      const int step = 32 * wpr;
      for (int t0 = t_lo + wig * 32 + lane; live && t0 - lane < t_hi; t0 += kUnroll * step) {
        uint32_t ad[kUnroll], vi[kUnroll];
        int vg[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          const int t = t0 + j * step;
          const int64_t nt = n * a.T + t;
          ad[j] = vi[j] = 0u;
          vg[j] = 0;
          if (t < t_hi) {
            if constexpr (kMode != 2) {
              vi[j] = a.viable[nt];
              ad[j] = a.admit[t];
            }
            if constexpr (kMode != 0) vg[j] = a.grid[nt * a.GR];
          }
        }
        if constexpr (kMode != 2) {
#pragma unroll
          for (int j = 0; j < kUnroll; ++j) ad[j] = vi[j] ? ad[j] : 0u;
        }
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          const int t = t0 + j * step;
          if (t >= t_hi) continue;
          const int64_t nt = n * a.T + t;
          const int tl_idx = t - t_lo;
          if constexpr (kMode == 2) {
            bool any = false;
            for (int g = 0; g < a.GR && !any; ++g)
              any = (g ? a.grid[nt * a.GR + g] : vg[j]) >= need &&
                    any_offering(tl, g * a.TT + tl_idx, words, w0, a.NWZ);
            static_cast<uint8_t*>(a.out)[nt] = any ? 1 : 0;
          } else {
            for (int g = 0; g < a.GR; ++g) {
              const int cell = g * a.TT + tl_idx;
              int c;
              if constexpr (kMode == 0) {
                c = 0;
                if (tl.valid[cell]) {
                  load_alloc<kN>(tl, cell, al);
                  c = cell_count_t<kN>(u, q, al, a.R);
                }
                a.grid[nt * a.GR + g] = c;
              } else {
                c = g ? a.grid[nt * a.GR + g] : vg[j];
              }
              if (!ad[j]) continue;
              const uint32_t dom = a.zone ? ad[j] & zone_domains<kD>(a, tl, cell, words, w0)
                                          : (any_offering(tl, cell, words, w0, a.NWZ) ? ad[j] : 0u);
#pragma unroll
              for (int d = 0; d < kD; ++d)
                if ((dom >> d) & 1u) best[d] = max(best[d], c);
            }
          }
        }
      }
      if constexpr (kMode != 2) {
        // transposed warp max: lane l ends with domain l % kD over the warp
#pragma unroll
        for (int s = kD / 2; s >= 1; s >>= 1) {
          const bool upper = (lane & s) != 0;
#pragma unroll
          for (int j = 0; j < s; ++j) {
            const int send = upper ? best[j] : best[j + s];
            const int keep = upper ? best[j + s] : best[j];
            best[j] = max(keep, __shfl_xor_sync(kFull, send, s));
          }
        }
#pragma unroll
        for (int s = kD; s < 32; s <<= 1) best[0] = max(best[0], __shfl_xor_sync(kFull, best[0], s));
        int32_t* capd = static_cast<int32_t*>(a.out);
        if (wpr == 1) {
          if (live && lane < a.D) capd[n * a.D + lane] = k ? max(capd[n * a.D + lane], best[0]) : best[0];
        } else {
          if (lane < kMaxD) part[(par * kWarps + warp) * kMaxD + lane] = best[0];
          __syncthreads();
          if (live && wig == 0 && lane < a.D) {
            int b = best[0];
            for (int w = 1; w < wpr; ++w) b = max(b, part[(par * kWarps + warp + w) * kMaxD + lane]);
            capd[n * a.D + lane] = k ? max(capd[n * a.D + lane], b) : b;
          }
          par ^= 1;
        }
      }
      __syncwarp();
    }
  }
}

// dynamic shared memory of a launch: the staged tile, the partial maxima,
// the warps' pair words
__host__ __device__ __forceinline__ size_t smem_bytes(int staged, int tile_bytes, int NWZ) {
  return (staged ? (size_t)tile_bytes : 0) + 4 * 2 * kWarps * kMaxD + 8 * kWarps * NWZ;
}

using KernelFn = void (*)(Args);
constexpr int kVariants = 9;
// mode 0 by (kN, kD), then mode 1 by kD, then mode 2
const KernelFn kKernels[kVariants] = {
    kscan_grid_kernel<0, 4, 4>, kscan_grid_kernel<0, 8, 4>,  kscan_grid_kernel<0, 16, 4>,
    kscan_grid_kernel<0, 4, 16>, kscan_grid_kernel<0, 8, 16>, kscan_grid_kernel<0, 16, 16>,
    kscan_grid_kernel<1, 0, 4>, kscan_grid_kernel<1, 0, 16>, kscan_grid_kernel<2, 0, 4>};

int g_sms = 0;
// per variant: the shared memory opted into, and the blocks an SM keeps
// resident at the shared memory of its last launch
size_t g_opted[kVariants] = {};
size_t g_occ_smem[kVariants] = {};
int g_occ[kVariants] = {};

}  // namespace

// ptrs (host array of device pointers), in order: the packed catalog, the
// admit column, req, used, viable, zmask row 0, cmask row 0, zset, placed,
// grid, out (capd for modes 0 / 1, the fits mask for mode 2).
// dims: N, T, GR, R, Z, C, D, key_is_zone, NWZ, TT, staged, mask_stride
// (the catalog's from ops/cuda.py kscan_catalog).
extern "C" int kscan_grid(int mode, const int64_t* ptrs, const int64_t* dims, void* stream) {
  Args a;
  a.cat = (const char*)ptrs[0];
  a.admit = (const uint32_t*)ptrs[1];
  a.req = (const float*)ptrs[2];
  a.used = (const float*)ptrs[3];
  a.viable = (const uint8_t*)ptrs[4];
  a.zmask = (const uint8_t*)ptrs[5];
  a.cmask = (const uint8_t*)ptrs[6];
  a.zset = (const uint8_t*)ptrs[7];
  a.placed = (const int32_t*)ptrs[8];
  a.grid = (int32_t*)ptrs[9];
  a.out = (void*)ptrs[10];
  a.N = (int)dims[0];
  a.T = (int)dims[1];
  a.GR = (int)dims[2];
  a.R = (int)dims[3];
  a.Z = (int)dims[4];
  a.C = (int)dims[5];
  a.D = (int)dims[6];
  a.zone = (int)dims[7];
  a.NWZ = (int)dims[8];
  a.TT = (int)dims[9];
  a.staged = (int)dims[10];
  a.mask_stride = dims[11];
  if (a.R > kMaxR || a.R < 0 || a.D > kMaxD || a.D < 1 || a.TT < 1 || a.NWZ < 1 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const int64_t cells = (int64_t)a.GR * a.TT;
  const int kn = r_bucket(a.R);
  a.off_zc = pad16(4 * (int64_t)kn * cells);
  a.off_valid = a.off_zc + pad16(8 * (int64_t)a.NWZ * cells);
  a.tile_bytes = a.off_valid + pad16(cells);
  a.ntiles = (a.T + a.TT - 1) / a.TT;
  if (a.N == 0 || a.T == 0) return 0;
  if (!g_sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int dv = a.D <= 4 ? 0 : 1;
  const int v = mode == 0 ? 3 * dv + (kn == 4 ? 0 : kn == 8 ? 1 : 2) : mode == 1 ? 6 + dv : 8;
  const KernelFn fn = kKernels[v];
  const size_t smem = smem_bytes(mode == 0 && a.staged, a.tile_bytes, a.NWZ);
  if (smem > 48 * 1024 && smem > g_opted[v]) {
    const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    g_opted[v] = smem;
  }
  if (g_occ_smem[v] != smem || !g_occ[v]) {
    int per_sm = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    g_occ[v] = max(1, min(4, per_sm));
    g_occ_smem[v] = smem;
  }
  // as many blocks as stay resident (at most 4 an SM), no more than the
  // rows need; a launch of few rows gives each row up to 8 warps
  const int64_t warps = (int64_t)g_sms * g_occ[v] * kWarps;
  a.wpr = 1;
  while (a.wpr < kWarps && (int64_t)a.N * a.wpr * 2 <= warps) a.wpr *= 2;
  a.blocks = (int)min(warps / kWarps, ((int64_t)a.N * a.wpr + kWarps - 1) / kWarps);
  cudaStream_t s = (cudaStream_t)stream;
  fn<<<a.blocks, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* kscan_grid_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
