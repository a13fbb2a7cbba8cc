// H1 req_intersects — replaces the JAX package's ops/kernels.py
// `intersects` (kernels.py:54) together with `has_intersection_keys` (:38)
// and `lenient` (:23).
//
// out[i, j] = AND over keys k of
//     ~(defA & defB) | nonempty(A_ik, B_jk) | (lenient(A_ik) & lenient(B_jk))
// nonempty = any(maskA & maskB) | (infA & infB & max(gte) <= min(lte))
// lenient  = def & ((inf & excl) | (~inf & ~any(mask)))
//
// On the main path A is the [W, K, V] combined claim-side requirement
// batch and B the [T, K, V] catalog (tier 2), or A = [G, K, V] templates
// (tier 3). Bound on an H100: the [A, B] bool output (4 MB at W=4096,
// T=1000) is the only large stream, so bytes alone bound it at about
// 1.2 us; the per-pair key tests (15 operations a shared key) make it
// operation-bound.
//
// Design. The catalog side is the same tensors at every step of a solve,
// so ops/cuda.py packs it once per catalog (ReqCatalog): per type and
// group of 32 keys, bit words of the defined, lenient, infinite and
// any-value keys, with the type axis innermost; gte / lte and the mask's
// 8-byte words beside them, also type-innermost. A block copies the
// catalog words of its tile of types and builds its tile of claim rows'
// bit words once (one thread per (row, key)) in shared memory. Each warp
// then takes one claim row at a time over 128 consecutive types, four a
// lane, and writes them as one 4-byte store (a warp: 128 contiguous
// bytes). A (row, type) pair tests only the keys of
//   need = defA & defB & ~(lenA & lenB),
// walked with __ffs, and stops at the first key that does not intersect:
// a key that is not shared, or lenient on both sides, costs nothing.
// The per-key detail (gte / lte and mask words, both sides) is read in
// place: the lanes of a warp share the claim row, so its loads are
// broadcasts, and consecutive lanes read consecutive types of the
// catalog's. gte <= lte is a signed int32 compare.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFewRows = 64;  // below: a lane one type

struct Claim {
  const uint8_t* mask;  // [A, K, V] bool, rows 8-byte aligned
  const uint8_t* inf;   // [A, K] bool
  const uint8_t* excl;  // [A, K] bool
  const int32_t* gte;   // [A, K] int32
  const int32_t* lte;   // [A, K] int32
  const uint8_t* def;   // [A, K] bool
  int A;
};

struct Catalog {
  const uint32_t* words;  // [4][NKW][Bp]: defined, lenient, infinite, any value
  const int32_t* gte;     // [K][Bp]
  const int32_t* lte;     // [K][Bp]
  const uint64_t* mask;   // [K][V / 8][Bp]
  int B, Bp, K, V, NKW;
};

// The per-key detail a key test reads, in device memory, for the block's
// rows (A side) and tile of types (B side)
struct Detail {
  const int32_t* agte;    // [rows][K] from the block's first row
  const int32_t* alte;
  const uint64_t* amask;  // [rows][K][VW]
  const int32_t* bgte;    // [K][stride] from the tile's first type
  const int32_t* blte;
  const uint64_t* bmask;  // [K][VW][stride]
  int stride, K, VW;
};

// Does key k of the block's claim row r intersect the tile's type tl?
// (the key is shared and not lenient on both sides; `bit` is its bit in
// the words inf2 / any2 of the keys infinite / any-valued on both sides)
__device__ __forceinline__ bool key_ok(const Detail& d, int r, int k, int tl, uint32_t bit, uint32_t inf2,
                                       uint32_t any2) {
  const int ik = r * d.K + k;
  if (inf2 & bit) {
    const int32_t g = max(d.agte[ik], d.bgte[k * d.stride + tl]);
    const int32_t l = min(d.alte[ik], d.blte[k * d.stride + tl]);
    if (g <= l) return true;
  }
  if (any2 & bit) {
    const uint64_t* ma = d.amask + (int64_t)ik * d.VW;
    const uint64_t* mb = d.bmask + (int64_t)k * d.VW * d.stride + tl;
    for (int v = 0; v < d.VW; ++v)
      if (ma[v] & mb[(int64_t)v * d.stride]) return true;
  }
  return false;
}

// grid: row tiles x type tiles; a block covers RT rows and WT * 32 * TPL
// types, its warps WT across the types and kWarps / WT down the rows, a
// lane TPL consecutive types (4 when the rows are many: one 4-byte store;
// 1 when they are few, so that more lanes share the types).
template <int TPL>
__global__ void __launch_bounds__(kThreads) req_intersects_kernel(Claim a, Catalog c, int WT, int RT,
                                                                   uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int TT = WT * 32 * TPL;
  const int ntt = (c.B + TT - 1) / TT;
  const int row0 = (int)(blockIdx.x / ntt) * RT;
  const int tbase = (int)(blockIdx.x % ntt) * TT;
  const int NKW = c.NKW, K = c.K, VW = c.V / 8;
  const int nrows = min(RT, a.A - row0);
  const Detail d{a.gte + (int64_t)row0 * K,
                 a.lte + (int64_t)row0 * K,
                 reinterpret_cast<const uint64_t*>(a.mask) + (int64_t)row0 * K * VW,
                 c.gte + tbase,
                 c.lte + tbase,
                 c.mask + tbase,
                 c.Bp,
                 K,
                 VW};
  // shared memory: [4 * NKW][TT] catalog key words, [RT][4 * NKW] row key words
  uint32_t* cw = smem;
  uint32_t* rw = cw + 4 * NKW * TT;
  for (int x = threadIdx.x; x < 4 * NKW * TT; x += kThreads) {
    const int kw = x / TT, t = tbase + (x - kw * TT);
    cw[x] = t < c.Bp ? c.words[(int64_t)kw * c.Bp + t] : 0u;
  }
  for (int x = threadIdx.x; x < RT * 4 * NKW; x += kThreads) rw[x] = 0u;
  __syncthreads();
  // the rows' key words, one thread per (row, key), every load issued at once
  for (int x = threadIdx.x; x < nrows * K; x += kThreads) {
    const int r = x / K, k = x - r * K;
    const int64_t ik = (int64_t)row0 * K + x;
    const bool def = a.def[ik] != 0, inf = a.inf[ik] != 0, excl = a.excl[ik] != 0;
    bool any = false;
    for (int v = 0; v < VW; ++v) any |= d.amask[(int64_t)x * VW + v] != 0;
    if (!def) continue;
    const bool len = inf ? excl : !any;
    uint32_t* w = rw + r * 4 * NKW + (k >> 5);
    const uint32_t bit = 1u << (k & 31);
    atomicOr(w, bit);
    if (len) atomicOr(w + NKW, bit);
    if (inf) atomicOr(w + 2 * NKW, bit);
    if (any) atomicOr(w + 3 * NKW, bit);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tl = (warp % WT) * 32 * TPL + lane * TPL;  // the lane's first type in the tile
  const int t0 = tbase + tl;
  if (t0 >= c.B) return;
  for (int r = warp / WT; r < nrows; r += kWarps / WT) {
    const uint32_t* R = rw + r * 4 * NKW;
    uint32_t ok = (1u << TPL) - 1u;  // bit q: type t0 + q intersects so far
    for (int w = 0; w < NKW && ok; ++w) {
      const uint32_t da = R[w];
      if (!da) continue;
      const uint32_t la = R[NKW + w], ia = R[2 * NKW + w], aa = R[3 * NKW + w];
      uint32_t bw[4][TPL];  // the lane's types' defined, lenient, infinite, any-value words
#pragma unroll
      for (int kind = 0; kind < 4; ++kind) {
        const uint32_t* src = cw + (kind * NKW + w) * TT + tl;
        if constexpr (TPL == 4) {
          const uint4 v = *reinterpret_cast<const uint4*>(src);
          bw[kind][0] = v.x;
          bw[kind][1] = v.y;
          bw[kind][2] = v.z;
          bw[kind][3] = v.w;
        } else {
          bw[kind][0] = *src;
        }
      }
#pragma unroll
      for (int q = 0; q < TPL; ++q) {
        uint32_t need = (ok >> q & 1u) ? da & bw[0][q] & ~(la & bw[1][q]) : 0u;
        const uint32_t inf2 = ia & bw[2][q], any2 = aa & bw[3][q];
        while (need) {
          const int b = __ffs(need) - 1;
          need &= need - 1u;
          if (!key_ok(d, r, w * 32 + b, tl + q, 1u << b, inf2, any2)) {
            ok &= ~(1u << q);
            break;
          }
        }
      }
    }
    uint8_t* o = out + (int64_t)(row0 + r) * c.B + t0;
    if (TPL == 4 && t0 + 4 <= c.B && (reinterpret_cast<uintptr_t>(o) & 3) == 0) {
      *reinterpret_cast<uint32_t*>(o) = (ok & 1u) | (ok >> 1 & 1u) << 8 | (ok >> 2 & 1u) << 16 | (ok >> 3 & 1u) << 24;
    } else {
      for (int q = 0; q < TPL && t0 + q < c.B; ++q) o[q] = ok >> q & 1u;
    }
  }
}

// the block's shared memory (see req_intersects_kernel)
size_t smem_bytes(int NKW, int TT, int RT) { return 16 * (size_t)NKW * (TT + RT); }

}  // namespace

// a_*: the claim side's six device tensors; `cat` the device packed
// catalog (ops/cuda.py ReqCatalog) and `dims` its HOST (B, Bp, K, V, NKW).
extern "C" int req_intersects(const void* a_mask, const void* a_inf, const void* a_excl, const void* a_gte,
                              const void* a_lte, const void* a_def, const void* cat, const int* dims, int A,
                              void* out, void* stream) {
  Claim a{(const uint8_t*)a_mask, (const uint8_t*)a_inf, (const uint8_t*)a_excl, (const int32_t*)a_gte,
          (const int32_t*)a_lte, (const uint8_t*)a_def, A};
  Catalog c;
  c.B = dims[0];
  c.Bp = dims[1];
  c.K = dims[2];
  c.V = dims[3];
  c.NKW = dims[4];
  if (A == 0 || c.B == 0) return 0;
  const uint8_t* base = (const uint8_t*)cat;
  const int64_t words = (int64_t)16 * c.NKW * c.Bp, side = (int64_t)4 * c.K * c.Bp;
  c.words = (const uint32_t*)base;
  c.gte = (const int32_t*)(base + words);
  c.lte = (const int32_t*)(base + words + side);
  c.mask = (const uint64_t*)(base + words + 2 * side);
  // many rows: a lane 4 types, a warp 128, 1-8 rows a warp; few rows: a
  // lane one type, up to all 8 warps across the types, one row a warp;
  // fewer warps across the types while the blocks' key words exceed 48 KB
  const int few = A < kFewRows;
  const int TPL = few ? 1 : 4;
  int WT = 1;
  while (few && WT < kWarps && 2 * WT * 32 <= c.B && A * 2 * WT <= 64) WT *= 2;
  const int RPW = A >= 2048 ? 8 : A >= 1024 ? 4 : 1;
  size_t smem = 0;
  for (;;) {
    smem = smem_bytes(c.NKW, WT * 32 * TPL, (kWarps / WT) * RPW);
    if (smem <= 48 * 1024 || WT == 1) break;
    WT /= 2;
  }
  const int RT = (kWarps / WT) * RPW;
  void (*kern)(Claim, Catalog, int, int, uint8_t*) = few ? req_intersects_kernel<1> : req_intersects_kernel<4>;
  if (smem > 48 * 1024) {  // past 512 keys
    const cudaError_t e = (cudaError_t)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                            (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int TT = WT * 32 * TPL;
  const int64_t blocks = (int64_t)((A + RT - 1) / RT) * ((c.B + TT - 1) / TT);
  uint8_t* o = static_cast<uint8_t*>(out);
  kern<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(a, c, WT, RT, o);
  return (int)cudaGetLastError();
}

extern "C" const char* req_intersects_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
