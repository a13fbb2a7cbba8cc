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
// 1.2 us of memory time; the per-cell arithmetic (R=4 resources, three
// verification passes) is far below the 67 TFLOP/s f32 rate. Design: mode
// 0 runs one block per row b whose threads stride over t and max-reduce
// through warp shuffles, so the [W, T, GR] grid never reaches memory;
// mode 1 runs one thread per (b, t). Rows of `used` and of the mask may
// be broadcast (stride 0) so tier 3's single template row needs no copy.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "count_cell.cuh"

namespace {

using ktpu::cell_count;
using ktpu::fits_at;
using ktpu::kMaxR;

struct Grid {
  const float* alloc;         // [T, GR, R]
  const uint8_t* group_valid; // [T, GR]
  const uint8_t* zc_avail;    // [T, GR, Z, C]
  const float* req;           // [R]
  const float* used;          // [B or 1, R], row stride used_stride
  const uint8_t* zmask;       // mask + zone_kid*V, row stride mask_stride
  const uint8_t* cmask;       // mask + ct_kid*V, row stride mask_stride
  int64_t used_stride;
  int64_t mask_stride;
  int T, GR, R, Z, C;
  int gate_offering;
};

__device__ __forceinline__ bool offering(const Grid& p, int64_t b, int t,
                                         int g) {
  if (!p.gate_offering) return true;
  const uint8_t* zc = p.zc_avail + (((int64_t)t * p.GR + g) * p.Z) * p.C;
  const uint8_t* zm = p.zmask + b * p.mask_stride;
  const uint8_t* cm = p.cmask + b * p.mask_stride;
  for (int z = 0; z < p.Z; ++z) {
    if (!zm[z]) continue;
    for (int c = 0; c < p.C; ++c) {
      if (zc[z * p.C + c] && cm[c]) return true;
    }
  }
  return false;
}

__global__ void max_count_kernel(Grid p, const uint8_t* __restrict__ viable,
                                 int B, int32_t* __restrict__ out) {
  const int64_t b = blockIdx.x;
  const float* used = p.used + b * p.used_stride;
  float u[kMaxR], q[kMaxR];
  for (int r = 0; r < p.R; ++r) {
    u[r] = used[r];
    q[r] = p.req[r];
  }
  int best = 0;
  for (int t = threadIdx.x; t < p.T; t += blockDim.x) {
    if (!viable[b * p.T + t]) continue;
    for (int g = 0; g < p.GR; ++g) {
      if (!p.group_valid[(int64_t)t * p.GR + g]) continue;
      if (!offering(p, b, t, g)) continue;
      const float* al = p.alloc + ((int64_t)t * p.GR + g) * p.R;
      const int c = cell_count(u, q, al, p.R);
      best = max(best, c);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    best = max(best, __shfl_down_sync(0xffffffffu, best, off));
  __shared__ int warp_best[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    best = lane < nw ? warp_best[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      best = max(best, __shfl_down_sync(0xffffffffu, best, off));
    if (lane == 0) out[b] = best;
  }
}

__global__ void fits_kernel(Grid p, const int32_t* __restrict__ counts, int B,
                            uint8_t* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)B * p.T) return;
  const int64_t b = idx / p.T;
  const int t = (int)(idx - b * p.T);
  const float* used = p.used + b * p.used_stride;
  const int c = counts[b];
  bool any = false;
  for (int g = 0; g < p.GR && !any; ++g) {
    if (!p.group_valid[(int64_t)t * p.GR + g]) continue;
    if (!offering(p, b, t, g)) continue;
    any = fits_at(used, p.req, p.alloc + ((int64_t)t * p.GR + g) * p.R, p.R, c);
  }
  out[idx] = any ? 1 : 0;
}

}  // namespace

extern "C" int fill_count_grid(int mode, const void* alloc,
                               const void* group_valid, const void* zc_avail,
                               const void* req, const void* used,
                               int64_t used_stride, const void* zmask,
                               const void* cmask, int64_t mask_stride,
                               int gate_offering, const void* viable,
                               const void* counts, int B, int T, int GR, int R,
                               int Z, int C, void* out, void* stream) {
  if (R > kMaxR) return (int)cudaErrorInvalidValue;
  Grid p{(const float*)alloc,  (const uint8_t*)group_valid,
         (const uint8_t*)zc_avail, (const float*)req,
         (const float*)used,   (const uint8_t*)zmask,
         (const uint8_t*)cmask, used_stride,
         mask_stride,          T,
         GR,                   R,
         Z,                    C,
         gate_offering};
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) {
    max_count_kernel<<<B, 256, 0, s>>>(p, (const uint8_t*)viable, B,
                                       (int32_t*)out);
  } else {
    const int64_t n = (int64_t)B * T;
    if (n == 0) return 0;
    const int threads = 256;
    fits_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
        p, (const int32_t*)counts, B, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fill_count_grid_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
