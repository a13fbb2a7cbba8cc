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
// grid, about 2.5 us of memory time; the per-cell arithmetic (R = 4,
// three verification passes, D offering tests) is well under the f32
// rate. Design: modes 0/1 run one block per row n whose threads stride
// over t, keep a per-domain running max in registers (D <= 16) and
// reduce it through warp shuffles; mode 2 runs one thread per (n, t).

#include <cuda_runtime.h>
#include <stdint.h>

#include "count_cell.cuh"

namespace {

using ktpu::cell_count;
using ktpu::kMaxR;

constexpr int kMaxD = 16;  // KSCAN_D

struct KGrid {
  const float* alloc;          // [T, GR, R]
  const uint8_t* group_valid;  // [T, GR]
  const uint8_t* zc_avail;     // [T, GR, Z, C]
  const float* req;            // [R]
  const float* used;           // [N, R]
  const uint8_t* viable;       // [N, T]
  const uint8_t* zmask;        // row n at zmask + n*mask_stride
  const uint8_t* cmask;        // row n at cmask + n*mask_stride
  const uint8_t* it_def;       // defined[t, key] at it_def + t*it_def_stride
  const uint8_t* it_mask;      // mask[t, key, :] at it_mask + t*it_mask_stride
  const uint8_t* zset;         // [N, D] final domains (mode 2, key = zone)
  const int32_t* placed;       // [N] (mode 2)
  int32_t* grid;               // [N, T, GR]
  int64_t mask_stride, it_def_stride, it_mask_stride;
  int N, T, GR, R, Z, C, D;
  int key_is_zone;
};

// any over (z, c) of zc[z, c] & zm[z] & cm[c], z < zlim
__device__ __forceinline__ bool any_offering(const uint8_t* zc, const uint8_t* zm,
                                             const uint8_t* cm, int Z, int C,
                                             int zlim) {
  for (int z = 0; z < Z && z < zlim; ++z) {
    if (!zm[z]) continue;
    for (int c = 0; c < C; ++c)
      if (zc[z * C + c] && cm[c]) return true;
  }
  return false;
}

__global__ void grid_capd_kernel(KGrid p, int compute, int32_t* __restrict__ capd) {
  const int64_t n = blockIdx.x;
  float u[kMaxR], q[kMaxR];
  for (int r = 0; r < p.R; ++r) {
    u[r] = p.used[n * p.R + r];
    q[r] = p.req[r];
  }
  const uint8_t* zm = p.zmask + n * p.mask_stride;
  const uint8_t* cm = p.cmask + n * p.mask_stride;
  int best[kMaxD];
  for (int d = 0; d < kMaxD; ++d) best[d] = 0;
  for (int t = threadIdx.x; t < p.T; t += blockDim.x) {
    const bool vi = p.viable[n * p.T + t] != 0;
    uint32_t admit = 0;
    if (!p.it_def[(int64_t)t * p.it_def_stride]) {
      admit = (p.D >= 32) ? 0xffffffffu : ((1u << p.D) - 1u);
    } else {
      const uint8_t* im = p.it_mask + (int64_t)t * p.it_mask_stride;
      for (int d = 0; d < p.D; ++d)
        if (im[d]) admit |= 1u << d;
    }
    for (int g = 0; g < p.GR; ++g) {
      const int64_t cell = (n * p.T + t) * p.GR + g;
      int c;
      if (compute) {
        c = 0;
        if (p.group_valid[(int64_t)t * p.GR + g])
          c = cell_count(u, q, p.alloc + ((int64_t)t * p.GR + g) * p.R, p.R);
        p.grid[cell] = c;
      } else {
        c = p.grid[cell];
      }
      if (!vi || !admit) continue;
      const uint8_t* zc = p.zc_avail + ((int64_t)t * p.GR + g) * p.Z * p.C;
      if (p.key_is_zone) {
        for (int d = 0; d < p.D; ++d) {
          if (!((admit >> d) & 1u)) continue;
          bool off = false;
          for (int cc = 0; cc < p.C && !off; ++cc) off = zc[d * p.C + cc] && cm[cc];
          if (off) best[d] = max(best[d], c);
        }
      } else if (any_offering(zc, zm, cm, p.Z, p.C, p.Z)) {
        for (int d = 0; d < p.D; ++d)
          if ((admit >> d) & 1u) best[d] = max(best[d], c);
      }
    }
  }
  __shared__ int warp_best[32][kMaxD];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  for (int d = 0; d < p.D; ++d) {
    int b = best[d];
    for (int off = 16; off > 0; off >>= 1) b = max(b, __shfl_down_sync(0xffffffffu, b, off));
    if (lane == 0) warp_best[warp][d] = b;
  }
  __syncthreads();
  if (warp == 0) {
    for (int d = 0; d < p.D; ++d) {
      int b = lane < nw ? warp_best[lane][d] : 0;
      for (int off = 16; off > 0; off >>= 1) b = max(b, __shfl_down_sync(0xffffffffu, b, off));
      if (lane == 0) capd[n * p.D + d] = b;
    }
  }
}

__global__ void fits_final_kernel(KGrid p, uint8_t* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)p.N * p.T) return;
  const int64_t n = idx / p.T;
  const int t = (int)(idx - n * p.T);
  const int need = p.placed[n];
  const uint8_t* cm = p.cmask + n * p.mask_stride;
  const uint8_t* zm = p.key_is_zone ? p.zset + n * p.D : p.zmask + n * p.mask_stride;
  const int zlim = p.key_is_zone ? p.D : p.Z;
  bool any = false;
  for (int g = 0; g < p.GR && !any; ++g) {
    if (p.grid[idx * p.GR + g] < need) continue;
    any = any_offering(p.zc_avail + ((int64_t)t * p.GR + g) * p.Z * p.C, zm, cm, p.Z, p.C, zlim);
  }
  out[idx] = any ? 1 : 0;
}

}  // namespace

// ptrs (host array of device pointers), in order: alloc, group_valid,
// zc_avail, req, used, viable, zmask, cmask, it_def, it_mask, zset,
// placed, grid, out (capd for modes 0/1, the fits mask for mode 2).
// dims: N, T, GR, R, Z, C, D, key_is_zone, mask_stride, it_def_stride,
// it_mask_stride.
extern "C" int kscan_grid(int mode, const int64_t* ptrs, const int64_t* dims,
                          void* stream) {
  KGrid p;
  p.alloc = (const float*)ptrs[0];
  p.group_valid = (const uint8_t*)ptrs[1];
  p.zc_avail = (const uint8_t*)ptrs[2];
  p.req = (const float*)ptrs[3];
  p.used = (const float*)ptrs[4];
  p.viable = (const uint8_t*)ptrs[5];
  p.zmask = (const uint8_t*)ptrs[6];
  p.cmask = (const uint8_t*)ptrs[7];
  p.it_def = (const uint8_t*)ptrs[8];
  p.it_mask = (const uint8_t*)ptrs[9];
  p.zset = (const uint8_t*)ptrs[10];
  p.placed = (const int32_t*)ptrs[11];
  p.grid = (int32_t*)ptrs[12];
  void* out = (void*)ptrs[13];
  p.N = (int)dims[0];
  p.T = (int)dims[1];
  p.GR = (int)dims[2];
  p.R = (int)dims[3];
  p.Z = (int)dims[4];
  p.C = (int)dims[5];
  p.D = (int)dims[6];
  p.key_is_zone = (int)dims[7];
  p.mask_stride = dims[8];
  p.it_def_stride = dims[9];
  p.it_mask_stride = dims[10];
  if (p.R > kMaxR || p.D > kMaxD || p.D < 1) return (int)cudaErrorInvalidValue;
  if (p.N == 0 || p.T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0 || mode == 1) {
    grid_capd_kernel<<<p.N, 256, 0, s>>>(p, mode == 0, (int32_t*)out);
  } else {
    const int64_t n = (int64_t)p.N * p.T;
    const int threads = 256;
    fits_final_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
        p, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kscan_grid_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
