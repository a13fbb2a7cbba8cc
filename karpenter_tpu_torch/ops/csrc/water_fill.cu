// H3 water_fill — replaces the JAX package's ops/solver.py `_water_fill`
// (solver.py:1402): distribute `rem` pods over N claims fewest-pods-first
// with earliest-slot tie-break, in closed form.
//
//   f     = min(f, rem)
//   L     = smallest level with sum(min(f, max(0, L - p))) >= rem, found by
//           exactly 24 bisection steps on [0, max(p) + rem + 1]
//   base  = min(f, max(0, L - 1 - p));  r0 = rem - sum(base)
//   elig  = (f > 0) & (p + base == L - 1) & (base < f)
//   fill  = base + (elig & exclusive_rank(elig) < r0)
//   out   = sum(f) <= rem ? f : fill
// All sums are int32 with two's-complement wrap, as in the reference.
//
// Bound on an H100: reads p and f and writes the result, 48 KB at
// N=4096, about 15 ns of memory time; the 24 dependent block-wide
// reductions make it latency-bound. Design: one block of 1024 threads, each
// owning a contiguous chunk of N (so the exclusive rank is a chunk-local
// walk after one block scan; any N works, the chunks re-read p and f from
// L1/L2 on each bisection step); `rem` is read from device memory, so the
// solve never syncs with the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ unsigned block_sum(unsigned v, unsigned* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

__device__ int block_max(int v, int* red) {
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : INT32_MIN;
    for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// exclusive prefix sum of one value per thread, in thread order
__device__ int block_exclusive_scan(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  __syncthreads();
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int w = lane < nw ? red[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += n;
    }
    if (lane < nw) red[lane] = w;  // inclusive warp totals
  }
  __syncthreads();
  const int warp_off = warp > 0 ? red[warp - 1] : 0;
  return warp_off + incl - v;
}

__global__ void water_fill_kernel(const int32_t* __restrict__ p,
                                  const int32_t* __restrict__ f_in,
                                  const int32_t* __restrict__ rem_ptr, int N,
                                  int32_t* __restrict__ out) {
  __shared__ unsigned ured[32];
  __shared__ int ired[32];
  const int rem = *rem_ptr;
  const int per = (N + blockDim.x - 1) / blockDim.x;
  const int lo_i = min(N, (int)threadIdx.x * per);
  const int hi_i = min(N, lo_i + per);
  unsigned tot = 0;
  int pmax = INT32_MIN;
  for (int i = lo_i; i < hi_i; ++i) {
    tot += (unsigned)min(f_in[i], rem);
    pmax = max(pmax, p[i]);
  }
  const int total = (int)block_sum(tot, ured);
  pmax = block_max(pmax, ired);
  int lo = 0;
  int hi = (int)((unsigned)pmax + (unsigned)rem + 1u);
  for (int it = 0; it < 24; ++it) {
    const int mid = (int)(((long long)lo + (long long)hi) >> 1);
    unsigned s = 0;
    for (int i = lo_i; i < hi_i; ++i)
      s += (unsigned)min(min(f_in[i], rem), max(0, mid - p[i]));
    const bool geq = (int)block_sum(s, ured) >= rem;
    if (geq) hi = mid; else lo = mid + 1;
  }
  const int L = lo;
  unsigned sb = 0;
  int n_elig = 0;
  for (int i = lo_i; i < hi_i; ++i) {
    const int f = min(f_in[i], rem);
    const int base = min(f, max(0, (L - 1) - p[i]));
    sb += (unsigned)base;
    n_elig += (f > 0 && p[i] + base == L - 1 && base < f) ? 1 : 0;
  }
  const int r0 = rem - (int)block_sum(sb, ured);
  int rank = block_exclusive_scan(n_elig, ired);
  for (int i = lo_i; i < hi_i; ++i) {
    const int f = min(f_in[i], rem);
    const int base = min(f, max(0, (L - 1) - p[i]));
    const bool elig = f > 0 && p[i] + base == L - 1 && base < f;
    const int extra = (elig && rank < r0) ? 1 : 0;
    rank += elig ? 1 : 0;
    out[i] = total <= rem ? f : base + extra;
  }
}

}  // namespace

extern "C" int water_fill(const void* p, const void* f, const void* rem, int N,
                          void* out, void* stream) {
  if (N == 0) return 0;
  water_fill_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)p, (const int32_t*)f, (const int32_t*)rem, N,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* water_fill_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
