// A CPU stand-in for the CUDA features karpenter_tpu_torch/ops/csrc/perpod_scan.cu,
// objective_verdict.cu, kscan_pod_loop.cu, fill_count_grid.cu, wire_pack.cu,
// gang_scan.cu and retract_tail.cu use, so that their kernels can run on
// the host against the plain versions (tests/test_torch_*_emulated.py). One std::thread per CUDA thread,
// the blocks of a grid one after another; std::barrier stands in for
// __syncthreads and for the warp collectives; __shared__ variables become
// statics, which the blocks share, run in turn. The bulk copy and the
// mbarrier are replaced by a memcpy and a barrier in the test's rewrite of
// the source. Memory order: std::barrier orders each phase's writes before
// the next phase's reads, as __syncthreads and __syncwarp do.
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __grid_constant__
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
struct cudaFuncAttributes {
  size_t sharedSizeBytes;
};
template <class F>
inline int cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  a->sharedSizeBytes = 8192;
  return 0;
}
template <class F>
inline int cudaFuncSetAttribute(F, int, int bytes) {
  return bytes > 232448 ? cudaErrorInvalidValue : cudaSuccess;
}
inline int cudaGetLastError() { return cudaSuccess; }
// the device: two SMs, so that a persistent grid still has several blocks
constexpr int cudaDevAttrMultiProcessorCount = 16;
inline int cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline int cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMultiProcessorCount ? 2 : 0;
  return cudaSuccess;
}
template <class F>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
inline const char* cudaGetErrorString(int e) { return e ? "invalid value" : "no error"; }

struct Dim {
  unsigned x, y, z;
};
struct int4 {
  int x, y, z, w;
};
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }
struct float4 {
  float x, y, z, w;
};
extern thread_local Dim threadIdx, blockIdx;
extern Dim blockDim;

template <class T>
inline T min(T a, T b) { return a < b ? a : b; }
template <class T>
inline T max(T a, T b) { return a > b ? a : b; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
// IEEE single-rounding arithmetic (count_cell.cuh); never contracted here
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline uint32_t __cvta_generic_to_shared(const void*) { return 0; }

// one block's synchronisation state and dynamic shared memory
struct EmuBlock {
  std::unique_ptr<std::barrier<>> block;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
  std::atomic<int> acc[2];
  int slot_i[64][32];
  float slot_f[64][32];
  std::vector<char> smem;
  // a named barrier (bar.sync 1, n): built by its first caller with its count
  std::mutex named_mu;
  std::unique_ptr<std::barrier<>> named;
};
extern EmuBlock* g_emu;
extern thread_local int tl_parity;

inline void __syncthreads() { g_emu->block->arrive_and_wait(); }
inline int __syncthreads_or(int x) {
  const int g = (tl_parity ^= 1);
  if (x) g_emu->acc[g].store(1);
  __syncthreads();
  const int r = g_emu->acc[g].load();
  __syncthreads();
  if (threadIdx.x == 0) g_emu->acc[g].store(0);
  return r;
}
inline void __syncwarp() { g_emu->warp[threadIdx.x / 32]->arrive_and_wait(); }
inline unsigned __ballot_sync(unsigned, int x) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_i[w][l] = x != 0;
  __syncwarp();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (unsigned)g_emu->slot_i[w][i] << i;
  __syncwarp();
  return m;
}
inline int __any_sync(unsigned mask, int x) { return __ballot_sync(mask, x) != 0; }
template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_i[w][l] = (int)v;
  __syncwarp();
  const T r = (T)g_emu->slot_i[w][src];
  __syncwarp();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_f[w][l] = v;
  __syncwarp();
  const float r = g_emu->slot_f[w][l ^ o];
  __syncwarp();
  return r;
}
inline int __shfl_xor_sync(unsigned, int v, int o) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_i[w][l] = v;
  __syncwarp();
  const int r = g_emu->slot_i[w][l ^ o];
  __syncwarp();
  return r;
}
inline char* emu_smem() { return g_emu->smem.data(); }
// bar.sync 1, n: the n threads that reach it (the rest of the block may
// have returned); every call of a launch passes the same n
inline void emu_named_sync(int n) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> lk(g_emu->named_mu);
    if (!g_emu->named) g_emu->named = std::make_unique<std::barrier<>>(n);
    b = g_emu->named.get();
  }
  b->arrive_and_wait();
}

// fn<<<grid, threads, smem>>>(args...): the blocks in turn, each with its
// own threads; dynamic shared memory starts filled with a byte pattern, so
// that a read before a write shows
template <class F, class... A>
void emu_launch(F fn, int grid, int threads, size_t smem, A... args) {
  for (int b = 0; b < grid; ++b) {
    EmuBlock e;
    e.block = std::make_unique<std::barrier<>>(threads);
    for (int w = 0; w < threads / 32; ++w) e.warp.push_back(std::make_unique<std::barrier<>>(32));
    e.acc[0] = 0;
    e.acc[1] = 0;
    e.smem.assign(smem + 64, (char)0xCD);
    g_emu = &e;
    blockDim = Dim{(unsigned)threads, 1, 1};
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t, b]() {
        threadIdx = Dim{(unsigned)t, 0, 0};
        blockIdx = Dim{(unsigned)b, 0, 0};
        tl_parity = 0;
        fn(args...);
      });
    for (auto& t : ts) t.join();
    g_emu = nullptr;
  }
}

// atomics and fences (objective_verdict.cu's last-block fold); the
// emulator runs a grid's blocks one after another
inline int atomicAdd(int* p, int v) { return reinterpret_cast<std::atomic<int>*>(p)->fetch_add(v); }
inline int atomicMax(int* p, int v) {
  auto* a = reinterpret_cast<std::atomic<int>*>(p);
  int old = a->load();
  while (old < v && !a->compare_exchange_weak(old, v)) {
  }
  return old;
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return reinterpret_cast<std::atomic<unsigned>*>(p)->fetch_or(v);
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline int __reduce_min_sync(unsigned, int v) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_i[w][l] = v;
  __syncwarp();
  int m = g_emu->slot_i[w][0];
  for (int i = 1; i < 32; ++i) m = m < g_emu->slot_i[w][i] ? m : g_emu->slot_i[w][i];
  __syncwarp();
  return m;
}
inline int __shfl_down_sync(unsigned, int v, int d) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_i[w][l] = v;
  __syncwarp();
  const int r = l + d < 32 ? g_emu->slot_i[w][l + d] : v;
  __syncwarp();
  return r;
}
