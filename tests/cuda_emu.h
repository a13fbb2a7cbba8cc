// A CPU stand-in for the CUDA features karpenter_tpu_torch/ops/csrc/perpod_scan.cu,
// objective_verdict.cu, kscan_pod_loop.cu, fill_count_grid.cu, wire_pack.cu,
// gang_scan.cu, retract_tail.cu, req_intersects.cu, compact_scatter.cu,
// water_fill.cu and kscan_grid.cu use, so that their kernels can run on
// the host against the plain versions (tests/test_torch_*_emulated.py).
// One fiber per CUDA thread, all on the thread that launches the grid, the
// blocks of a grid one after another. A fiber runs until it waits at a
// barrier (__syncthreads, the warp collectives, the named barrier); the
// last to arrive releases the others, which then run in an order shuffled
// from a fixed seed, so that a read that lacks its barrier meets the write
// in some orders and misses it in others, run after run the same. A launch
// whose unfinished fibers all wait is a deadlock: the launch stops, and
// cudaGetLastError and the library's emu_error report it. __shared__
// variables become statics, which the blocks share, run in turn. The bulk
// copy and the mbarrier are replaced by a memcpy and a barrier in the
// test's rewrite of the source. No fiber is preempted, so each barrier
// orders the writes before it before the reads after it, as
// __syncthreads and __syncwarp do.
#pragma once
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <sys/mman.h>
#include <ucontext.h>
#include <utility>
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
// 1 once a launch of the library deadlocked, until the test reads it
extern "C" {
inline int emu_error = 0;
}
inline int cudaGetLastError() { return emu_error ? cudaErrorInvalidValue : cudaSuccess; }
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
struct uint4 {
  unsigned x, y, z, w;
};
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

extern thread_local int tl_parity;

// the fibers of the block that runs (one per CUDA thread) and their run queue
struct EmuFiber {
  ucontext_t ctx;
  char* stack;
  int parity;  // the fiber's tl_parity while another runs
};
struct EmuSched {
  ucontext_t launcher;
  std::vector<EmuFiber> f;
  std::vector<int> run;  // runnable fibers, taken from the back
  int cur = -1, live = 0;
  bool deadlock = false;
  uint64_t rng = 0x9E3779B97F4A7C15ull;  // the fixed seed of the release order
  void (*body)(void*) = nullptr;
  void* arg = nullptr;
};
inline thread_local EmuSched* g_sched = nullptr;

// switch from the running fiber to the next runnable one, or back to the
// launcher when the block is done or deadlocked
inline void emu_switch(bool finished) {
  EmuSched& s = *g_sched;
  const int from = s.cur;
  s.f[from].parity = tl_parity;
  if (s.run.empty()) {
    s.deadlock = s.live > 0;
    s.cur = -1;
    swapcontext(&s.f[from].ctx, &s.launcher);  // never resumed
    return;
  }
  const int to = s.run.back();
  s.run.pop_back();
  s.cur = to;
  threadIdx = Dim{(unsigned)to, 0, 0};
  tl_parity = s.f[to].parity;
  if (finished) {
    setcontext(&s.f[to].ctx);
  } else {
    swapcontext(&s.f[from].ctx, &s.f[to].ctx);
  }
}

// std::barrier's arrive_and_wait over the fibers: the last to arrive goes on
// and makes the others runnable, in a shuffled order
struct EmuBarrier {
  explicit EmuBarrier(int n) : n(n) {}
  int n, count = 0;
  std::vector<int> waiters;
  void arrive_and_wait() {
    EmuSched& s = *g_sched;
    if (++count < n) {
      waiters.push_back(s.cur);
      emu_switch(false);
      return;
    }
    count = 0;
    for (size_t i = waiters.size(); i > 1; --i) {
      s.rng ^= s.rng << 13;
      s.rng ^= s.rng >> 7;
      s.rng ^= s.rng << 17;
      std::swap(waiters[i - 1], waiters[s.rng % i]);
    }
    s.run.insert(s.run.begin(), waiters.begin(), waiters.end());
    waiters.clear();
  }
};

// one block's synchronisation state and dynamic shared memory
struct EmuBlock {
  std::unique_ptr<EmuBarrier> block;
  std::vector<std::unique_ptr<EmuBarrier>> warp;
  std::atomic<int> acc[2];
  int slot_i[64][32];
  float slot_f[64][32];
  std::vector<char> smem;
  // a named barrier (bar.sync 1, n): built by its first caller with its count
  std::unique_ptr<EmuBarrier> named;
};
extern EmuBlock* g_emu;

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
// give way up to `rounds` times, how many drawn from the fixed seed: each
// time the running fiber goes behind every runnable one (the fibers
// released at a barrier too), so that the fibers interleave where a test's
// rewrite of a source calls it. Around each write of a copy to shared
// memory, a read that lacks the copy's barrier then runs before some
// writes, and a read of the old contents that the barrier before the copy
// should protect runs after some.
inline void emu_yield(int rounds) {
  EmuSched& s = *g_sched;
  s.rng ^= s.rng << 13;
  s.rng ^= s.rng >> 7;
  s.rng ^= s.rng << 17;
  const int n = (int)(s.rng % (uint64_t)(rounds + 1));
  for (int r = 0; r < n && !s.run.empty(); ++r) {
    s.run.insert(s.run.begin(), s.cur);
    emu_switch(false);
  }
}
// bar.sync 1, n: the n threads that reach it (the rest of the block may
// have returned); every call of a launch passes the same n
inline void emu_named_sync(int n) {
  if (!g_emu->named) g_emu->named = std::make_unique<EmuBarrier>(n);
  g_emu->named->arrive_and_wait();
}

// a fiber's stack: 8 MB as a std::thread's, only the pages it touches
// backed, and a guard page below it. A launch maps its fibers' stacks and
// unmaps them when it ends, as threads' stacks come and go: a process that
// also runs JAX holds tens of thousands of mappings, near the kernel's
// limit per process, and stacks kept between launches pushed it over.
constexpr size_t kEmuStack = 8u << 20;

inline void emu_fiber_main() {
  EmuSched& s = *g_sched;
  s.body(s.arg);
  --s.live;
  emu_switch(true);
}

// fn<<<grid, threads, smem>>>(args...): the blocks in turn, each with its
// own fibers; dynamic shared memory starts filled with a byte pattern, so
// that a read before a write shows
template <class F, class... A>
void emu_launch(F fn, int grid, int threads, size_t smem, A... args) {
  auto call = [&]() { fn(args...); };
  EmuSched s;
  s.body = [](void* c) { (*static_cast<decltype(call)*>(c))(); };
  s.arg = &call;
  s.f.resize(threads);
  const size_t stacks_bytes = kEmuStack * threads;
  void* stacks = mmap(nullptr, stacks_bytes, PROT_READ | PROT_WRITE, MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE,
                      -1, 0);
  if (stacks == MAP_FAILED) abort();
  for (int t = 0; t < threads; ++t) {
    s.f[t].stack = static_cast<char*>(stacks) + kEmuStack * t;
    mprotect(s.f[t].stack, 4096, PROT_NONE);
  }
  EmuSched* outer = g_sched;
  g_sched = &s;
  for (int b = 0; b < grid && !s.deadlock; ++b) {
    EmuBlock e;
    e.block = std::make_unique<EmuBarrier>(threads);
    for (int w = 0; w < threads / 32; ++w) e.warp.push_back(std::make_unique<EmuBarrier>(32));
    e.acc[0] = 0;
    e.acc[1] = 0;
    e.smem.assign(smem + 64, (char)0xCD);
    g_emu = &e;
    blockDim = Dim{(unsigned)threads, 1, 1};
    blockIdx = Dim{(unsigned)b, 0, 0};
    s.run.clear();
    for (int t = threads - 1; t >= 0; --t) {  // thread 0 first
      EmuFiber& f = s.f[t];
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack + 4096;
      f.ctx.uc_stack.ss_size = kEmuStack - 4096;
      f.ctx.uc_link = nullptr;
      makecontext(&f.ctx, emu_fiber_main, 0);
      f.parity = 0;
      s.run.push_back(t);
    }
    s.live = threads;
    s.cur = s.run.back();
    s.run.pop_back();
    threadIdx = Dim{(unsigned)s.cur, 0, 0};
    tl_parity = 0;
    swapcontext(&s.launcher, &s.f[s.cur].ctx);
    g_emu = nullptr;
  }
  if (s.deadlock) emu_error = 1;
  g_sched = outer;
  munmap(stacks, stacks_bytes);
}

// atomics and fences (objective_verdict.cu's last-block fold); the
// emulator runs a grid's blocks one after another, and a block's fibers on
// one thread
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
inline int __shfl_up_sync(unsigned, int v, int d) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_i[w][l] = v;
  __syncwarp();
  const int r = l >= d ? g_emu->slot_i[w][l - d] : v;
  __syncwarp();
  return r;
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_i[w][l] = (int)v;
  __syncwarp();
  unsigned s = 0;
  for (int i = 0; i < 32; ++i) s += (unsigned)g_emu->slot_i[w][i];
  __syncwarp();
  return s;
}
inline int __reduce_max_sync(unsigned, int v) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_i[w][l] = v;
  __syncwarp();
  int m = g_emu->slot_i[w][0];
  for (int i = 1; i < 32; ++i) m = m > g_emu->slot_i[w][i] ? m : g_emu->slot_i[w][i];
  __syncwarp();
  return m;
}
// Hopper DPX: max(min(a + b, c), 0), the add in 32 bits
inline int __viaddmin_s32_relu(int a, int b, int c) {
  const int s = (int)((unsigned)a + (unsigned)b);
  const int m = s < c ? s : c;
  return m > 0 ? m : 0;
}
