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
// test's rewrite of the source, or, where warps hand work to each other,
// by the emulator's mbarrier (emu_mbar_*: a wait blocks its fiber until
// the phase completes). No fiber is preempted, so each barrier orders the
// writes before it before the reads after it, as __syncthreads and
// __syncwarp do. The warp collectives (ballots, shuffles, reductions)
// make a warp's lanes meet as on the card, but on the card they do not
// order memory: a lane's store after a ballot may land before another
// lane's load before it. The emulator cannot run a load late, so it
// checks that rule where a test's rewrite names the accesses
// (emu_note_read / emu_note_write): two accesses to one address by two
// lanes of a warp, one of them a store, with no __syncwarp or
// __syncthreads between them, set emu_race, which fails the test; so does
// an mbarrier used before its init.
#pragma once
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <sys/mman.h>
#include <ucontext.h>
#include <unordered_map>
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
// 1 once a launch of the library deadlocked, until the test reads it;
// emu_race: 1 once two lanes of a warp raced on a noted address
extern "C" {
inline int emu_error = 0;
inline int emu_race = 0;
}
inline int cudaGetLastError() { return emu_error || emu_race ? cudaErrorInvalidValue : cudaSuccess; }
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
constexpr int cudaMemcpyHostToDevice = 1;
inline int cudaMemcpyAsync(void* dst, const void* src, size_t bytes, int, cudaStream_t) {
  memcpy(dst, src, bytes);
  return cudaSuccess;
}

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
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return uint4{x, y, z, w}; }
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
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline unsigned __brev(unsigned x) {
  x = ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
  x = ((x >> 2) & 0x33333333u) | ((x & 0x33333333u) << 2);
  x = ((x >> 4) & 0x0f0f0f0fu) | ((x & 0x0f0f0f0fu) << 4);
  return __builtin_bswap32(x);
}
// byte i of the result is byte (s >> 4i) & 7 of the 8 bytes y:x
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i) r |= (unsigned)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}
// IEEE single-rounding arithmetic (count_cell.cuh); never contracted here
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __float_as_int(float x) {
  int i;
  memcpy(&i, &x, 4);
  return i;
}
inline float __int_as_float(int i) {
  float x;
  memcpy(&x, &i, 4);
  return x;
}
inline uint32_t __cvta_generic_to_shared(const void*) { return 0; }

extern thread_local int tl_parity;

// the fibers of the block that runs (one per CUDA thread) and their run queue
struct EmuFiber {
  ucontext_t ctx;
  char* stack;
  int parity;  // the fiber's tl_parity while another runs
};
// a store, an integer add or a bitwise or to device memory that other
// blocks read after a ticket (emu_xstore / emu_xadd / emu_xor), not yet
// visible to them
struct EmuPending {
  void* dst;
  std::vector<char> bytes;  // the stored value, or the 32-bit operand
  int op;                   // 0 store, 1 add, 2 or
};
struct EmuSched {
  ucontext_t launcher;
  // the cross-block memory model (emu_xstore and below): stores that land
  // only when the launch ends, and each landed store's previous bytes
  std::vector<EmuPending> late;
  std::vector<EmuPending> stale;
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
  // on_done: run by the last to arrive before it releases the others (a
  // barrier that orders memory starts a new epoch there)
  void arrive_and_wait(void (*on_done)() = nullptr) {
    EmuSched& s = *g_sched;
    if (++count < n) {
      waiters.push_back(s.cur);
      emu_switch(false);
      return;
    }
    if (on_done) on_done();
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

// an mbarrier: `count` arrivals complete a phase; a wait on a parity
// blocks while the barrier's current phase has that parity
struct EmuMbar {
  int count = 1, pending = 1, phase = 0;
  int64_t tx = 0;  // bytes the phase still expects from bulk copies
  std::vector<int> waiters;
  struct Copy {
    void* dst;
    const void* src;
    size_t bytes;
  };
  std::vector<Copy> copies;  // bulk copies issued, not landed yet
};
// the last accesses to a noted address (emu_note_*): the warp's epoch of
// the last store and its lane, and the lanes that loaded in that epoch
struct EmuAccess {
  int warp = -1, w_lane = -1, w_epoch = -1, r_epoch = -1;
  uint32_t r_lanes = 0;
};

// one block's synchronisation state and dynamic shared memory
struct EmuBlock {
  std::unique_ptr<EmuBarrier> block;
  std::vector<std::unique_ptr<EmuBarrier>> warp;
  std::vector<int> epoch;  // per warp: barriers that ordered its memory
  std::unordered_map<const void*, EmuMbar> mbar;
  std::unordered_map<const void*, EmuAccess> access;
  std::atomic<int> acc[2];
  int slot_i[64][32];
  float slot_f[64][32];
  std::vector<char> smem;
  // a named barrier (bar.sync 1, n): built by its first caller with its count
  std::unique_ptr<EmuBarrier> named;
  // the cross-block memory model: per thread, its stores not yet fenced
  // and whether it fenced after the block took its ticket
  std::vector<std::vector<EmuPending>> pending;
  std::vector<char> acquired;
  bool ticketed = false;
};
extern EmuBlock* g_emu;

inline void emu_new_epoch_all() {
  for (int& e : g_emu->epoch) ++e;
}
inline void emu_new_epoch_warp() { ++g_emu->epoch[threadIdx.x / 32]; }
inline void __syncthreads() { g_emu->block->arrive_and_wait(emu_new_epoch_all); }
inline int __syncthreads_or(int x) {
  const int g = (tl_parity ^= 1);
  if (x) g_emu->acc[g].store(1);
  __syncthreads();
  const int r = g_emu->acc[g].load();
  __syncthreads();
  if (threadIdx.x == 0) g_emu->acc[g].store(0);
  return r;
}
// the lanes of a warp meet (the collectives below, which do not order memory)
inline void emu_warp_meet() { g_emu->warp[threadIdx.x / 32]->arrive_and_wait(); }
inline void __syncwarp() { g_emu->warp[threadIdx.x / 32]->arrive_and_wait(emu_new_epoch_warp); }
inline unsigned __ballot_sync(unsigned, int x) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_i[w][l] = x != 0;
  emu_warp_meet();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (unsigned)g_emu->slot_i[w][i] << i;
  emu_warp_meet();
  return m;
}
inline int __all_sync(unsigned mask, int x) { return __ballot_sync(mask, x) == 0xffffffffu; }
inline int __any_sync(unsigned mask, int x) { return __ballot_sync(mask, x) != 0; }
template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_i[w][l] = (int)v;
  emu_warp_meet();
  const T r = (T)g_emu->slot_i[w][src];
  emu_warp_meet();
  return r;
}
inline float __shfl_sync(unsigned, float v, int src) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_f[w][l] = v;
  emu_warp_meet();
  const float r = g_emu->slot_f[w][src];
  emu_warp_meet();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_f[w][l] = v;
  emu_warp_meet();
  const float r = g_emu->slot_f[w][l ^ o];
  emu_warp_meet();
  return r;
}
inline int __shfl_xor_sync(unsigned, int v, int o) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_i[w][l] = v;
  emu_warp_meet();
  const int r = g_emu->slot_i[w][l ^ o];
  emu_warp_meet();
  return r;
}
inline long long __shfl_xor_sync(unsigned m, long long v, int o) {
  const unsigned lo = (unsigned)__shfl_xor_sync(m, (int)(v & 0xffffffff), o);
  const unsigned hi = (unsigned)__shfl_xor_sync(m, (int)(v >> 32), o);
  return (long long)(((unsigned long long)hi << 32) | lo);
}
inline double __shfl_xor_sync(unsigned m, double v, int o) {
  long long b;
  memcpy(&b, &v, 8);
  b = __shfl_xor_sync(m, b, o);
  memcpy(&v, &b, 8);
  return v;
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

// an mbarrier in shared memory (the kernel's 64-bit word), for the
// helpers a test's rewrite swaps in: init with the arrivals a phase
// takes; a phase completes when they have arrived and the bytes announced
// by emu_mbar_arrive_tx have landed, and its waiters become runnable, in a
// shuffled order; a wait on `parity` gives way first (up to 8 rounds),
// then blocks while the current phase has that parity (the PTX
// try_wait.parity loop). A bulk copy (emu_bulk_copy) lands only when a
// fiber waits on its barrier: a read of its bytes that lacks the wait
// meets the old contents, as it may on the card.
inline void emu_mbar_init(const void* bar, int count) {
  EmuMbar& m = g_emu->mbar[bar];
  m = EmuMbar();
  m.count = m.pending = count;
}
inline void emu_mbar_complete(EmuMbar& m) {
  if (m.pending > 0 || m.tx > 0) return;
  m.pending = m.count;
  ++m.phase;
  EmuSched& s = *g_sched;
  for (size_t i = m.waiters.size(); i > 1; --i) {
    s.rng ^= s.rng << 13;
    s.rng ^= s.rng >> 7;
    s.rng ^= s.rng << 17;
    std::swap(m.waiters[i - 1], m.waiters[s.rng % i]);
  }
  s.run.insert(s.run.begin(), m.waiters.begin(), m.waiters.end());
  m.waiters.clear();
}
// a barrier by its address; one used before its init (a race with the
// thread that initialises it) sets emu_race
inline EmuMbar& emu_mbar_at(const void* bar) {
  auto it = g_emu->mbar.find(bar);
  if (it != g_emu->mbar.end()) return it->second;
  emu_race = 1;
  return g_emu->mbar[bar];
}
inline void emu_mbar_arrive(const void* bar) {
  EmuMbar& m = emu_mbar_at(bar);
  --m.pending;
  emu_mbar_complete(m);
}
inline void emu_mbar_arrive_tx(const void* bar, size_t bytes) {
  EmuMbar& m = emu_mbar_at(bar);
  m.tx += (int64_t)bytes;
  --m.pending;
  emu_mbar_complete(m);
}
inline void emu_bulk_copy(void* dst, const void* src, size_t bytes, const void* bar) {
  emu_mbar_at(bar).copies.push_back(EmuMbar::Copy{dst, src, bytes});
}
inline void emu_mbar_wait(const void* bar, unsigned parity) {
  emu_yield(8);
  EmuMbar& m = emu_mbar_at(bar);
  if (!m.copies.empty()) {
    for (const EmuMbar::Copy& c : m.copies) {
      memcpy(c.dst, c.src, c.bytes);
      m.tx -= (int64_t)c.bytes;
    }
    m.copies.clear();
    emu_mbar_complete(m);
  }
  while ((unsigned)(m.phase & 1) == parity) {
    m.waiters.push_back(g_sched->cur);
    emu_switch(false);
  }
}

// the memory-order check of the lanes of one warp (see the top of this
// file): a load of p after another lane's store to p, or a store to p
// after another lane's load or store of p, within one epoch of the warp
inline void emu_note_write(const void* p) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32, e = g_emu->epoch[w];
  EmuAccess& a = g_emu->access[p];
  if (a.warp == w && ((a.w_epoch == e && a.w_lane != l) || (a.r_epoch == e && (a.r_lanes & ~(1u << l)))))
    emu_race = 1;
  a.warp = w;
  a.w_lane = l;
  a.w_epoch = e;
}
inline void emu_note_read(const void* p) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32, e = g_emu->epoch[w];
  EmuAccess& a = g_emu->access[p];
  if (a.warp == w && a.w_epoch == e && a.w_lane != l) emu_race = 1;
  if (a.warp != w || a.r_epoch != e) a.r_lanes = 0;
  a.warp = w;
  a.r_epoch = e;
  a.r_lanes |= 1u << l;
}

// The memory model between blocks, for kernels whose last block folds what
// the others stored (a ticket): the blocks run one after another, so every
// store would be visible in time; the suites' rewrites route a kernel's
// cross-block stores, adds, ors, ticket and loads through these instead.
// A store (an add, an or) waits in its thread's list until that thread
// runs __threadfence; one its thread never fences, one not fenced yet when
// its block takes the ticket, or one made after that, lands only when the
// launch ends. A load by a thread that
// has not fenced since its block took the ticket returns the bytes the
// address held before this launch's first store there. So a missing fence
// on either side, or a ticket taken before the stores, gives the last
// block stale partials, as it may on the card.
inline void emu_land(EmuPending& x) {
  EmuPending old{x.dst, std::vector<char>(x.bytes.size()), 0};
  memcpy(old.bytes.data(), x.dst, x.bytes.size());
  g_sched->stale.push_back(std::move(old));
  if (x.op) {
    unsigned v, d;
    memcpy(&v, x.dst, 4);
    memcpy(&d, x.bytes.data(), 4);
    v = x.op == 1 ? v + d : v | d;
    memcpy(x.dst, &v, 4);
  } else {
    memcpy(x.dst, x.bytes.data(), x.bytes.size());
  }
}
inline std::vector<EmuPending>& emu_pending() {
  if (g_emu->pending.size() < blockDim.x) {
    g_emu->pending.resize(blockDim.x);
    g_emu->acquired.resize(blockDim.x, 0);
  }
  return g_emu->pending[threadIdx.x];
}
inline void emu_defer(EmuPending x) {
  if (g_emu->ticketed) {
    g_sched->late.push_back(std::move(x));
  } else {
    emu_pending().push_back(std::move(x));
  }
}
template <class T>
inline void emu_xstore(T* p, T v) {
  EmuPending x{p, std::vector<char>(sizeof(T)), 0};
  memcpy(x.bytes.data(), &v, sizeof(T));
  emu_defer(std::move(x));
}
inline void emu_xadd(int* p, int v) {
  EmuPending x{p, std::vector<char>(4), 1};
  memcpy(x.bytes.data(), &v, 4);
  emu_defer(std::move(x));
}
inline void emu_xor(unsigned* p, unsigned v) {
  EmuPending x{p, std::vector<char>(4), 2};
  memcpy(x.bytes.data(), &v, 4);
  emu_defer(std::move(x));
}
inline unsigned emu_ticket(unsigned* t) {
  g_emu->ticketed = true;
  // a store of the block that no fence of its thread published before the
  // ticket races with the ticket: it lands when the launch ends
  for (auto& p : g_emu->pending) {
    g_sched->late.insert(g_sched->late.end(), p.begin(), p.end());
    p.clear();
  }
  return reinterpret_cast<std::atomic<unsigned>*>(t)->fetch_add(1u);
}
template <class T>
inline T emu_xload(const T* p) {
  emu_pending();
  T v;
  memcpy(&v, p, sizeof(T));
  if (g_emu->acquired[threadIdx.x]) return v;
  const char* a = reinterpret_cast<const char*>(p);
  for (const EmuPending& x : g_sched->stale) {
    const char* d = static_cast<const char*>(x.dst);
    if (a >= d && a + sizeof(T) <= d + x.bytes.size()) {
      memcpy(&v, x.bytes.data() + (a - d), sizeof(T));
      break;
    }
  }
  return v;
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
    e.epoch.assign((threads + 31) / 32, 0);
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
    for (auto& p : e.pending)  // a store no fence of its thread published lands when the launch ends
      s.late.insert(s.late.end(), p.begin(), p.end());
    g_emu = nullptr;
  }
  for (EmuPending& x : s.late) emu_land(x);
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
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
  if (!g_emu) return;
  std::vector<EmuPending>& mine = emu_pending();
  for (EmuPending& x : mine) emu_land(x);
  mine.clear();
  g_emu->acquired[threadIdx.x] = g_emu->ticketed;
}
inline int atomicExch(int* p, int v) { return reinterpret_cast<std::atomic<int>*>(p)->exchange(v); }
inline unsigned atomicAdd(unsigned* p, unsigned v) { return reinterpret_cast<std::atomic<unsigned>*>(p)->fetch_add(v); }
// a load through L2 (ld.global.cg)
template <class T>
inline T __ldcg(const T* p) {
  return *p;
}
inline int __reduce_min_sync(unsigned, int v) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_i[w][l] = v;
  emu_warp_meet();
  int m = g_emu->slot_i[w][0];
  for (int i = 1; i < 32; ++i) m = m < g_emu->slot_i[w][i] ? m : g_emu->slot_i[w][i];
  emu_warp_meet();
  return m;
}
inline int __shfl_down_sync(unsigned, int v, int d) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_i[w][l] = v;
  emu_warp_meet();
  const int r = l + d < 32 ? g_emu->slot_i[w][l + d] : v;
  emu_warp_meet();
  return r;
}
inline int __shfl_up_sync(unsigned, int v, int d) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_i[w][l] = v;
  emu_warp_meet();
  const int r = l >= d ? g_emu->slot_i[w][l - d] : v;
  emu_warp_meet();
  return r;
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_i[w][l] = (int)v;
  emu_warp_meet();
  unsigned s = 0;
  for (int i = 0; i < 32; ++i) s += (unsigned)g_emu->slot_i[w][i];
  emu_warp_meet();
  return s;
}
inline unsigned __reduce_and_sync(unsigned, unsigned v) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_i[w][l] = (int)v;
  emu_warp_meet();
  unsigned r = ~0u;
  for (int i = 0; i < 32; ++i) r &= (unsigned)g_emu->slot_i[w][i];
  emu_warp_meet();
  return r;
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_i[w][l] = (int)v;
  emu_warp_meet();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (unsigned)g_emu->slot_i[w][i];
  emu_warp_meet();
  return r;
}
inline int __reduce_max_sync(unsigned, int v) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  g_emu->slot_i[w][l] = v;
  emu_warp_meet();
  int m = g_emu->slot_i[w][0];
  for (int i = 1; i < 32; ++i) m = m > g_emu->slot_i[w][i] ? m : g_emu->slot_i[w][i];
  emu_warp_meet();
  return m;
}
// Hopper DPX: max(min(a + b, c), 0), the add in 32 bits
inline int __viaddmin_s32_relu(int a, int b, int c) {
  const int s = (int)((unsigned)a + (unsigned)b);
  const int m = s < c ? s : c;
  return m > 0 ? m : 0;
}
