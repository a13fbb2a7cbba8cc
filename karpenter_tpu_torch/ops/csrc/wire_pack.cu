// H15 wire_pack — replaces the JAX package's ops/kernels.py `_pack_wire`
// (kernels.py:362, jitted per leaf signature inside `fetch_tree`, 445-520)
// together with the slicing and narrowing of the jitted fetch preps
// (controllers/provisioning/scheduler.py `_slim_outputs` 190, and the
// `fill_max` guard of `_make_fetch_prep` / `_make_group_prep` /
// `_make_group_final_prep`, 259-320).
//
// One launch per fetch writes the whole wire: the leaves' dtype groups in
// order of first appearance, each the concatenation of its raveled leaves;
// bools packbits'ed across the whole group (big-endian bits in each byte,
// the last byte zero-padded, one byte may straddle two leaves); every other
// dtype as its little-endian bytes. A leaf is read where it lies: its first
// `count` elements (the live-row slice of a row-major tensor), narrowed
// int32 -> int16 by truncation where asked (astype(int16)). The `fill_max`
// leaf, a 0-d int32 in the int32 group, is the max over every element of
// its sources (the FULL fill grids, before the live-row slice): each warp
// folds its elements into one atomicMax on a scratch word, and the last
// block (a ticket) writes the max into its place in the wire.
//
// The host builds a descriptor table (int64 words) and uploads it in one
// copy; its last two words are the scratch (ticket 0, max INT32_MIN):
//   tasks   [n_tasks][8]: type, a, b, out byte offset, element bytes, work
//                         items, first work item, group elements
//     type 0 copy:    a = source pointer, b = elements; one item a element
//     type 1 narrow:  a = int32 source pointer, b = elements; 2 bytes out
//     type 2 bools:   a = first member, b = members; one item an out byte
//     type 3 max:     a = first source, b = sources; one item a source element
//   members [n_members][3]: pointer, first group element, elements
//   sources [n_sources][3]: pointer, first work item in the task, elements
// Tasks (and members, sources) with no elements are left out by the host.
//
// Bound on an H100: bytes — each leaf's live elements read once, the fill
// grids read whole for the max, the wire written once; the fetches of the
// north-star cell move a few MB (a few microseconds at 3.35 TB/s). Design:
// a flat work space, grid-stride, one item a thread; each item finds its
// task (and member or source) by a binary search in the table (L1-resident,
// at most a few hundred tasks). The kernel's time at these sizes is its
// launch; the launcher's host work (the table) is what a fetch pays.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Params {
  const int64_t* tasks;
  const int64_t* members;
  const int64_t* sources;
  int32_t* ticket;
  int32_t* maxv;
  uint8_t* wire;
  int64_t total;    // work items over every task
  int64_t max_off;  // the max leaf's byte offset in the wire (has_max)
  int n_tasks, has_max, grid;
};

// the last row r of `rows` (stride `w` words, key at word `k`) whose key is
// at most `x`; rows are sorted by key and row `lo` has key <= x
__device__ __forceinline__ int last_at_most(const int64_t* rows, int w, int k, int lo, int hi, int64_t x) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (rows[(int64_t)mid * w + k] <= x)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ void put_bytes(uint8_t* d, const uint8_t* s, int n) {
  for (int k = 0; k < n; ++k) d[k] = s[k];
}

__global__ void __launch_bounds__(kThreads) wire_pack_kernel(const __grid_constant__ Params p) {
  int32_t local_max = INT32_MIN;
  const int64_t stride = (int64_t)p.grid * kThreads;
  for (int64_t w = (int64_t)blockIdx.x * kThreads + threadIdx.x; w < p.total; w += stride) {
    const int ti = last_at_most(p.tasks, 8, 6, 0, p.n_tasks - 1, w);
    const int64_t* t = p.tasks + (int64_t)ti * 8;
    const int64_t j = w - t[6];
    uint8_t* out = p.wire + t[3];
    switch ((int)t[0]) {
      case 0: {  // copy one element of t[4] bytes
        const int es = (int)t[4];
        const uint8_t* s = reinterpret_cast<const uint8_t*>(t[1]) + j * es;
        uint8_t* d = out + j * es;
        if (((uintptr_t)d % es) != 0) {
          put_bytes(d, s, es);
        } else if (es == 4) {
          *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s);
        } else if (es == 8) {
          *reinterpret_cast<uint64_t*>(d) = *reinterpret_cast<const uint64_t*>(s);
        } else if (es == 2) {
          *reinterpret_cast<uint16_t*>(d) = *reinterpret_cast<const uint16_t*>(s);
        } else {
          put_bytes(d, s, es);
        }
        break;
      }
      case 1: {  // int32 -> int16, truncating
        const int32_t v = reinterpret_cast<const int32_t*>(t[1])[j];
        const uint16_t h = (uint16_t)(uint32_t)v;
        uint8_t* d = out + j * 2;
        if (((uintptr_t)d & 1) == 0) {
          *reinterpret_cast<uint16_t*>(d) = h;
        } else {
          d[0] = (uint8_t)(h & 0xff);
          d[1] = (uint8_t)(h >> 8);
        }
        break;
      }
      case 2: {  // one packed byte: group elements 8j .. 8j+7
        const int64_t n = t[7];
        const int64_t e0 = j * 8;
        int m = last_at_most(p.members, 3, 1, (int)t[1], (int)(t[1] + t[2] - 1), e0);
        const int m_end = (int)(t[1] + t[2]);
        uint32_t byte = 0;
        for (int k = 0; k < 8; ++k) {
          const int64_t e = e0 + k;
          if (e >= n) break;
          while (m + 1 < m_end && e >= p.members[(int64_t)(m + 1) * 3 + 1]) ++m;
          const int64_t* mm = p.members + (int64_t)m * 3;
          const uint8_t b = reinterpret_cast<const uint8_t*>(mm[0])[e - mm[1]];
          byte |= (uint32_t)(b != 0) << (7 - k);
        }
        out[j] = (uint8_t)byte;
        break;
      }
      default: {  // an element of a max source
        const int s = last_at_most(p.sources, 3, 1, (int)t[1], (int)(t[1] + t[2] - 1), j);
        const int64_t* ss = p.sources + (int64_t)s * 3;
        const int32_t v = reinterpret_cast<const int32_t*>(ss[0])[j - ss[1]];
        local_max = v > local_max ? v : local_max;
        break;
      }
    }
  }
  if (!p.has_max) return;
  for (int off = 16; off > 0; off >>= 1) {
    const int32_t o = __shfl_xor_sync(0xffffffffu, local_max, off);
    local_max = o > local_max ? o : local_max;
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMax(p.maxv, local_max);
    __threadfence();
  }
  __syncthreads();
  __shared__ int last;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(p.ticket, 1) == p.grid - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    const uint32_t v = (uint32_t)atomicAdd(p.maxv, 0);
    uint8_t* d = p.wire + p.max_off;
    for (int k = 0; k < 4; ++k) d[k] = (uint8_t)(v >> (8 * k));
  }
}

}  // namespace

// table: the DEVICE descriptor table (tasks, members, sources, then the two
// scratch words); wire: the device output of `total_bytes`; grid: blocks.
extern "C" int wire_pack(const void* table, int n_tasks, int n_members, int n_sources, int64_t total,
                         int has_max, int64_t max_off, void* wire, int grid, void* stream) {
  if (n_tasks < 0 || n_members < 0 || n_sources < 0 || total < 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.tasks = (const int64_t*)table;
  p.members = p.tasks + (int64_t)n_tasks * 8;
  p.sources = p.members + (int64_t)n_members * 3;
  int64_t* scratch = const_cast<int64_t*>(p.sources + (int64_t)n_sources * 3);
  p.ticket = reinterpret_cast<int32_t*>(scratch);
  p.maxv = reinterpret_cast<int32_t*>(scratch + 1);
  p.wire = (uint8_t*)wire;
  p.total = total;
  p.max_off = max_off;
  p.n_tasks = n_tasks;
  p.has_max = has_max;
  p.grid = grid;
  wire_pack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* wire_pack_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
