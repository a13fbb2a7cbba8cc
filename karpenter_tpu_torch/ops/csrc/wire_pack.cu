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
// elements (the live-row slice of a row-major tensor), narrowed int32 ->
// int16 by truncation where asked (astype(int16)). The `fill_max` leaf, a
// 0-d int32 in the int32 group, is the max over every element of its
// sources (the FULL fill grids, before the live-row slice).
//
// The launcher builds the fetch's descriptor blob once per leaf signature
// (ops/cuda.py, as the reference jits _pack_wire per signature) and fills
// in the pointers each call; the blob travels in the kernel's parameters
// (4 KB, or 32 KB with CUDA 12.1 and later), a larger one is copied to a
// device buffer on the stream first. A block finds its work by blockIdx
// alone: the blob's chunk table names its task, and its rank within the
// task gives its range.
//   copy    16-byte output lines, a thread a line: aligned 16-byte loads
//           and stores where source and wire share an alignment, else two
//           aligned loads and a funnel shift; the ragged head and tail
//           line byte by byte;
//   narrow  int32 -> int16, 8 elements a 16-byte store;
//   bool    a member leaf's bytes that lie wholly within it, 16 output
//           bytes (128 elements) a thread: eight 16-byte loads, a byte's
//           bits formed in registers, big-endian within the byte; the
//           bytes a leaf boundary (or the group's end) cuts are "edge"
//           bytes, each assembled by one thread from the members its
//           descriptor names;
//   max     16-byte loads, a warp max, one atomicMax a block on a scratch
//           word, and the last block (a ticket) writes the max into the
//           wire and resets the scratch for the next launch.
//
// Bound on an H100: bytes — each leaf's live elements read once, the fill
// grids read whole for the max, the wire written once (a few MB a fetch,
// a few microseconds at 3.35 TB/s); at these sizes a launch of a few
// hundred blocks is latency, and the launcher's host work is what a fetch
// pays.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCopy = 0, kNarrow = 1, kBool = 2, kEdge = 3, kMax = 4, kNop = 5;

// the blob (ops/cuda.py _WireLayout writes it): a header, tasks, members,
// edges, then the chunk table (a uint16 task index per block)
struct Header {
  uint32_t n_tasks, n_blocks, n_members, n_edges;
  uint64_t wire;     // the output
  uint64_t scratch;  // int32 [2]: the ticket (0) and the max (INT32_MIN) between launches
  uint32_t max_off;  // the max leaf's byte offset in the wire
  uint32_t n_max_blocks;
  uint32_t off_members, off_edges, off_chunks, pad;
};
struct Task {
  uint64_t src;          // the source's device pointer
  uint32_t dst;          // copy / narrow: the wire byte of the first element; bool: the group's first byte
  uint32_t n;            // copy: bytes; narrow, bool, max: elements; edge: edges
  uint32_t first_block;  // the task's blocks are first_block ...
  uint32_t e0;           // bool: the group element of the leaf's first element
  uint32_t kind, per;    // per: items (lines, units, edges) a block takes
};
struct Member {
  uint64_t src;
  uint32_t e0, pad;
};
struct Edge {
  uint32_t dst;   // the byte's wire offset
  uint32_t e8;    // the group element of its bit 7 (8 x its group byte)
  uint32_t base;  // the first member it reads
  uint32_t rel;   // per bit b (nibble b): the member, base + nibble, or 0xF past the group's end
};

template <int N>
struct Blob {
  alignas(16) unsigned char b[N];
};

__device__ __forceinline__ uint4 ld16(const unsigned char* p) { return *reinterpret_cast<const uint4*>(p); }

// bytes [sh, sh + 16) of the 32 bytes a:b, 0 < sh < 16
__device__ __forceinline__ uint4 funnel(uint4 a, uint4 b, int sh) {
  const uint32_t u[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int q = sh >> 2;
  const uint32_t sel = 0x3210u + 0x1111u * (uint32_t)(sh & 3);
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = q == 0 ? u[i] : q == 1 ? u[i + 1] : q == 2 ? u[i + 2] : u[i + 3];
    const uint32_t hi = q == 0 ? u[i + 1] : q == 1 ? u[i + 2] : q == 2 ? u[i + 3] : u[i + 4];
    o[i] = __byte_perm(lo, hi, sel);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// 16 bytes at p, any alignment: one aligned load, or two and a funnel shift
__device__ __forceinline__ uint4 load16(const unsigned char* p) {
  const int sh = (int)((uintptr_t)p & 15);
  if (!sh) return ld16(p);
  const unsigned char* a = p - sh;
  return funnel(ld16(a), ld16(a + 16), sh);
}

// bit i: byte i of the 4 bytes of x is non-zero
__device__ __forceinline__ uint32_t nz4(uint32_t x) {
  const uint32_t h = (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
  return ((h >> 7) & 1u) | ((h >> 14) & 2u) | ((h >> 21) & 4u) | ((h >> 28) & 8u);
}

// the two packed bytes of 16 bool bytes (element 0 the high bit of the
// first), as a little-endian 16-bit value
__device__ __forceinline__ uint32_t pack16(uint4 v) {
  const uint32_t m = nz4(v.x) | nz4(v.y) << 4 | nz4(v.z) << 8 | nz4(v.w) << 12;
  return __byte_perm(__brev(m), 0u, 0x4423u);
}

__device__ __forceinline__ uint8_t pack8(const unsigned char* s) {
  uint32_t byte = 0;
  for (int k = 0; k < 8; ++k) byte |= (uint32_t)(s[k] != 0) << (7 - k);
  return (uint8_t)byte;
}

__device__ void copy_task(const Task& t, uint8_t* wire, uint32_t k) {
  const unsigned char* src = reinterpret_cast<const unsigned char*>(t.src);
  const uint64_t d0 = t.dst, d1 = d0 + t.n;
  const uint64_t l0 = (d0 >> 4) + (uint64_t)k * t.per, l1 = min(l0 + t.per, (d1 + 15) >> 4);
  for (uint64_t line = l0 + threadIdx.x; line < l1; line += kThreads) {
    const uint64_t a = max(line << 4, d0), b = min((line << 4) + 16, d1);
    const unsigned char* s = src + (a - d0);
    if (b - a == 16) {
      *reinterpret_cast<uint4*>(wire + a) = load16(s);
    } else {
      for (uint64_t x = a; x < b; ++x) wire[x] = s[x - a];
    }
  }
}

__device__ void narrow_task(const Task& t, uint8_t* wire, uint32_t k) {
  const int32_t* src = reinterpret_cast<const int32_t*>(t.src);
  const uint64_t d0 = t.dst, d1 = d0 + 2ull * t.n;
  const uint64_t l0 = (d0 >> 4) + (uint64_t)k * t.per, l1 = min(l0 + t.per, (d1 + 15) >> 4);
  for (uint64_t line = l0 + threadIdx.x; line < l1; line += kThreads) {
    const uint64_t a = max(line << 4, d0), b = min((line << 4) + 16, d1);
    if (b - a == 16 && !(d0 & 1)) {
      const int32_t* s = src + ((a - d0) >> 1);
      uint32_t v[8];
      if (!((uintptr_t)s & 15)) {
        const uint4 p = *reinterpret_cast<const uint4*>(s), q = *reinterpret_cast<const uint4*>(s + 4);
        v[0] = p.x, v[1] = p.y, v[2] = p.z, v[3] = p.w, v[4] = q.x, v[5] = q.y, v[6] = q.z, v[7] = q.w;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = (uint32_t)s[i];
      }
      *reinterpret_cast<uint4*>(wire + a) = make_uint4(__byte_perm(v[0], v[1], 0x5410u), __byte_perm(v[2], v[3], 0x5410u),
                                                      __byte_perm(v[4], v[5], 0x5410u), __byte_perm(v[6], v[7], 0x5410u));
    } else {
      for (uint64_t x = a; x < b; ++x) {
        const uint64_t e = (x - d0) >> 1;
        wire[x] = (uint8_t)((uint32_t)src[e] >> (8 * ((x - d0) & 1)));
      }
    }
  }
}

// a member leaf's whole bytes: group bytes [ceil(e0 / 8), floor((e0 + n) / 8))
__device__ void bool_task(const Task& t, uint8_t* wire, uint32_t k) {
  const unsigned char* src = reinterpret_cast<const unsigned char*>(t.src);
  const uint64_t d0 = t.dst + (t.e0 + 7) / 8, d1 = t.dst + ((uint64_t)t.e0 + t.n) / 8;
  const uint64_t l0 = (d0 >> 4) + (uint64_t)k * t.per, l1 = min(l0 + t.per, (d1 + 15) >> 4);
  for (uint64_t line = l0 + threadIdx.x; line < l1; line += kThreads) {
    const uint64_t a = max(line << 4, d0), b = min((line << 4) + 16, d1);
    // the source byte of group element 8 * (group byte a)
    const unsigned char* s = src + (8 * (a - t.dst) - t.e0);
    if (b - a == 16) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = pack16(load16(s + 32 * i)) | pack16(load16(s + 32 * i + 16)) << 16;
      *reinterpret_cast<uint4*>(wire + a) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (uint64_t x = a; x < b; ++x) wire[x] = pack8(s + 8 * (x - a));
    }
  }
}

__device__ void edge_task(const Task& t, const Member* members, const Edge* edges, uint8_t* wire, uint32_t k) {
  const uint32_t i = k * t.per + threadIdx.x;
  if (threadIdx.x >= t.per || i >= t.n) return;
  const Edge e = edges[i];
  uint32_t byte = 0;
  for (int b = 0; b < 8; ++b) {
    const uint32_t rel = (e.rel >> (4 * b)) & 0xfu;
    if (rel == 0xfu) continue;
    const Member m = members[e.base + rel];
    const unsigned char* src = reinterpret_cast<const unsigned char*>(m.src);
    byte |= (uint32_t)(src[e.e8 + b - m.e0] != 0) << (7 - b);
  }
  wire[e.dst] = (uint8_t)byte;
}

__device__ void max_task(const Task& t, const Header& h, uint8_t* wire, uint32_t k) {
  __shared__ int32_t warp_max[kThreads / 32];
  __shared__ int last;
  // elements as 16-byte units from the aligned address at or below the source
  const int32_t* src = reinterpret_cast<const int32_t*>(t.src);
  const int head = (int)(((uintptr_t)src & 15) >> 2);
  const int32_t* base = src - head;
  const uint64_t n = t.n, units = (n + head + 3) / 4;
  const uint64_t u0 = (uint64_t)k * t.per, u1 = min(u0 + t.per, units);
  int32_t m = INT32_MIN;
  for (uint64_t u = u0 + threadIdx.x; u < u1; u += kThreads) {
    const int4 v = *reinterpret_cast<const int4*>(base + 4 * u);
    const int32_t x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t e = (int64_t)(4 * u + i) - head;
      if (e >= 0 && e < (int64_t)n) m = max(m, x[i]);
    }
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  int32_t* scratch = reinterpret_cast<int32_t*>(h.scratch);
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
    atomicMax(scratch + 1, m);
    __threadfence();
    last = atomicAdd(scratch, 1) == (int)h.n_max_blocks - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    const uint32_t v = (uint32_t)atomicAdd(scratch + 1, 0);
    for (int i = 0; i < 4; ++i) wire[h.max_off + i] = (uint8_t)(v >> (8 * i));
    scratch[1] = INT32_MIN;  // ready for the next launch
    scratch[0] = 0;
  }
}

__device__ __forceinline__ void pack(const unsigned char* blob) {
  const Header& h = *reinterpret_cast<const Header*>(blob);
  const Task* tasks = reinterpret_cast<const Task*>(blob + sizeof(Header));
  const Member* members = reinterpret_cast<const Member*>(blob + h.off_members);
  const Edge* edges = reinterpret_cast<const Edge*>(blob + h.off_edges);
  const uint16_t* chunks = reinterpret_cast<const uint16_t*>(blob + h.off_chunks);
  const Task t = tasks[chunks[blockIdx.x]];
  const uint32_t k = blockIdx.x - t.first_block;
  uint8_t* wire = reinterpret_cast<uint8_t*>(h.wire);
  switch (t.kind) {
    case kCopy: copy_task(t, wire, k); break;
    case kNarrow: narrow_task(t, wire, k); break;
    case kBool: bool_task(t, wire, k); break;
    case kEdge: edge_task(t, members, edges, wire, k); break;
    case kMax: max_task(t, h, wire, k); break;
    default: break;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads) wire_pack_kernel(const __grid_constant__ Blob<N> p) {
  pack(p.b);
}

// a blob past the parameter space, read from device memory
__global__ void __launch_bounds__(kThreads) wire_pack_kernel_table(const unsigned char* blob) { pack(blob); }

template <int N>
int launch(const void* blob, int64_t nbytes, int grid, cudaStream_t stream) {
  Blob<N> b;
  memcpy(b.b, blob, (size_t)nbytes);
  auto* k = wire_pack_kernel<N>;
  k<<<grid, kThreads, 0, stream>>>(b);
  return (int)cudaGetLastError();
}

}  // namespace

// blob: the HOST descriptor blob of nbytes (ops/cuda.py _WireLayout, its
// pointers filled); table: a device buffer of nbytes for a blob past the
// parameter space (4 KB, or 32 KB with CUDA 12.1 and later), else unused.
extern "C" int wire_pack(const void* blob, int64_t nbytes, void* table, void* stream) {
  if (nbytes < (int64_t)sizeof(Header)) return (int)cudaErrorInvalidValue;
  const Header* h = static_cast<const Header*>(blob);
  const int grid = (int)h->n_blocks;
  if (grid < 1 || h->off_chunks + 2 * (int64_t)grid > nbytes) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (nbytes <= 1024) return launch<1024>(blob, nbytes, grid, st);
  if (nbytes <= 4000) return launch<4000>(blob, nbytes, grid, st);
#if defined(CUDART_VERSION) && CUDART_VERSION >= 12010
  if (nbytes <= 16384) return launch<16384>(blob, nbytes, grid, st);
  if (nbytes <= 32000) return launch<32000>(blob, nbytes, grid, st);
#endif
  if (!table) return (int)cudaErrorInvalidValue;
  // from pageable memory: the call returns once the blob is staged
  cudaError_t e = cudaMemcpyAsync(table, blob, (size_t)nbytes, cudaMemcpyHostToDevice, st);
  if (e != cudaSuccess) return (int)e;
  const unsigned char* tab = static_cast<const unsigned char*>(table);
  wire_pack_kernel_table<<<grid, kThreads, 0, st>>>(tab);
  return (int)cudaGetLastError();
}

extern "C" const char* wire_pack_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
