// H4 compact_scatter — replaces the row movement of the JAX package's
// ops/solver.py `compact_state` (solver.py:870-893, the stable compaction
// by argsort(~alive)), `_bank_rows` (:814) and `global_template` /
// `global_claims` (:952 / :961), the `.at[idx].set(..., mode="drop")`
// scatters.
//
// Each call moves the rows of up to kMaxFields window fields (every field
// a [n_rows, row_bytes] byte matrix: requirement masks, usage, viable-type
// masks, counters) to destination rows:
//   mode 0 (compact): row i goes to the exclusive prefix count of `alive`
//           at i, if alive[i] — the stable compaction; dead rows drop;
//   mode 1 (drop):    row i goes to ids[i] when 0 <= ids[i] < n_dst_rows,
//           else drops (the reference's mode="drop" scatter).
// Destination rows nobody writes keep what the caller put there (the
// identity / zero fill for compaction, the bank for the scatters).
// A field may instead move only some key rows of its source row: with
// seg_bytes > 0 the destination row is the n_tk segments of seg_bytes
// bytes at source offsets tk[j] * seg_bytes — the topology-key mode, which
// banks `reqs.mask[:, topo_kids, :]`, `inf[:, topo_kids]` and
// `defined[:, topo_kids]` (the reference's `_bank_rows` tk rows, :824-836)
// in the same launch as the other bank columns.
//
// Bound on an H100: bytes — each moved row is read once and written once,
// about 4.6 MB each way for a full [4096, T=1000] window, about 2.8 us.
// Design: mode 0 first runs a single-block exclusive scan of `alive` into
// a device position array; then one block per source row copies that
// row of every field, 16-byte vectors where the row and both bases
// allow it, bytes otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFields = 16;
constexpr int kMaxTk = 16;
constexpr int kScanThreads = 1024;

struct Fields {
  const uint8_t* src[kMaxFields];
  uint8_t* dst[kMaxFields];
  int64_t row_bytes[kMaxFields];      // destination row bytes
  int64_t src_row_bytes[kMaxFields];  // source row stride
  int64_t seg_bytes[kMaxFields];      // 0 = whole row, else key-row segments
  int tk[kMaxTk];
  int n, n_tk;
};

__global__ void alive_scan_kernel(const uint8_t* __restrict__ alive, int n,
                                  int32_t* __restrict__ pos) {
  __shared__ int red[32];
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, n);
  int cnt = 0;
  for (int i = lo; i < hi; ++i) cnt += alive[i] ? 1 : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = cnt;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int w = lane < nw ? red[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += v;
    }
    if (lane < nw) red[lane] = w;
  }
  __syncthreads();
  int run = (warp > 0 ? red[warp - 1] : 0) + incl - cnt;
  for (int i = lo; i < hi; ++i) {
    if (alive[i]) {
      pos[i] = run;
      ++run;
    } else {
      pos[i] = -1;
    }
  }
}

__global__ void scatter_rows_kernel(Fields fs, const int32_t* __restrict__ dst_row,
                                    int n_dst_rows) {
  const int64_t i = blockIdx.x;
  const int d = dst_row[i];
  if (d < 0 || d >= n_dst_rows) return;
  for (int f = 0; f < fs.n; ++f) {
    const int64_t rb = fs.row_bytes[f];
    const uint8_t* s = fs.src[f] + i * fs.src_row_bytes[f];
    uint8_t* o = fs.dst[f] + (int64_t)d * rb;
    const int64_t seg = fs.seg_bytes[f];
    if (seg > 0) {
      for (int64_t k = threadIdx.x; k < rb; k += blockDim.x)
        o[k] = s[(int64_t)fs.tk[k / seg] * seg + k % seg];
    } else if ((rb % 16) == 0 && (((uintptr_t)s | (uintptr_t)o) % 16) == 0) {
      const int4* s4 = reinterpret_cast<const int4*>(s);
      int4* o4 = reinterpret_cast<int4*>(o);
      for (int64_t k = threadIdx.x; k < rb / 16; k += blockDim.x) o4[k] = s4[k];
    } else {
      for (int64_t k = threadIdx.x; k < rb; k += blockDim.x) o[k] = s[k];
    }
  }
}

}  // namespace

// srcs/dsts/row_bytes/src_row_bytes/seg_bytes are HOST arrays of n_fields
// entries and tk a HOST array of n_tk key ids; `sel` is the device alive
// mask (mode 0) or the device int32 destination ids (mode 1); `pos` is
// device scratch of n_rows int32 (mode 0 only).
extern "C" int compact_scatter(int mode, int n_rows, const void* sel,
                               int n_dst_rows, int n_fields,
                               const void* const* srcs, void* const* dsts,
                               const int64_t* row_bytes,
                               const int64_t* src_row_bytes,
                               const int64_t* seg_bytes, int n_tk,
                               const int* tk, void* pos, void* stream) {
  if (n_fields > kMaxFields || n_fields < 0) return (int)cudaErrorInvalidValue;
  if (n_tk > kMaxTk || n_tk < 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || n_fields == 0) return 0;
  Fields fs;
  fs.n = n_fields;
  fs.n_tk = n_tk;
  for (int j = 0; j < n_tk; ++j) fs.tk[j] = tk[j];
  for (int f = 0; f < n_fields; ++f) {
    fs.src[f] = (const uint8_t*)srcs[f];
    fs.dst[f] = (uint8_t*)dsts[f];
    fs.row_bytes[f] = row_bytes[f];
    fs.src_row_bytes[f] = src_row_bytes[f];
    fs.seg_bytes[f] = seg_bytes[f];
    if (seg_bytes[f] > 0 && row_bytes[f] != n_tk * seg_bytes[f])
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* dst_row;
  if (mode == 0) {
    alive_scan_kernel<<<1, kScanThreads, 0, s>>>((const uint8_t*)sel, n_rows,
                                                 (int32_t*)pos);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dst_row = (const int32_t*)pos;
  } else {
    dst_row = (const int32_t*)sel;
  }
  scatter_rows_kernel<<<n_rows, 256, 0, s>>>(fs, dst_row, n_dst_rows);
  return (int)cudaGetLastError();
}

extern "C" const char* compact_scatter_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
