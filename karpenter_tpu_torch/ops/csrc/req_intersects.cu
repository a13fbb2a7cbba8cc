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
// 1.2 us; the per-pair key loop (K=8 keys, V=8 values) makes it
// operation-bound instead. Design: one thread per output cell, the fast
// index on B so a warp shares one A row (broadcast loads) and writes 32
// contiguous bytes; each key's V mask bytes are read as 8-byte words
// (the wrapper requires V % 8 == 0 and 8-byte aligned rows), so the
// intersection and both leniency `any`s are three word tests per word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct ReqSet {
  const uint8_t* mask;  // [N, K, V] bool
  const uint8_t* inf;   // [N, K] bool
  const uint8_t* excl;  // [N, K] bool
  const int32_t* gte;   // [N, K] int32
  const int32_t* lte;   // [N, K] int32
  const uint8_t* def;   // [N, K] bool
};

__global__ void req_intersects_kernel(ReqSet a, ReqSet b, int A, int B, int K,
                                      int V, uint8_t* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)A * B) return;
  const int i = (int)(idx / B);
  const int j = (int)(idx - (int64_t)i * B);
  bool ok = true;
  for (int k = 0; k < K && ok; ++k) {
    const int64_t ia = (int64_t)i * K + k;
    const int64_t jb = (int64_t)j * K + k;
    const bool da = a.def[ia] != 0;
    const bool db = b.def[jb] != 0;
    if (!(da && db)) continue;  // key not shared: no constraint
    const uint64_t* ma = reinterpret_cast<const uint64_t*>(a.mask + ia * V);
    const uint64_t* mb = reinterpret_cast<const uint64_t*>(b.mask + jb * V);
    bool hit = false, any_a = false, any_b = false;
    for (int w = 0; w < V / 8; ++w) {
      const uint64_t wa = ma[w];
      const uint64_t wb = mb[w];
      hit |= (wa & wb) != 0;
      any_a |= wa != 0;
      any_b |= wb != 0;
    }
    const bool inf_a = a.inf[ia] != 0;
    const bool inf_b = b.inf[jb] != 0;
    const int32_t gte = max(a.gte[ia], b.gte[jb]);
    const int32_t lte = min(a.lte[ia], b.lte[jb]);
    const bool nonempty = hit || (inf_a && inf_b && gte <= lte);
    const bool len_a = (inf_a && a.excl[ia] != 0) || (!inf_a && !any_a);
    const bool len_b = (inf_b && b.excl[jb] != 0) || (!inf_b && !any_b);
    ok = nonempty || (len_a && len_b);
  }
  out[idx] = ok ? 1 : 0;
}

}  // namespace

extern "C" int req_intersects(const void* a_mask, const void* a_inf,
                              const void* a_excl, const void* a_gte,
                              const void* a_lte, const void* a_def,
                              const void* b_mask, const void* b_inf,
                              const void* b_excl, const void* b_gte,
                              const void* b_lte, const void* b_def, int A,
                              int B, int K, int V, void* out, void* stream) {
  ReqSet a{(const uint8_t*)a_mask, (const uint8_t*)a_inf,
           (const uint8_t*)a_excl, (const int32_t*)a_gte,
           (const int32_t*)a_lte, (const uint8_t*)a_def};
  ReqSet b{(const uint8_t*)b_mask, (const uint8_t*)b_inf,
           (const uint8_t*)b_excl, (const int32_t*)b_gte,
           (const int32_t*)b_lte, (const uint8_t*)b_def};
  const int64_t n = (int64_t)A * B;
  if (n == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  req_intersects_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(a, b, A, B, K, V,
                                                  (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* req_intersects_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
