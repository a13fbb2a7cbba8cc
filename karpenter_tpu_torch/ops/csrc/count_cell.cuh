// The per-cell fill count shared by H2 fill_count_grid and H5 kscan_grid:
// the JAX package's `_claim_fill_caps` (ops/solver.py:1355) and
// `_cap_res_grid` (:2751) compute the same +/-1-verified estimate.
//
// For one (row, type, allocatable group) cell with usage u[R], request
// q[R] and allocatable al[R]: the largest c >= 0 with
//   AND over r of (u[r] + c*q[r] <= al[r]) | (u[r] + c*q[r] == 0)
// from the float estimate floor(min over q[r] > 0 of (al[r]-u[r]) / q[r]),
// clipped to [0, 2^22] and corrected by one either way. Every charge
// rounds ONCE (__fmaf_rn, as XLA fuses the reference's multiply-add);
// the subtraction and division are IEEE (__fsub_rn / __fdiv_rn). Never
// build with --use_fast_math.

#pragma once

#include <math.h>
#include <stdint.h>

namespace ktpu {

constexpr float kCountCap = 4194304.0f;  // 2^22, COUNT_CAP
constexpr int kMaxR = 16;

// One implementation for both operand forms: P is `const float*` (kN = 0,
// the loops run to R) or `float[kN]` held in registers (kN >= R, the loops
// unrolled to kN with the entries past R skipped; H2). The checks are
// pure, so the count runs only the ones its verdict reads: c0, then c0 + 1
// when c0 fits, else c0 - 1.
template <int kN, class P>
__device__ __forceinline__ bool fits_at_t(const P& u, const P& q, const P& al, int R, int c) {
  const float cf = (float)c;
  bool ok = true;
#pragma unroll
  for (int r = 0; r < (kN > 0 ? kN : R); ++r) {
    if (kN > 0 && r >= R) break;
    const float t = __fmaf_rn(cf, q[r], u[r]);
    ok = ok && ((t <= al[r]) || (t == 0.0f));
  }
  return ok;
}

template <int kN, class P>
__device__ __forceinline__ int cell_count_t(const P& u, const P& q, const P& al, int R) {
  float est = kCountCap;
#pragma unroll
  for (int r = 0; r < (kN > 0 ? kN : R); ++r) {
    if (kN > 0 && r >= R) break;
    const float ratio = q[r] > 0.0f ? __fdiv_rn(__fsub_rn(al[r], u[r]), q[r]) : INFINITY;
    est = fminf(est, ratio);
  }
  float e = isfinite(est) ? est : kCountCap;
  e = fminf(fmaxf(floorf(e), 0.0f), kCountCap);
  const int c0 = (int)e;
  if (fits_at_t<kN>(u, q, al, R, c0)) return fits_at_t<kN>(u, q, al, R, c0 + 1) ? c0 + 1 : c0;
  const int cdn = max(c0 - 1, 0);
  return fits_at_t<kN>(u, q, al, R, cdn) ? cdn : 0;
}

// the pointer form (H5, H9, the dp kernels)
__device__ __forceinline__ bool fits_at(const float* used, const float* req, const float* alloc, int R, int c) {
  return fits_at_t<0, const float*>(used, req, alloc, R, c);
}

__device__ __forceinline__ int cell_count(const float* u, const float* q, const float* al, int R) {
  return cell_count_t<0, const float*>(u, q, al, R);
}

}  // namespace ktpu
