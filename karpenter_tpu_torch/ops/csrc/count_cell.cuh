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

__device__ __forceinline__ bool fits_at(const float* used, const float* req,
                                        const float* alloc, int R, int c) {
  const float cf = (float)c;
  bool ok = true;
  for (int r = 0; r < R; ++r) {
    const float t = __fmaf_rn(cf, req[r], used[r]);
    ok = ok && ((t <= alloc[r]) || (t == 0.0f));
  }
  return ok;
}

__device__ __forceinline__ int cell_count(const float* u, const float* q,
                                          const float* al, int R) {
  float est = kCountCap;
  for (int r = 0; r < R; ++r) {
    const float ratio =
        q[r] > 0.0f ? __fdiv_rn(__fsub_rn(al[r], u[r]), q[r]) : INFINITY;
    est = fminf(est, ratio);
  }
  float e = isfinite(est) ? est : kCountCap;
  e = fminf(fmaxf(floorf(e), 0.0f), kCountCap);
  const int c0 = (int)e;
  const bool up = fits_at(u, q, al, R, c0 + 1);
  const bool mid = fits_at(u, q, al, R, c0);
  const int cdn = max(c0 - 1, 0);
  const bool dn = fits_at(u, q, al, R, cdn);
  return mid ? (up ? c0 + 1 : c0) : (dn ? cdn : 0);
}

}  // namespace ktpu
