// The alpha of one (Gaussian, pixel) pair, shared by every compositing
// kernel: the row and combine kernels of pair_rows.cuh and
// pair_rows_forward.cuh (pairs_composite.cu, pairs_logdot.cu,
// pairs_backward.cu) through `alpha_at`.
//
// Every operation on the alpha path is an explicitly rounded intrinsic
// (__fmul_rn / __fadd_rn / __fsub_rn), so nvcc contracts none of it into
// FMAs: alpha, and with it the 1/255 and power <= 0 decisions, round exactly
// as in the unfused plain PyTorch versions. expf is the full-precision one.

#pragma once

#include <cuda_runtime.h>

namespace dge {

constexpr int kFeat = 10;  // mx, my, conic a, b, c, opacity, r, g, b, depth
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

// Pair (mean mx, my; conic a, b, c; opacity op) at pixel (px, py): the
// offsets dx, dy, ex = exp(power), raw = op * ex, and alpha = min(0.99, raw).
// Returns whether the pair takes part there (power <= 0, alpha >= 1/255).
__device__ __forceinline__ bool alpha_at(float mx, float my, float a, float b,
                                         float c, float op, float px,
                                         float py, float& dx, float& dy,
                                         float& ex, float& raw,
                                         float& alpha) {
  dx = __fsub_rn(mx, px);
  dy = __fsub_rn(my, py);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                               __fmul_rn(__fmul_rn(c, dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                __fmul_rn(__fmul_rn(b, dx), dy));
  ex = expf(power);
  raw = __fmul_rn(op, ex);
  alpha = fminf(kAlphaMax, raw);
  return (power <= 0.0f) && (alpha >= kAlphaEps);
}

}  // namespace dge
