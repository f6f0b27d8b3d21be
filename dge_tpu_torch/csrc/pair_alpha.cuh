// The alpha of one (Gaussian, pixel) pair, shared by the forward compositing
// kernels tiles_composite.cu and pairs_logdot.cu (pairs_composite.cu and
// pairs_backward.cu carry the same arithmetic inline).
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

// `stage` holds a chunk's features as [kFeat, chunk] in shared memory. Returns
// whether pair j takes part at pixel (px, py) (power <= 0 and alpha >= 1/255);
// `alpha` is min(0.99, opacity * exp(power)).
__device__ __forceinline__ bool pair_alpha(const float* stage, int chunk,
                                           int j, float px, float py,
                                           float& alpha) {
  const float a = stage[2 * chunk + j];
  const float b = stage[3 * chunk + j];
  const float c = stage[4 * chunk + j];
  const float dx = __fsub_rn(stage[0 * chunk + j], px);
  const float dy = __fsub_rn(stage[1 * chunk + j], py);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                               __fmul_rn(__fmul_rn(c, dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                __fmul_rn(__fmul_rn(b, dx), dy));
  alpha = fminf(kAlphaMax, __fmul_rn(stage[5 * chunk + j], expf(power)));
  return (power <= 0.0f) && (alpha >= kAlphaEps);
}

}  // namespace dge
