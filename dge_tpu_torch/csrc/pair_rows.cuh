// Device helpers of the row kernels, shared by pairs_backward.cu (K3, K4) and
// pair_rows_forward.cuh (K1 in pairs_composite.cu, K5 in pairs_logdot.cu).
//
// A (tile, stream block) pair is a row: row = blk_off[tile] + k, blk_off the
// exclusive prefix sum of each tile's block count (ops/pairs_composite.py
// `block_rows`), at most ceil(Pc/chunk) + T rows. A row kernel runs one
// thread block per row, four neighbouring pixels a thread (ids 4*tid ..
// 4*tid+3, so per-pixel rows are one 16-byte access), 256 threads for a
// 32x32 tile, and stages the row's pairs pair-major, three float4 a pair.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "pair_alpha.cuh"

namespace dge {

constexpr int kStride = 12;  // floats a staged pair: kFeat, reject r2, pad
constexpr int kPix = 4;      // pixels a thread
constexpr int kMaxThreads = 256;  // a 32x32 tile at kPix pixels a thread
constexpr unsigned kFullWarp = 0xffffffffu;

// The stream positions [lo, lo + n) of one row; n <= 0 for a row not in use.
struct Row {
  int t, lo, n;
};

__device__ __forceinline__ Row row_range(int row,
                                         const int* __restrict__ row_tile,
                                         const int* __restrict__ starts,
                                         const int* __restrict__ counts,
                                         const int* __restrict__ blk_off,
                                         int num_tiles, int chunk) {
  Row r = {row_tile[row], 0, 0};
  if (r.t >= num_tiles) return r;
  const int start = starts[r.t];
  const int end = start + counts[r.t];
  const int base = (start / chunk + (row - blk_off[r.t])) * chunk;
  r.lo = max(start, base);
  r.n = min(end, base + chunk) - r.lo;
  return r;
}

// Squared distance from a pair's mean beyond which no pixel keeps it: -1
// (skip everywhere) for a pair without opacity, +inf where no safe radius
// exists, NaN (never skips) from a NaN opacity. From op*exp(-lambda_min r2
// / 2) = 1/255, made conservative by 1% of lambda_min, 1e-5 of the conic's
// magnitude (f32 rounding of the power), 0.05 in the exponent; the patch
// test adds 0.01 pixel. No comparison with a NaN holds, so a pair with a
// non-finite feature is never rejected.
__device__ __forceinline__ float reject_radius2(float a, float b, float c,
                                                float op) {
  if (op <= 0.0f) return isinf(op) ? CUDART_INF_F : -1.0f;
  const float half_diff = 0.5f * (a - c);
  const float lam_min =
      0.5f * (a + c) - sqrtf(half_diff * half_diff + b * b);
  const float lam_safe =
      0.99f * lam_min - 1e-5f * (fabsf(a) + fabsf(b) + fabsf(c));
  if (!(lam_safe > 0.0f)) return CUDART_INF_F;
  return 2.0f * (logf(255.0f * op) + 0.05f) / lam_safe;
}

// Stage pairs [lo, lo + n) of the [kFeat, pc] stream, pair-major
// [n, kStride]: the ten features, the reject radius, a pad. Pair j is
// staged by thread j of the `threads` starting at `first` (ten coalesced
// loads, three float4 stores).
__device__ __forceinline__ void stage_pairs(const float* __restrict__ data,
                                            int pc, int lo, int n, int first,
                                            int threads, float4* stage4) {
  for (int j = first; j < n; j += threads) {
    float f[kFeat];
#pragma unroll
    for (int k = 0; k < kFeat; ++k)
      f[k] = data[static_cast<size_t>(k) * pc + lo + j];
    stage4[3 * j + 0] = make_float4(f[0], f[1], f[2], f[3]);
    stage4[3 * j + 1] = make_float4(f[4], f[5], f[6], f[7]);
    stage4[3 * j + 2] = make_float4(
        f[8], f[9], reject_radius2(f[2], f[3], f[4], f[5]), 0.0f);
  }
}

// Stage a row's pairs, by the whole block.
__device__ __forceinline__ void stage_row(const float* __restrict__ data,
                                          int pc, Row r, float4* stage4) {
  stage_pairs(data, pc, r.lo, r.n, threadIdx.x, blockDim.x, stage4);
}

// The bounding box of a warp's pixel patch within its tile (pixel ids
// q_first .. q_last, all < P), grown by 0.01 pixel: `far` holds when a
// staged pair's reject radius says no pixel of the patch keeps it.
struct WarpPatch {
  float cx, cy, hx, hy;

  __device__ __forceinline__ WarpPatch(int q_first, int q_last, int tile_px,
                                       float ox, float oy) {
    const int y_first = q_first / tile_px, y_last = q_last / tile_px;
    const bool one_line = y_first == y_last;
    const int x_first = one_line ? q_first - y_first * tile_px : 0;
    const int x_last = one_line ? q_last - y_last * tile_px : tile_px - 1;
    cx = ox + 0.5f * (x_first + x_last);
    cy = oy + 0.5f * (y_first + y_last);
    hx = 0.5f * (x_last - x_first) + 0.01f;
    hy = 0.5f * (y_last - y_first) + 0.01f;
  }

  __device__ __forceinline__ bool far(float4 f0, float4 f2) const {
    const float far_x = fmaxf(fabsf(f0.x - cx) - hx, 0.0f);
    const float far_y = fmaxf(fabsf(f0.y - cy) - hy, 0.0f);
    return far_x * far_x + far_y * far_y > f2.z;
  }
};

// Four neighbouring floats of a [.., P] row starting at pixel q0: one
// 16-byte access where the layout allows it, else scalar with 0 past P.
__device__ __forceinline__ void load4(const float* __restrict__ base, int q0,
                                      int p, int vec, float (&v)[kPix]) {
  if (vec) {
    const float4 x = *reinterpret_cast<const float4*>(base + q0);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < kPix; ++i) v[i] = q0 + i < p ? base[q0 + i] : 0.0f;
  }
}

__device__ __forceinline__ void store4(float* __restrict__ base, int q0, int p,
                                       int vec, const float (&v)[kPix]) {
  if (vec) {
    *reinterpret_cast<float4*>(base + q0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kPix; ++i)
      if (q0 + i < p) base[q0 + i] = v[i];
  }
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Threads of a row kernel's block: kPix pixels a thread, whole warps.
inline int threads_for(int p) { return ((p + kPix - 1) / kPix + 31) / 32 * 32; }

constexpr int kMaxDevices = 64;

// Ask once per device and size for dynamic shared memory above the 48 KB
// default (`granted`: the size granted so far per device, one array per
// kernel). Returns the CUDA error (0 = granted) and leaves none behind.
template <typename Kernel>
int grant_dynamic_smem(Kernel kernel, size_t smem, size_t* granted) {
  if (smem <= 48 * 1024) return 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && (device >= kMaxDevices || smem > granted[device])) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess && device < kMaxDevices) granted[device] = smem;
  }
  if (err != cudaSuccess) cudaGetLastError();  // reported by the caller
  return static_cast<int>(err);
}

}  // namespace dge
