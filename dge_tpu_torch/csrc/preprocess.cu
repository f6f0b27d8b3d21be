// The render's preprocess for NVIDIA Hopper (sm_90a): view and clip
// transforms, near cull, 3D covariance, EWA projection, conic, radius,
// on-screen test and the SH colour of every Gaussian slot, in one kernel of
// one thread a slot.
//
// Replaces no Pallas kernel. It replaces, on the card, the jnp preprocess of
// dge_tpu/ops/projection.py (`preprocess`) and dge_tpu/ops/sh.py
// (`eval_sh_color`), which XLA fused there and which the port carried over
// as plain PyTorch (`_preprocess_torch` in dge_tpu_torch/ops/projection.py,
// still the CPU twin and the autograd path). That version runs some 380
// small elementwise launches a call and uploads the SH band table from the
// host (a stream drain): a 1920x1080 view of 144k Gaussians spent ~7 ms of
// its ~7.7 ms frame in it with the card idle most of that time. Python side:
// dge_tpu_torch/ops/projection.py (`_preprocess_kernel`), which builds this
// file with nvcc at first use and loads it with ctypes. Upstream's
// counterpart is preprocessCUDA with computeCov3D, computeCov2D and
// computeColorFromSH (cuda_rasterizer/forward.cu:20-256).
//
// Exactness. mean2d, depth, conic, radius and visible come out bit for bit
// as the torch path's on the card: each float operation of that path is
// repeated one by one in its order (Python associates left to right) with
// __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn / __fsqrt_rn, which nvcc
// fuses into no FMA. A Python number over a tensor is PyTorch's
// `reciprocal()` times the number, so `1.0 / t` is __frcp_rn(t) and the
// focal length is rcp(2 tan) * width; Python's float constants enter as the
// double rounded to float, as PyTorch passes them to a float kernel;
// torch.clamp keeps a NaN. The colour's two reductions take their terms in
// the order PyTorch's reduction kernel does for these shapes (the norm of a
// [N, 3] row: (x^2 + z^2) + y^2, two lanes, lane 0 taking x and z; the sum
// over the coefficients of a [N, K, 3] product: four accumulators of the
// terms k = i mod 4, added in order), but nothing pins that order, so rgb
// is held to 1e-6, not to its bits.
//
// Bound. Bytes: each slot reads xyz, scale, quaternion, alive and its SH
// coefficients (233 B at degree 3) and writes mean2d, depth, conic, radius,
// rgb and visible (41 B): at 147,456 slots 40 MB, 0.012 ms at 3.35 TB/s.
// The design spends no launches: one kernel, the camera read from its device
// tensors (focal lengths and clamps derived in the kernel), every other
// constant a kernel argument, so no host read and no upload.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

// Python's float constants as PyTorch passes them to a float kernel: the
// double rounded to float
constexpr float kNearZ = static_cast<float>(0.2);     // projection.NEAR_Z
constexpr float kFovClamp = static_cast<float>(1.3);  // +-1.3 tan clamp
constexpr float kLowPass = static_cast<float>(0.3);   // EWA low-pass
constexpr float kWEps = static_cast<float>(1e-7);     // 1 / (w + 1e-7)
constexpr float kDiscMin = static_cast<float>(0.1);
constexpr float kLambdaMin = static_cast<float>(1e-12);
constexpr float kNormEps = static_cast<float>(1e-12);

// ops/sh.py's constants
constexpr float kC0 = static_cast<float>(0.28209479177387814);
constexpr float kC1 = static_cast<float>(0.4886025119029199);
constexpr float kNegC1 = static_cast<float>(-0.4886025119029199);
constexpr float kC20 = static_cast<float>(1.0925484305920792);
constexpr float kC21 = static_cast<float>(-1.0925484305920792);
constexpr float kC22 = static_cast<float>(0.31539156525252005);
constexpr float kC23 = static_cast<float>(-1.0925484305920792);
constexpr float kC24 = static_cast<float>(0.5462742152960396);
constexpr float kC30 = static_cast<float>(-0.5900435899266435);
constexpr float kC31 = static_cast<float>(2.890611442640554);
constexpr float kC32 = static_cast<float>(-0.4570457994644658);
constexpr float kC33 = static_cast<float>(0.3731763325901154);
constexpr float kC34 = static_cast<float>(-0.4570457994644658);
constexpr float kC35 = static_cast<float>(1.445305721320277);
constexpr float kC36 = static_cast<float>(-0.5900435899266435);

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

// torch.clamp(v, lo, hi) and torch.clamp(v, min=lo) on the card: a NaN
// stays
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// x * m[r, 0] + y * m[r, 1] + z * m[r, 2] + m[r, 3] of a row-major 4x4
__device__ __forceinline__ float row(const float* m, int r, float x, float y,
                                     float z) {
  return add(add(add(mul(x, m[4 * r]), mul(y, m[4 * r + 1])),
                 mul(z, m[4 * r + 2])),
             m[4 * r + 3]);
}

// compute_cov2d's quad(u, v): sum_i u[i] * (s[i] . v), from 0.0
__device__ __forceinline__ float quad(const float (&s)[3][3],
                                      const float (&u)[3],
                                      const float (&v)[3]) {
  float acc = 0.0f;
  for (int i = 0; i < 3; ++i)
    acc = add(acc, mul(u[i], add(add(mul(s[i][0], v[0]), mul(s[i][1], v[1])),
                                 mul(s[i][2], v[2]))));
  return acc;
}

// ((v + 1) * size - 1) * 0.5
__device__ __forceinline__ float ndc2pix(float v, float size) {
  return mul(sub(mul(add(v, 1.0f), size), 1.0f), 0.5f);
}

// The colour of one slot from its SH coefficients (sh_basis and
// eval_sh_color): bands above `active` are multiplied by 0, as the torch
// path's mask does; the terms are summed into four accumulators by k mod 4,
// which are then added in order.
template <int kDeg>
__device__ __forceinline__ void sh_color(const float* __restrict__ sh,
                                         int active, float x, float y,
                                         float z, float rgb[3]) {
  constexpr int kCoeffs = (kDeg + 1) * (kDeg + 1);
  float b[kCoeffs];
  b[0] = kC0;
  if constexpr (kDeg >= 1) {
    b[1] = mul(kNegC1, y);
    b[2] = mul(kC1, z);
    b[3] = mul(kNegC1, x);
  }
  if constexpr (kDeg >= 2) {
    const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
    const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
    b[4] = mul(kC20, xy);
    b[5] = mul(kC21, yz);
    b[6] = mul(kC22, sub(sub(mul(2.0f, zz), xx), yy));
    b[7] = mul(kC23, xz);
    b[8] = mul(kC24, sub(xx, yy));
    if constexpr (kDeg >= 3) {
      b[9] = mul(mul(kC30, y), sub(mul(3.0f, xx), yy));
      b[10] = mul(mul(kC31, xy), z);
      b[11] = mul(mul(kC32, y), sub(sub(mul(4.0f, zz), xx), yy));
      b[12] = mul(mul(kC33, z),
                  sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
      b[13] = mul(mul(kC34, x), sub(sub(mul(4.0f, zz), xx), yy));
      b[14] = mul(mul(kC35, z), sub(xx, yy));
      b[15] = mul(mul(kC36, x), sub(xx, mul(3.0f, yy)));
    }
  }
  float acc[4][3] = {};
#pragma unroll
  for (int k = 0; k < kCoeffs; ++k) {
    const int band = k == 0 ? 0 : (k < 4 ? 1 : (k < 9 ? 2 : 3));
    const float basis = mul(b[k], band <= active ? 1.0f : 0.0f);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      acc[k % 4][c] = add(acc[k % 4][c], mul(basis, __ldg(sh + 3 * k + c)));
  }
  for (int c = 0; c < 3; ++c) {
    const float sum = add(add(add(acc[0][c], acc[1][c]), acc[2][c]),
                          acc[3][c]);
    rgb[c] = clamp_min(add(sum, 0.5f), 0.0f);
  }
}

// kDeg: the SH degree evaluated (max_sh_degree); -1 when the caller passes
// its own colour and no rgb is written.
template <int kDeg>
__global__ void __launch_bounds__(kThreads) preprocess_kernel(
    const float* __restrict__ xyz, const float* __restrict__ scale,
    const float* __restrict__ quat, const float* __restrict__ sh,
    const bool* __restrict__ alive, const float* __restrict__ w2c,
    const float* __restrict__ full_proj, const float* __restrict__ campos,
    const float* __restrict__ tan_x, const float* __restrict__ tan_y, int n,
    float width, float height, int sh_stride, int active,
    float scale_modifier, float* __restrict__ mean2d,
    float* __restrict__ depth_out, float* __restrict__ conic,
    float* __restrict__ radius, float* __restrict__ rgb,
    bool* __restrict__ visible) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n) return;
  const float x = xyz[3 * g], y = xyz[3 * g + 1], z = xyz[3 * g + 2];

  // view and clip transforms, near cull
  const float pv0 = row(w2c, 0, x, y, z);
  const float pv1 = row(w2c, 1, x, y, z);
  const float depth = row(w2c, 2, x, y, z);
  const bool in_front = depth > kNearZ;
  const float ph0 = row(full_proj, 0, x, y, z);
  const float ph1 = row(full_proj, 1, x, y, z);
  const float ph3 = row(full_proj, 3, x, y, z);
  const float p_w = __frcp_rn(add(ph3, kWEps));

  // compute_cov3d: R from the wxyz quaternion, Sigma[i][k] =
  // R[i][0] R[k][0] s0^2 + R[i][1] R[k][1] s1^2 + R[i][2] R[k][2] s2^2
  const float qr = quat[4 * g], qx = quat[4 * g + 1], qy = quat[4 * g + 2],
              qz = quat[4 * g + 3];
  const float R[3][3] = {
      {sub(1.0f, mul(2.0f, add(mul(qy, qy), mul(qz, qz)))),
       mul(2.0f, sub(mul(qx, qy), mul(qr, qz))),
       mul(2.0f, add(mul(qx, qz), mul(qr, qy)))},
      {mul(2.0f, add(mul(qx, qy), mul(qr, qz))),
       sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qz, qz)))),
       mul(2.0f, sub(mul(qy, qz), mul(qr, qx)))},
      {mul(2.0f, sub(mul(qx, qz), mul(qr, qy))),
       mul(2.0f, add(mul(qy, qz), mul(qr, qx))),
       sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy))))}};
  float s2[3];
  for (int j = 0; j < 3; ++j) {
    const float s = mul(scale_modifier, scale[3 * g + j]);
    s2[j] = mul(s, s);
  }
  float S[3][3];
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k)
      S[i][k] = add(add(mul(mul(R[i][0], R[k][0]), s2[0]),
                        mul(mul(R[i][1], R[k][1]), s2[1])),
                    mul(mul(R[i][2], R[k][2]), s2[2]));

  // compute_cov2d on the guarded view point (z = 1 behind the near plane)
  const float tanx = *tan_x, tany = *tan_y;
  const float fx = mul(__frcp_rn(mul(2.0f, tanx)), width);
  const float fy = mul(__frcp_rn(mul(2.0f, tany)), height);
  const float tz = in_front ? depth : 1.0f;
  const float limx = mul(kFovClamp, tanx), limy = mul(kFovClamp, tany);
  const float tx = mul(clamp(__fdiv_rn(pv0, tz), -limx, limx), tz);
  const float ty = mul(clamp(__fdiv_rn(pv1, tz), -limy, limy), tz);
  const float inv_z = __frcp_rn(tz);
  const float c0 = mul(fx, inv_z);
  const float c1 = mul(mul(mul(-fx, tx), inv_z), inv_z);
  const float d1 = mul(fy, inv_z);
  const float d2 = mul(mul(mul(-fy, ty), inv_z), inv_z);
  float t0[3], t1[3];
  for (int k = 0; k < 3; ++k) {
    t0[k] = add(mul(c0, w2c[k]), mul(c1, w2c[8 + k]));
    t1[k] = add(mul(d1, w2c[4 + k]), mul(d2, w2c[8 + k]));
  }
  const float a = add(quad(S, t0, t0), kLowPass);
  const float b = quad(S, t0, t1);
  const float c = add(quad(S, t1, t1), kLowPass);

  // conic, radius, mean2d, visibility
  const float det = sub(mul(a, c), mul(b, b));
  const bool det_ok = det > 0.0f;
  const float det_inv = det_ok ? __frcp_rn(det) : 0.0f;
  conic[3 * g] = mul(c, det_inv);
  conic[3 * g + 1] = mul(-b, det_inv);
  conic[3 * g + 2] = mul(a, det_inv);
  const float mid = mul(0.5f, add(a, c));
  const float disc = __fsqrt_rn(clamp_min(sub(mul(mid, mid), det), kDiscMin));
  const float lambda1 = add(mid, disc);
  const float r = ceilf(mul(3.0f, __fsqrt_rn(clamp_min(lambda1, kLambdaMin))));
  const float mx = ndc2pix(mul(ph0, p_w), width);
  const float my = ndc2pix(mul(ph1, p_w), height);
  const bool on_screen = add(mx, r) > 0.0f && sub(mx, r) < width &&
                         add(my, r) > 0.0f && sub(my, r) < height;
  const bool vis = alive[g] && in_front && det_ok && on_screen;
  mean2d[2 * g] = mx;
  mean2d[2 * g + 1] = my;
  depth_out[g] = depth;
  radius[g] = vis ? r : 0.0f;
  visible[g] = vis;

  if constexpr (kDeg >= 0) {
    // the unit view direction, then the SH colour
    float dx = sub(x, campos[0]), dy = sub(y, campos[1]),
          dz = sub(z, campos[2]);
    const float den = add(
        __fsqrt_rn(add(add(mul(dx, dx), mul(dz, dz)), mul(dy, dy))),
        kNormEps);
    dx = __fdiv_rn(dx, den);
    dy = __fdiv_rn(dy, den);
    dz = __fdiv_rn(dz, den);
    float col[3];
    sh_color<kDeg>(sh + static_cast<int64_t>(g) * sh_stride * 3, active,
                   dx, dy, dz, col);
    for (int ch = 0; ch < 3; ++ch) rgb[3 * g + ch] = col[ch];
  }
}

}  // namespace

// Plain C entry for ctypes; returns the CUDA error of the launch (0 =
// success), the caller raises on anything else. `sh` null: no colour (the
// caller's override), `rgb` is not written. `sh_stride` is the coefficients
// a slot holds (>= (max_deg + 1)^2), `max_deg` in 0..3.
extern "C" int preprocess_forward(
    const float* xyz, const float* scale, const float* quat, const float* sh,
    const bool* alive, const float* w2c, const float* full_proj,
    const float* campos, const float* tan_x, const float* tan_y, int n,
    int width, int height, int sh_stride, int max_deg, int active_deg,
    float scale_modifier, float* mean2d, float* depth, float* conic,
    float* radius, float* rgb, bool* visible, void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float w = static_cast<float>(width), h = static_cast<float>(height);
#define DGE_PREPROCESS(D)                                                  \
  preprocess_kernel<D><<<grid, kThreads, 0, st>>>(                         \
      xyz, scale, quat, sh, alive, w2c, full_proj, campos, tan_x, tan_y, n, \
      w, h, sh_stride, active_deg, scale_modifier, mean2d, depth, conic,   \
      radius, rgb, visible)
  if (sh == nullptr) {
    DGE_PREPROCESS(-1);
  } else {
    switch (max_deg) {
      case 0: DGE_PREPROCESS(0); break;
      case 1: DGE_PREPROCESS(1); break;
      case 2: DGE_PREPROCESS(2); break;
      case 3: DGE_PREPROCESS(3); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef DGE_PREPROCESS
  return static_cast<int>(cudaGetLastError());
}
