// Pair-stream front-to-back compositing for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_pairs_kernel` (dge_tpu/ops/pallas_composite.py,
// wrapper `composite_pairs_pallas`). Python side: dge_tpu_torch/ops/
// pairs_composite.py, which builds this file with nvcc at first use, loads
// it with ctypes and keeps the plain PyTorch version beside it.
//
// What it computes, per tile t and pixel (px, py) = (ox + pid % tile_px,
// oy + pid / tile_px) (no +0.5): the pairs [starts[t], starts[t]+counts[t])
// of the depth-ordered stream are walked in order. The stream is cut into
// blocks at ABSOLUTE offsets that are multiples of `chunk`. With committed
// transmittance T (initially 1), at the start of each block Tb = T, cp = 1;
// for each pair
//     power = -0.5 (a dx^2 + c dy^2) - b dx dy,  dx = mx - px, dy = my - py
//     alpha = min(0.99, op exp(power)); eff = alpha if power <= 0 and
//     alpha >= 1/255, else 0 (the pair then changes nothing)
//     cp *= 1 - eff;  if Tb cp >= 1e-4: w = eff Tb cp / (1 - eff),
//     rgbd += w (r, g, b, d), T = Tb cp.
// A refused pair blocks the rest of ITS BLOCK only: cp never rises inside a
// block, so every later pair of the block is refused too, and the loop
// leaves the block; the next block starts again from the committed T. This
// is what `_pairs_kernel` computes (its carried transmittance is the product
// of the applied factors only), and it differs from the CUDA reference's
// hard per-pixel break. There is deliberately NO early exit of the tile:
// committed T never falls below 1e-4, so the TPU kernel's tile exit
// (`max(trans) >= T_EPS`) never fires either.
//
// Design. One thread block per tile, one thread per pixel (tile_px^2 <= 1024
// threads). The block walks the tile's chunk-aligned blocks; for each it
// stages the block's in-range pairs (10 f32 features each) from the
// assembled [10, Pc] stream into shared memory (coalesced row reads), then
// every thread walks them from shared memory (broadcast reads). The input is
// the assembled stream rather than pair ids + a feature table so that the
// kernel and its plain version take the very same tensor. The alpha path
// uses explicitly rounded intrinsics (__fmul_rn/__fadd_rn/__fsub_rn), so
// nvcc contracts none of it into FMAs: alpha, and with it the 1/255 and
// power <= 0 decisions, round exactly as in the unfused PyTorch version.
// The kernel allocates nothing and launches on the caller's stream.
//
// For the backward (csrc/pairs_backward.cu) the walk can hand over what it
// holds anyway: with `boundary_t` given, the committed T entering each
// stream block is stored to row blk_off[t] + k of a [R, P] buffer (k counts
// the tile's blocks), so that no backward kernel repeats this serial walk.
// With a null pointer nothing is stored and nothing else changes.
//
// Bound on this card (per frame, with `pairs` = sum of counts):
//   bytes: pairs x 10 x 4 read + tiles x tile_px^2 x 5 x 4 written;
//   work:  one exp and about 12 FMAs per (pair, pixel).
// The work term dominates at every operating point of the repo (pairs x
// 1024 pixels x ~25 flops against ~40 bytes per pair), so the kernel is
// bound by operations; the simple design leaves the exp and the serial
// per-thread walk as the limit. Faster staging (cp.async/TMA), a real exit
// once every pixel is blocked to the tile's end, and occupancy tuning are
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kFeat = 10;  // mx, my, conic a, b, c, opacity, r, g, b, depth
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

__global__ void pairs_composite_kernel(
    const float* __restrict__ data,  // [kFeat, pc] stream-ordered features
    int pc,
    const int* __restrict__ starts,  // [T]
    const int* __restrict__ counts,  // [T]
    int tiles_x, int tile_px, int chunk,
    float* __restrict__ out,         // [T, 5, P]: r, g, b, depth, final T
    const int* __restrict__ blk_off,   // [T] first row of each tile, or null
    float* __restrict__ boundary_t) {  // [R, P] entering T per row, or null
  extern __shared__ float stage[];   // [kFeat, chunk]
  const int t = blockIdx.x;
  const int pid = threadIdx.x;
  const int p = tile_px * tile_px;
  const int start = starts[t];
  const int end = start + counts[t];
  const float px = static_cast<float>((t % tiles_x) * tile_px + pid % tile_px);
  const float py = static_cast<float>((t / tiles_x) * tile_px + pid / tile_px);

  float trans = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  float* boundary = boundary_t;
  if (boundary) boundary += static_cast<size_t>(blk_off[t]) * p + pid;

  for (int base = (start / chunk) * chunk; base < end; base += chunk) {
    const int lo = max(start, base);
    const int n = min(end, base + chunk) - lo;
    __syncthreads();  // every thread is done with the previous block
    for (int i = pid; i < kFeat * n; i += blockDim.x) {
      const int row = i / n;
      const int j = i - row * n;
      stage[row * chunk + j] = data[static_cast<size_t>(row) * pc + lo + j];
    }
    __syncthreads();

    const float tb = trans;
    if (boundary) {
      *boundary = tb;
      boundary += p;
    }
    float cp = 1.0f;
    for (int j = 0; j < n; ++j) {
      const float a = stage[2 * chunk + j];
      const float b = stage[3 * chunk + j];
      const float c = stage[4 * chunk + j];
      const float dx = __fsub_rn(stage[0 * chunk + j], px);
      const float dy = __fsub_rn(stage[1 * chunk + j], py);
      const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                                   __fmul_rn(__fmul_rn(c, dy), dy));
      const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                    __fmul_rn(__fmul_rn(b, dx), dy));
      const float alpha =
          fminf(kAlphaMax, __fmul_rn(stage[5 * chunk + j], expf(power)));
      if (!(power <= 0.0f) || !(alpha >= kAlphaEps)) continue;
      const float one_minus = 1.0f - alpha;
      const float cp_next = cp * one_minus;
      const float t_hyp = tb * cp_next;
      if (!(t_hyp >= kTEps)) break;  // refused: the rest of this block too
      const float w = alpha * tb * (cp_next / one_minus);
      acc_r += w * stage[6 * chunk + j];
      acc_g += w * stage[7 * chunk + j];
      acc_b += w * stage[8 * chunk + j];
      acc_d += w * stage[9 * chunk + j];
      cp = cp_next;
      trans = t_hyp;
    }
  }

  if (pid < p) {
    float* o = out + static_cast<size_t>(t) * 5 * p + pid;
    o[0 * p] = acc_r;
    o[1 * p] = acc_g;
    o[2 * p] = acc_b;
    o[3 * p] = acc_d;
    o[4 * p] = trans;
  }
}

}  // namespace

// Plain C entry for ctypes. Returns cudaGetLastError() after the launch
// (0 = success); the caller raises on anything else.
extern "C" int pairs_composite(const float* data, int pc, const int* starts,
                               const int* counts, int num_tiles, int tiles_x,
                               int tile_px, int chunk, float* out,
                               const int* blk_off, float* boundary_t,
                               void* stream) {
  if (num_tiles <= 0) return 0;
  const size_t smem = sizeof(float) * kFeat * static_cast<size_t>(chunk);
  pairs_composite_kernel<<<num_tiles, tile_px * tile_px, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      data, pc, starts, counts, tiles_x, tile_px, chunk, out, blk_off,
      boundary_t);
  return static_cast<int>(cudaGetLastError());
}
