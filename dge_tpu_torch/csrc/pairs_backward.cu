// Backward of the pair-stream compositing for NVIDIA Hopper (sm_90a): two
// kernels, pass 1 and pass 2.
//
// Replaces the TPU kernels `_pass1_kernel` and `_pass2_kernel`
// (dge_tpu/ops/pallas_backward.py, called from `_stream_backward`). Python side:
// dge_tpu_torch/ops/pairs_backward.py, which builds this file with nvcc at
// first use, loads it with ctypes and keeps a plain PyTorch version of each
// kernel beside it. The forward is csrc/pairs_composite.cu; its source note
// defines the stream, the blocks at absolute offsets k*chunk and the block
// rule (a refused pair blocks its pixel only to the end of its block).
//
// What the pair computes. Per tile, pixel and stream block: Tb is the
// committed transmittance entering the block, cp the running product of
// 1-eff, a kept pair (power <= 0, alpha >= 1/255) is applied iff
// Tb*cp >= 1e-4, T_prev = Tb*cp/(1-eff) is the transmittance in front of it
// and w = eff*T_prev its weight. With the cotangent cot[t, 0..4, pixel] of
// (r, g, b, depth, final T):
//     g_i    = r_i cot_r + g_i cot_g + b_i cot_b + d_i cot_d
//     S_i    = sum of w_j g_j over applied pairs j > i of the whole tile
//     dalpha = T_prev g_i - (S_i + cot_T T_fin) / (1 - alpha_i)   (applied)
// and, only where op*exp(power) < 0.99 (the clamp passes no gradient),
//     d_op = sum_px dalpha exp(power),   dpow = dalpha op exp(power),
//     d_a = sum dpow (-dx^2/2), d_b = sum dpow (-dx dy), d_c = sum dpow
//     (-dy^2/2), d_mx = sum dpow (-(a dx + b dy)), d_my = sum dpow
//     (-(c dy + b dx)),   d_rgbd = sum_px w cot_{r,g,b,d}.
// Thresholds are constants for the gradient. 1 - alpha is at least 0.01
// (alpha is clamped to 0.99), so the divisions need no epsilon.
//
// Pass 1 (one thread block per tile, one thread per pixel: the forward's
// walk plus g) writes, for every (tile, stream block) row, boundary_T = Tb
// and the block's total of w*g; when its walk is done each thread turns its
// own totals, last row first, into the INCLUSIVE suffix over this and all
// later blocks of the tile. Rows are indexed compactly: row = blk_off[tile]
// + k, blk_off the exclusive prefix sum of each tile's block count, so the
// two buffers hold at most ceil(Pc/chunk) + T rows of P floats (the TPU
// kernels use a dense [T, bpt8, P]).
//
// Pass 2 (one thread block per ROW): boundary_T and the suffix make every
// (tile, stream block) independent of every other, so the serial walk of
// the fullest tile does not bound this kernel. Each thread walks its
// block's pairs forward from boundary_T with the running inclusive prefix
// of w*g; S_i = suffix - prefix_i. (The difference cancels: its absolute
// error is about 1e-7 of the tile's sum of |w g|, far below the 2e-3
// max|g| gradient tolerance.) The sum over the tile's pixels is a warp
// shuffle reduction followed by a shared-memory atomic add per warp, per
// pair and per feature, skipped for warps in which a __ballot_sync shows no
// contributing pixel. Every stream position belongs to one row, so the ten
// per-pair gradients are written once to the stream-ordered [10, Pc]
// buffer with no global atomics; the fold to per-Gaussian space is an
// index_add_ over pair_ids outside the kernels, as in the TPU version.
//
// The alpha path is the forward's, with the same explicitly rounded
// intrinsics, and every keep/refuse decision is taken on the same
// expressions, so both passes decide exactly as the forward did.
//
// Bound on this card (pairs = sum of counts, P = tile pixels, R = rows):
//   pass 1: reads pairs*40 + T*P*20 bytes, writes R*P*8 bytes; about 35
//           operations per (pair, pixel);
//   pass 2: reads pairs*40 + T*P*24 + R*P*8 bytes, writes pairs*40 bytes;
//           about 70 operations per (pair, pixel).
// Both are bound by operations at every operating point of the repo.

#include <cuda_runtime.h>

namespace {

constexpr int kFeat = 10;  // mx, my, conic a, b, c, opacity, r, g, b, depth
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr unsigned kFullWarp = 0xffffffffu;

// Stage the n in-range pairs [lo, lo + n) of one stream block into shared
// memory, row-major [kFeat, chunk].
__device__ __forceinline__ void stage_block(const float* __restrict__ data,
                                            int pc, int lo, int n, int chunk,
                                            float* stage) {
  for (int i = threadIdx.x; i < kFeat * n; i += blockDim.x) {
    const int row = i / n;
    const int j = i - row * n;
    stage[row * chunk + j] = data[static_cast<size_t>(row) * pc + lo + j];
  }
}

// power, exp(power), op*exp(power) and the clamped alpha of staged pair j at
// pixel (px, py); the forward's arithmetic to the bit. Returns `keep`.
__device__ __forceinline__ bool pair_alpha(const float* stage, int chunk,
                                           int j, float px, float py,
                                           float& dx, float& dy, float& ex,
                                           float& raw, float& alpha) {
  const float a = stage[2 * chunk + j];
  const float b = stage[3 * chunk + j];
  const float c = stage[4 * chunk + j];
  dx = __fsub_rn(stage[0 * chunk + j], px);
  dy = __fsub_rn(stage[1 * chunk + j], py);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                               __fmul_rn(__fmul_rn(c, dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                __fmul_rn(__fmul_rn(b, dx), dy));
  ex = expf(power);
  raw = __fmul_rn(stage[5 * chunk + j], ex);
  alpha = fminf(kAlphaMax, raw);
  return (power <= 0.0f) && (alpha >= kAlphaEps);
}

__device__ __forceinline__ float pair_g(const float* stage, int chunk, int j,
                                        float cr, float cg, float cb,
                                        float cd) {
  return stage[6 * chunk + j] * cr + stage[7 * chunk + j] * cg +
         stage[8 * chunk + j] * cb + stage[9 * chunk + j] * cd;
}

// __launch_bounds__(1024): a 32x32 tile is one 1024-thread block, which
// leaves 64 registers a thread.
__global__ void __launch_bounds__(1024) pairs_pass1_kernel(
    const float* __restrict__ data,    // [kFeat, pc]
    int pc,
    const int* __restrict__ starts,    // [T]
    const int* __restrict__ counts,    // [T]
    const int* __restrict__ blk_off,   // [T] first row of each tile
    const float* __restrict__ cot,     // [T, 5, P]
    int tiles_x, int tile_px, int chunk,
    float* __restrict__ boundary_t,    // [R, P]
    float* __restrict__ suffix) {      // [R, P]
  extern __shared__ float stage[];     // [kFeat, chunk]
  const int t = blockIdx.x;
  const int pid = threadIdx.x;
  const int p = tile_px * tile_px;
  const int start = starts[t];
  const int end = start + counts[t];
  const float px = static_cast<float>((t % tiles_x) * tile_px + pid % tile_px);
  const float py = static_cast<float>((t / tiles_x) * tile_px + pid / tile_px);
  const float* c = cot + static_cast<size_t>(t) * 5 * p + pid;
  const float cr = c[0 * p], cg = c[1 * p], cb = c[2 * p], cd = c[3 * p];

  const int row0 = blk_off[t];
  int row = row0;
  float trans = 1.0f;
  for (int base = (start / chunk) * chunk; base < end; base += chunk, ++row) {
    const int lo = max(start, base);
    const int n = min(end, base + chunk) - lo;
    __syncthreads();  // every thread is done with the previous block
    stage_block(data, pc, lo, n, chunk, stage);
    __syncthreads();

    const float tb = trans;
    float cp = 1.0f;
    float total = 0.0f;
    for (int j = 0; j < n; ++j) {
      float dx, dy, ex, raw, alpha;
      if (!pair_alpha(stage, chunk, j, px, py, dx, dy, ex, raw, alpha))
        continue;
      const float one_minus = 1.0f - alpha;
      const float cp_next = cp * one_minus;
      const float t_hyp = tb * cp_next;
      if (!(t_hyp >= kTEps)) break;  // refused: the rest of this block too
      const float w = alpha * (tb * (cp_next / one_minus));
      total += w * pair_g(stage, chunk, j, cr, cg, cb, cd);
      cp = cp_next;
      trans = t_hyp;
    }
    const size_t at = static_cast<size_t>(row) * p + pid;
    boundary_t[at] = tb;
    suffix[at] = total;
  }
  // block totals -> inclusive suffix over this and all later blocks; each
  // thread re-reads only what it wrote itself
  float run = 0.0f;
  for (int r = row - 1; r >= row0; --r) {
    const size_t at = static_cast<size_t>(r) * p + pid;
    run += suffix[at];
    suffix[at] = run;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFullWarp, v, off);
  return v;
}

__global__ void __launch_bounds__(1024) pairs_pass2_kernel(
    const float* __restrict__ data,        // [kFeat, pc]
    int pc,
    const int* __restrict__ starts,        // [T]
    const int* __restrict__ counts,        // [T]
    const int* __restrict__ blk_off,       // [T]
    const int* __restrict__ row_tile,      // [R] tile of each row, T = unused
    const float* __restrict__ cot,         // [T, 5, P]
    const float* __restrict__ fwd_out,     // [T, 5, P] forward; row 4 = T_fin
    const float* __restrict__ boundary_t,  // [R, P]
    const float* __restrict__ suffix,      // [R, P]
    int num_tiles, int tiles_x, int tile_px, int chunk,
    float* __restrict__ grads) {           // [kFeat, pc]
  extern __shared__ float smem[];
  float* stage = smem;                     // [kFeat, chunk]
  float* sgrad = smem + kFeat * chunk;     // [kFeat, chunk]
  const int row = blockIdx.x;
  const int t = row_tile[row];
  if (t >= num_tiles) return;              // the whole block leaves
  const int pid = threadIdx.x;
  const int lane = pid & 31;
  const int p = tile_px * tile_px;
  const int start = starts[t];
  const int end = start + counts[t];
  const int base = (start / chunk + (row - blk_off[t])) * chunk;
  const int lo = max(start, base);
  const int n = min(end, base + chunk) - lo;

  stage_block(data, pc, lo, n, chunk, stage);
  for (int i = pid; i < kFeat * chunk; i += blockDim.x) sgrad[i] = 0.0f;
  __syncthreads();

  // threads past the tile's pixels (blockDim is P rounded up to a warp) only
  // take part in the warp votes
  const bool has_pixel = pid < p;
  float px = 0.0f, py = 0.0f, tb = 0.0f, suf = 0.0f, tfin_term = 0.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, cd = 0.0f;
  if (has_pixel) {
    px = static_cast<float>((t % tiles_x) * tile_px + pid % tile_px);
    py = static_cast<float>((t / tiles_x) * tile_px + pid / tile_px);
    const size_t tp = static_cast<size_t>(t) * 5 * p + pid;
    cr = cot[tp + 0 * p];
    cg = cot[tp + 1 * p];
    cb = cot[tp + 2 * p];
    cd = cot[tp + 3 * p];
    tfin_term = cot[tp + 4 * p] * fwd_out[tp + 4 * p];
    const size_t at = static_cast<size_t>(row) * p + pid;
    tb = boundary_t[at];
    suf = suffix[at];
  }

  bool blocked = !has_pixel;
  float cp = 1.0f;
  float prefix = 0.0f;
  for (int j = 0; j < n; ++j) {
    float v[kFeat];
#pragma unroll
    for (int f = 0; f < kFeat; ++f) v[f] = 0.0f;
    bool contrib = false;   // this pixel adds to the pair's colour gradients
    bool chained = false;   // ... and to its alpha chain
    if (!blocked) {
      float dx, dy, ex, raw, alpha;
      if (pair_alpha(stage, chunk, j, px, py, dx, dy, ex, raw, alpha)) {
        const float one_minus = 1.0f - alpha;
        const float cp_next = cp * one_minus;
        if (!(tb * cp_next >= kTEps)) {
          blocked = true;  // refused: the rest of this block too
        } else {
          const float t_prev = tb * (cp_next / one_minus);
          const float w = alpha * t_prev;
          const float g = pair_g(stage, chunk, j, cr, cg, cb, cd);
          prefix += w * g;
          cp = cp_next;
          contrib = true;
          v[6] = w * cr;
          v[7] = w * cg;
          v[8] = w * cb;
          v[9] = w * cd;
          if (raw < kAlphaMax) {
            chained = true;
            const float dalpha =
                t_prev * g - ((suf - prefix) + tfin_term) / one_minus;
            const float dpow = dalpha * raw;
            const float a = stage[2 * chunk + j];
            const float b = stage[3 * chunk + j];
            const float c = stage[4 * chunk + j];
            v[0] = -dpow * (a * dx + b * dy);
            v[1] = -dpow * (c * dy + b * dx);
            v[2] = -0.5f * dpow * dx * dx;
            v[3] = -dpow * dx * dy;
            v[4] = -0.5f * dpow * dy * dy;
            v[5] = dalpha * ex;
          }
        }
      }
    }
    if (__ballot_sync(kFullWarp, contrib)) {
      const bool any_chain = __ballot_sync(kFullWarp, chained) != 0u;
#pragma unroll
      for (int f = 0; f < kFeat; ++f) {
        if (f < 6 && !any_chain) continue;
        const float s = warp_sum(v[f]);
        if (lane == 0) atomicAdd(&sgrad[f * chunk + j], s);
      }
    }
    if (__all_sync(kFullWarp, blocked)) break;
  }
  __syncthreads();
  for (int i = pid; i < kFeat * n; i += blockDim.x) {
    const int f = i / n;
    const int j = i - f * n;
    grads[static_cast<size_t>(f) * pc + lo + j] = sgrad[f * chunk + j];
  }
}

}  // namespace

// Plain C entries for ctypes. Each returns cudaGetLastError() after its
// launch (0 = success); the caller raises on anything else.
extern "C" int pairs_pass1(const float* data, int pc, const int* starts,
                           const int* counts, const int* blk_off,
                           const float* cot, int num_tiles, int tiles_x,
                           int tile_px, int chunk, float* boundary_t,
                           float* suffix, void* stream) {
  if (num_tiles <= 0) return 0;
  const size_t smem = sizeof(float) * kFeat * static_cast<size_t>(chunk);
  pairs_pass1_kernel<<<num_tiles, tile_px * tile_px, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      data, pc, starts, counts, blk_off, cot, tiles_x, tile_px, chunk,
      boundary_t, suffix);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pairs_pass2(const float* data, int pc, const int* starts,
                           const int* counts, const int* blk_off,
                           const int* row_tile, int num_rows, const float* cot,
                           const float* fwd_out, const float* boundary_t,
                           const float* suffix, int num_tiles, int tiles_x,
                           int tile_px, int chunk, float* grads,
                           void* stream) {
  if (num_rows <= 0) return 0;
  const size_t smem = sizeof(float) * 2 * kFeat * static_cast<size_t>(chunk);
  const int threads = (tile_px * tile_px + 31) / 32 * 32;
  pairs_pass2_kernel<<<num_rows, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      data, pc, starts, counts, blk_off, row_tile, cot, fwd_out, boundary_t,
      suffix, num_tiles, tiles_x, tile_px, chunk, grads);
  return static_cast<int>(cudaGetLastError());
}
