// Pair-stream compositing with the in-block transmittance prefix carried in
// log space, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_pairs_kernel_v2` in its `logdot` mode
// (tools/proto_logdot.py, wrapper `composite_v2`): an A/B arm of the
// pair-stream forward kernel that forms the prefix as exp(L @ log(1 - alpha))
// with L the lower-triangular ones matrix, i.e. as a prefix SUM, which a
// matrix unit can take where a prefix product cannot. (The tool's `roll` and
// `two_level` modes are two ways to form the same cumprod on the TPU; on this
// card pairs_composite.cu already is that function.) Python side:
// dge_tpu_torch/tools/proto_logdot.py, which builds this file with nvcc at
// first use, loads it with ctypes, keeps the plain PyTorch version beside it
// and compares both with pairs_composite.cu on one stream.
//
// What it computes: the inputs, the output and the block rule of
// pairs_composite.cu (blocks at ABSOLUTE stream offsets that are multiples
// of `chunk`, each block of a tile's range visited once, no tile exit). With
// committed transmittance T, at the start of each block Tb = T, ls = 0; for
// each pair with alpha, keep = pair_alpha(...) (!keep: ls unchanged, since
// log(1 - 0) = 0 exactly):
//     ls += log(1 - alpha);  cp = exp(ls)
//     if Tb cp >= 1e-4: w = alpha Tb cp / (1 - alpha), rgbd += w (r, g, b, d),
//     T = Tb cp;  else the rest of the block is refused too (ls only falls).
// logf and expf are the full-precision ones, not __logf / __expf.
//
// Design. One thread block per tile, one thread per pixel, the block's pairs
// staged in shared memory, as pairs_composite.cu; each thread keeps a running
// sum of logf and takes one expf per kept pair. The triangular product on the
// tensor cores (wgmma over a [chunk, chunk] x [chunk, pixels] tile) is what
// this formulation is for, and is not done here.
//
// Bound on this card: pairs_composite.cu's bytes (pairs x 40 read, tiles x
// tile_px^2 x 20 written) and its operations plus one log and one exp per
// (pair, pixel), 27 in all; bound by operations at every operating point of
// the repo.

#include "pair_alpha.cuh"

namespace {

using dge::kFeat;

__global__ void pairs_logdot_kernel(
    const float* __restrict__ data,  // [kFeat, pc] stream-ordered features
    int pc,
    const int* __restrict__ starts,  // [T]
    const int* __restrict__ counts,  // [T]
    int tiles_x, int tile_px, int chunk,
    float* __restrict__ out) {       // [T, 5, P]: r, g, b, depth, final T
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
    float ls = 0.0f;  // sum of log(1 - alpha) over the block's kept pairs
    for (int j = 0; j < n; ++j) {
      float alpha;
      if (!dge::pair_alpha(stage, chunk, j, px, py, alpha)) continue;
      const float one_minus = 1.0f - alpha;
      ls += logf(one_minus);
      const float cp = expf(ls);
      const float t_hyp = tb * cp;
      if (!(t_hyp >= dge::kTEps)) break;  // refused: the rest of this block too
      const float w = alpha * tb * (cp / one_minus);
      acc_r += w * stage[6 * chunk + j];
      acc_g += w * stage[7 * chunk + j];
      acc_b += w * stage[8 * chunk + j];
      acc_d += w * stage[9 * chunk + j];
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
extern "C" int pairs_logdot(const float* data, int pc, const int* starts,
                            const int* counts, int num_tiles, int tiles_x,
                            int tile_px, int chunk, float* out, void* stream) {
  if (num_tiles <= 0) return 0;
  const size_t smem = sizeof(float) * kFeat * static_cast<size_t>(chunk);
  pairs_logdot_kernel<<<num_tiles, tile_px * tile_px, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      data, pc, starts, counts, tiles_x, tile_px, chunk, out);
  return static_cast<int>(cudaGetLastError());
}
