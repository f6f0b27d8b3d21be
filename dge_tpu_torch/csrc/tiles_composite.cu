// Front-to-back compositing over capped per-tile lists for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_composite_kernel` (dge_tpu/ops/
// pallas_composite.py, wrapper `composite_tiles_pallas`). Python side:
// dge_tpu_torch/ops/tiles_composite.py, which builds this file with nvcc at
// first use, loads it with ctypes and holds it against the plain PyTorch
// version (ops/composite.py, `composite_lists`).
//
// What it computes, per tile t and pixel (px, py) = (ox + pid % tile_px,
// oy + pid / tile_px) (no +0.5): the slots [0, counts[t]) of the tile's
// depth-ordered list lists[t, :] are walked in order; slot s names Gaussian
// lists[t, s], or order[lists[t, s]] when `order` is given. The list is cut
// into chunks counted from the TILE'S OWN slot 0 (pairs_composite.cu cuts at
// absolute stream offsets instead). With committed transmittance T
// (initially 1), at the start of each chunk Tb = T, cp = 1; for each slot
//     alpha, keep = pair_alpha(...)        (pair_alpha.cuh; !keep: no change)
//     cp *= 1 - alpha;  if Tb cp >= 1e-4: w = alpha Tb cp / (1 - alpha),
//     rgbd += w (r, g, b, d), T = Tb cp.
// A refused slot blocks the rest of ITS CHUNK only: cp never rises inside a
// chunk, so the loop leaves the chunk; the next chunk starts again from the
// committed T (the TPU kernel's carried transmittance is the product of the
// applied factors only). There is NO early exit of the tile: committed T
// never falls below 1e-4, so the TPU kernel's `max(trans) >= T_EPS` never
// fires either. Slots at or past counts[t] hold whatever followed the tile's
// run in the sorted stream and are never read: the walk is bounded by slot.
//
// Design. One thread block per tile, one thread per pixel (tile_px^2 <= 1024
// threads). The TPU wrapper first materialises feat[:, order[lists]] as a
// [T, 16, Kp] buffer for every slot of every tile up to the cap; here the
// block reads the [N, 10] feature table THROUGH the list while it stages a
// chunk in shared memory (ids first, then 10 consecutive floats per id, so
// ten neighbouring threads read one 40-byte row), and only the slots below
// counts[t] are ever touched: that buffer does not exist. Then every thread
// walks the staged chunk from shared memory (broadcast reads). The kernel
// allocates nothing and launches on the caller's stream.
//
// Bound on this card (per frame, entries = sum of counts):
//   bytes: entries x (4 + 40) read + tiles x tile_px^2 x 5 x 4 written;
//   work:  one exp and about 12 FMAs per (entry, pixel), 25 operations.
// The work term dominates wherever a tile holds more than a few entries, so
// the kernel is bound by operations, as pairs_composite.cu is; the serial
// per-thread walk of the fullest tile is what the simple design leaves.

#include "pair_alpha.cuh"

namespace {

using dge::kFeat;

__global__ void tiles_composite_kernel(
    const float* __restrict__ feat,   // [n, kFeat] per-Gaussian features
    const int* __restrict__ lists,    // [T, k] per-tile lists
    int k,
    const int* __restrict__ counts,   // [T]
    const int* __restrict__ order,    // [n] or nullptr
    int tiles_x, int tile_px, int chunk,
    float* __restrict__ out) {        // [T, 5, P]: r, g, b, depth, final T
  extern __shared__ float smem[];
  float* stage = smem;                                   // [kFeat, chunk]
  int* ids = reinterpret_cast<int*>(smem + kFeat * chunk);  // [chunk]
  const int t = blockIdx.x;
  const int pid = threadIdx.x;
  const int p = tile_px * tile_px;
  const int count = min(counts[t], k);
  const int* list = lists + static_cast<size_t>(t) * k;
  const float px = static_cast<float>((t % tiles_x) * tile_px + pid % tile_px);
  const float py = static_cast<float>((t / tiles_x) * tile_px + pid / tile_px);

  float trans = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;

  for (int base = 0; base < count; base += chunk) {
    const int n = min(chunk, count - base);
    __syncthreads();  // every thread is done with the previous chunk
    for (int j = pid; j < n; j += blockDim.x) {
      const int id = list[base + j];
      ids[j] = order != nullptr ? order[id] : id;
    }
    __syncthreads();
    for (int i = pid; i < kFeat * n; i += blockDim.x) {
      const int j = i / kFeat;
      const int row = i - j * kFeat;
      stage[row * chunk + j] = feat[static_cast<size_t>(ids[j]) * kFeat + row];
    }
    __syncthreads();

    const float tb = trans;
    float cp = 1.0f;
    for (int j = 0; j < n; ++j) {
      float alpha;
      if (!dge::pair_alpha(stage, chunk, j, px, py, alpha)) continue;
      const float one_minus = 1.0f - alpha;
      const float cp_next = cp * one_minus;
      const float t_hyp = tb * cp_next;
      if (!(t_hyp >= dge::kTEps)) break;  // refused: the rest of this chunk too
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

// Plain C entry for ctypes. `order` may be null. Returns cudaGetLastError()
// after the launch (0 = success); the caller raises on anything else.
extern "C" int tiles_composite(const float* feat, const int* lists, int k,
                               const int* counts, const int* order,
                               int num_tiles, int tiles_x, int tile_px,
                               int chunk, float* out, void* stream) {
  if (num_tiles <= 0) return 0;
  const size_t smem = (sizeof(float) * kFeat + sizeof(int)) *
                      static_cast<size_t>(chunk);
  tiles_composite_kernel<<<num_tiles, tile_px * tile_px, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      feat, lists, k, counts, order, tiles_x, tile_px, chunk, out);
  return static_cast<int>(cudaGetLastError());
}
