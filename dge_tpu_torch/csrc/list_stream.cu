// The per-tile-list kernel K2's layout for NVIDIA Hopper (sm_90a): each
// tile's depth-ordered list gathered into a chunk-aligned compact stream,
// which K1's row and combine kernels (pair_rows_forward.cuh) then composite.
//
// Replaces the gather of the TPU wrapper `composite_tiles_pallas`
// (dge_tpu/ops/pallas_composite.py:187-189, `feat[:, order[lists]]` into a
// dense [T, 16, Kp] buffer, left to XLA). Python side:
// dge_tpu_torch/ops/tiles_composite.py (`list_stream`), which builds this
// file with nvcc at first use, loads it with ctypes and keeps the plain
// PyTorch version `list_stream_reference` beside it.
//
// What it computes. With nblk[t] = ceil(counts[t] / chunk) and cum its
// inclusive prefix sum (R = cum[T-1] rows, read on the host by the wrapper to
// size the outputs), row r belongs to the tile t with cum[t-1] <= r <
// cum[t] and holds its slots from (r - cum[t] + nblk[t]) * chunk on. Per row
// the kernel writes row_tile[r] = t and, per slot s of the row at stream
// position q = r * chunk + j,
//     data[f, q] = feat[id, f]  (f < 10),  id = lists[t, s] (order[...]),
// or 0 where s >= counts[t]. Tile t thus starts at chunk * (cum[t] -
// nblk[t]), a multiple of chunk, and K1's blocks at absolute offsets are its
// own chunks.
//
// Design and bound. One thread block per row; thread 0 finds the row's tile
// by a binary search of cum (log2 T cached loads), the threads take the
// row's slots, each reading one list entry (coalesced) and its Gaussian's
// ten features (one 40-byte row, from L1 after the first load) and writing
// ten floats to ten coalesced rows of the stream. Bound by bytes: each
// entry's id (+ 4 through order) and each listed Gaussian's 40-byte row read
// once, entries x 40 + R x 4 written (the zero padding past a tile's count
// is this layout's own, and so are repeated feature loads). Its point
// is the launches it saves: the same layout as PyTorch ops is about twenty
// small kernels whose host time exceeds the compositing at 256^2.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kFeat = 10;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) list_stream_kernel(
    const float* __restrict__ feat,   // [n, kFeat]
    const int* __restrict__ lists,    // [T, k]
    int k,
    const int* __restrict__ counts,   // [T], at most k
    const int* __restrict__ order,    // [n] or null
    const int* __restrict__ cum,      // [T] inclusive prefix sum of nblk
    int num_tiles, int chunk, int num_rows,
    float* __restrict__ data,         // [kFeat, num_rows * chunk]
    int* __restrict__ row_tile) {     // [num_rows]
  __shared__ int s_tile, s_first;
  const int r = blockIdx.x;
  if (threadIdx.x == 0) {
    int lo = 0, hi = num_tiles;  // the first t with cum[t] > r
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cum[mid] <= r) lo = mid + 1; else hi = mid;
    }
    const int nblk = (counts[lo] + chunk - 1) / chunk;
    s_tile = lo;
    s_first = (r - (cum[lo] - nblk)) * chunk;
    row_tile[r] = lo;
  }
  __syncthreads();
  const int t = s_tile;
  const int count = counts[t];
  const int64_t pc = static_cast<int64_t>(num_rows) * chunk;
  const int* list = lists + static_cast<int64_t>(t) * k;
  for (int j = threadIdx.x; j < chunk; j += blockDim.x) {
    const int slot = s_first + j;
    float f[kFeat];
    if (slot < count) {
      int id = list[slot];
      if (order != nullptr) id = order[id];
      const float* src = feat + static_cast<int64_t>(id) * kFeat;
#pragma unroll
      for (int i = 0; i < kFeat; ++i) f[i] = src[i];
    } else {
#pragma unroll
      for (int i = 0; i < kFeat; ++i) f[i] = 0.0f;
    }
    float* dst = data + static_cast<int64_t>(r) * chunk + j;
#pragma unroll
    for (int i = 0; i < kFeat; ++i) dst[i * pc] = f[i];
  }
}

}  // namespace

// Plain C entry for ctypes; `order` may be null. Returns the CUDA error of
// the launch (0 = success); the caller raises on anything else.
extern "C" int list_stream(const float* feat, const int* lists, int k,
                           const int* counts, const int* order,
                           const int* cum, int num_tiles, int chunk,
                           int num_rows, float* data, int* row_tile,
                           void* stream) {
  if (num_rows <= 0) return 0;
  list_stream_kernel<<<num_rows, chunk < kThreads ? chunk : kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      feat, lists, k, counts, order, cum, num_tiles, chunk, num_rows, data,
      row_tile);
  return static_cast<int>(cudaGetLastError());
}
