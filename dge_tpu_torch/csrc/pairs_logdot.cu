// Pair-stream compositing with the in-block transmittance prefix carried in
// log space, for NVIDIA Hopper (sm_90a): the row and combine kernels of
// pair_rows_forward.cuh in their form kLog = true.
//
// Replaces the TPU kernel `_pairs_kernel_v2` in its `logdot` mode
// (tools/proto_logdot.py, wrapper `composite_v2`): an A/B arm of the
// pair-stream forward kernel that forms the prefix as exp(L @ log(1 - alpha))
// with L the lower-triangular ones matrix, i.e. as a prefix SUM, which a
// matrix unit can take where a prefix product cannot. (The tool's `roll` and
// `two_level` modes are two ways to form the same cumprod on the TPU; on this
// card pairs_composite.cu already is that function.) Python side:
// dge_tpu_torch/tools/proto_logdot.py (wrapper, plain version, the A/B
// tool) over the generic wrappers of dge_tpu_torch/ops/pairs_composite.py.
//
// What it computes: the inputs, the output and the block rule of
// pairs_composite.cu. With committed transmittance T, at the start of each
// block Tb = T, ls = 0; for each kept pair:
//     ls += log(1 - alpha);  cp = exp(ls)
//     if Tb cp >= 1e-4: w = alpha Tb cp / (1 - alpha), rgbd += w (r, g, b, d),
//     T = Tb cp;  else the rest of the block is refused.
// logf and expf are the full-precision ones, not __logf / __expf.
//
// Design: pairs_composite.cu's row + combine split. expf is not promised to
// be monotone, so the row kernel also stores cp_min, the least prefix it
// walked (scratch [R, 8, P]): every kept pair is applied iff T cp_min >=
// 1e-4, and then the next T is T cp_last; none is applied iff T cp_first <
// 1e-4 with cp_first = expf(logf(1 - alpha_j0)); else the combine walks the
// row as pairs_composite.cu does, in log space. The triangular product on
// the tensor cores (wgmma over a [chunk, chunk] x [chunk, pixels] tile) is
// what this formulation is for, and is not done here.
//
// Bound on this card: pairs_composite.cu's, with one more log and exp per
// (pair, pixel) in the row kernel (27 operations, bound by operations) and
// R x P x 32 bytes of scratch for the combine (bound by bytes).

#include "pair_rows_forward.cuh"

// Plain C entries for ctypes. Each returns the CUDA error of its launch
// (0 = success); the caller raises on anything else.
extern "C" int logdot_rows_forward(const float* data, int pc,
                                   const int* starts, const int* counts,
                                   const int* blk_off, const int* row_tile,
                                   int num_rows, int num_tiles, int tiles_x,
                                   int tile_px, int chunk, float* scratch,
                                   unsigned* mask, void* stream) {
  return dge::launch_rows_forward<true>(
      data, pc, starts, counts, blk_off, row_tile, num_rows, num_tiles,
      tiles_x, tile_px, chunk, scratch, mask,
      static_cast<cudaStream_t>(stream));
}

extern "C" int logdot_rows_combine(const float* scratch,
                                   const unsigned* mask, const float* data,
                                   int pc, const int* starts,
                                   const int* counts, const int* blk_off,
                                   int num_tiles, int tiles_x, int tile_px,
                                   int chunk, float* out, float* boundary_t,
                                   void* stream) {
  return dge::launch_rows_combine<true>(
      scratch, mask, data, pc, starts, counts, blk_off, num_tiles, tiles_x,
      tile_px, chunk, out, boundary_t, static_cast<cudaStream_t>(stream));
}
