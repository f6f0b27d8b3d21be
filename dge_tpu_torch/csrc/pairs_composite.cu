// Pair-stream front-to-back compositing for NVIDIA Hopper (sm_90a): a row
// kernel and a combine kernel (pair_rows_forward.cuh, form kLog = false).
//
// Replaces the TPU kernel `_pairs_kernel` (dge_tpu/ops/pallas_composite.py,
// wrapper `composite_pairs_pallas`). Python side: dge_tpu_torch/ops/
// pairs_composite.py, which builds this file with nvcc at first use, loads
// it with ctypes and keeps the plain PyTorch versions beside it.
//
// The same two kernels also carry the per-tile-list kernel K2 (the TPU
// kernel `_composite_kernel`, wrapper ops/tiles_composite.py): its lists are
// laid out as a stream whose tiles start at multiples of `chunk`, so the
// absolute blocks below are each list's own chunks, counted from its slot 0.
//
// What it computes, per tile t and pixel (px, py) = (ox + pid % tile_px,
// oy + pid / tile_px) (no +0.5): the pairs [starts[t], starts[t]+counts[t])
// of the depth-ordered stream are walked in order. The stream is cut into
// blocks at ABSOLUTE offsets that are multiples of `chunk`. With committed
// transmittance T (initially 1), at the start of each block Tb = T, cp = 1;
// for each pair
//     power = -0.5 (a dx^2 + c dy^2) - b dx dy,  dx = mx - px, dy = my - py
//     alpha = min(0.99, op exp(power)); the pair is kept if power <= 0 and
//     alpha >= 1/255 (else it changes nothing)
//     cp *= 1 - alpha;  if Tb cp >= 1e-4: w = alpha Tb cp / (1 - alpha),
//     rgbd += w (r, g, b, d), T = Tb cp.
// A refused pair blocks the rest of ITS BLOCK only (cp never rises inside a
// block); the next block starts again from the committed T. This is what
// `_pairs_kernel` computes, and it differs from the CUDA reference's hard
// per-pixel break. There is no tile exit: committed T never falls below
// 1e-4, so the TPU kernel's (`max(trans) >= T_EPS`) never fires either.
//
// Why the walk splits exactly. A (tile, stream block) pair is a row
// (pair_rows.cuh). Inside a row every decision is taken on Tb * cp_i, cp_i
// the running product over kept pairs: cp never rises under f32 rounding
// (round(cp x) <= cp for x < 1) and x -> round(Tb x) is monotone, so
//   every kept pair is applied  iff  Tb * cp_last  >= 1e-4,
//   no pair is applied          iff  Tb * cp_first <  1e-4,
// with the very operands and the single multiplication the walk evaluates.
//
// Design. The old form ran one block per tile and walked the tile's range
// serially, so its time was the walk of the fullest tile (18-26x its bound).
// 1. Row kernel, one thread block per row, four pixels a thread (the body of
//    the backward's row kernels: pair j staged by thread j as three float4,
//    the warp's conservative reject before any expf, __any_sync to skip a
//    pair no pixel of the warp keeps). It does not know Tb; per pixel it
//    writes [R, 7, P]: cp_last, cp_first, j0 and L = sum of alpha cp_before
//    (r, g, b, d) as if every kept pair were applied from Tb = 1. A pixel
//    stops at its first kept pair with cp < 1e-4 (no Tb <= 1 applies all of
//    the row then: cp_last keeps that value), a warp once all its pixels
//    have stopped. Per group of 32 pixels (an 8x4 patch of a 32-wide tile)
//    it also writes a keep mask, one bit a pair: some pixel of the group
//    keeps it before it stops.
// 2. Combine kernel, one thread a pixel, one warp a mask group, a block a
//    band of 8 groups (4 in a tile of <= 128 pixels) and one producer warp:
//    over the tile's rows in order from T = 1, store boundary_T[row] = T on
//    request, then
//      T cp_last >= 1e-4:   rgbd += T L,  T = T cp_last      (all applied)
//      T cp_first < 1e-4:   nothing                          (none applied)
//      else:                the lanes in this case walk the row together
//                           from the least of their j0 over the pairs of
//                           their group's mask, with the one-block-per-tile
//                           walk's arithmetic, until every such lane is
//                           refused, four pairs' alphas taken together and
//                           then applied in order.
//    Nothing a row needs depends on T, so the producer stages each row (its
//    pairs, the band's scratch and keep-mask words) in a ring of
//    shared-memory stages (bulk copies), up to the ring's depth ahead of
//    the band's warps, which settle and walk from shared memory and release
//    a stage when done: the chain of rows and the walks wait on shared
//    memory, one stage a row for the band's warps.
//    The third case is NOT rare: on the trained bench scene it is 11% of the
//    (row, pixel) visits at 512^2 and 38% at 1080p (a pixel saturates inside
//    a row, then hovers just above 1e-4). So the combine spreads a tile over
//    8 to 32 warps, not one block, and a walk visits only the pairs some
//    pixel of its compact patch keeps.
//    The walks' latency (a chain of dependent alphas, an expf each, and
//    prefixes), not the chain of rows, sets the combine's time, and a band
//    moves at its slowest warp's walks up to the ring's depth: the ring
//    costs more than the memory round trips it hides (PERF.md §6).
// Committed T, final T and boundary_T are the walk's f32 products; colour
// and depth differ only in where T is multiplied in (T sum(..) against
// sum T (..)), about 1e-6 relative. No atomics: launches repeat bit for bit.
//
// Bound on this card (pairs = sum of counts, P = tile pixels, R = rows):
//   row kernel:  reads pairs x 40 bytes, writes R x P x 28 (and the mask,
//                R x P / 32 x chunk / 8); one exp and
//                about 12 FMAs per (pair, pixel), 25 operations: bound by
//                operations;
//   combine:     reads R x P x 28, writes T x P x 20 (+ R x P x 4 with
//                boundary_T) plus its walks (not counted: they depend on
//                the data): bound by bytes.

#include "pair_rows_forward.cuh"

// Plain C entries for ctypes. Each returns the CUDA error of its launch
// (0 = success); the caller raises on anything else.
extern "C" int pairs_rows_forward(const float* data, int pc,
                                  const int* starts, const int* counts,
                                  const int* blk_off, const int* row_tile,
                                  int num_rows, int num_tiles, int tiles_x,
                                  int tile_px, int chunk, float* scratch,
                                  unsigned* mask, void* stream) {
  return dge::launch_rows_forward<false>(
      data, pc, starts, counts, blk_off, row_tile, num_rows, num_tiles,
      tiles_x, tile_px, chunk, scratch, mask,
      static_cast<cudaStream_t>(stream));
}

extern "C" int pairs_rows_combine(const float* scratch,
                                  const unsigned* mask, const float* data,
                                  int pc, const int* starts,
                                  const int* counts, const int* blk_off,
                                  int num_tiles, int tiles_x, int tile_px,
                                  int chunk, float* out, float* boundary_t,
                                  void* stream) {
  return dge::launch_rows_combine<false>(
      scratch, mask, data, pc, starts, counts, blk_off, num_tiles, tiles_x,
      tile_px, chunk, out, boundary_t, static_cast<cudaStream_t>(stream));
}
