// Backward of the pair-stream compositing for NVIDIA Hopper (sm_90a): the
// row kernel in its two forms (pass 1 and pass 2), the small suffix kernel
// between them, and the ordered fold of the per-pair gradients to the
// Gaussians after them.
//
// Replaces the TPU kernels `_pass1_kernel` and `_pass2_kernel`
// (dge_tpu/ops/pallas_backward.py, called from `_stream_backward`), the
// flipped cumsum between them and the `.at[].add` fold after them. Python
// side: dge_tpu_torch/ops/pairs_backward.py, which builds this file with
// nvcc at first use, loads it with ctypes and keeps a plain PyTorch version
// of each kernel beside it. The forward is csrc/pairs_composite.cu; its source note
// defines the stream, the blocks at absolute offsets k*chunk and the block
// rule (a refused pair blocks its pixel only to the end of its block).
//
// What the pair computes. Per tile, pixel and stream block: Tb is the
// committed transmittance entering the block, cp the running product of
// 1-eff, a kept pair (power <= 0, alpha >= 1/255) is applied iff
// Tb*cp >= 1e-4, T_prev = Tb*cp_before is the transmittance in front of it
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
// (alpha is clamped to 0.99), so the division is an approximate reciprocal
// (one MUFU instruction) with no epsilon.
//
// Rows. A (tile, stream block) pair is a row: row = blk_off[tile] + k,
// blk_off the exclusive prefix sum of each tile's block count, so the
// per-row buffers hold at most ceil(Pc/chunk) + T rows of P floats (the TPU
// kernels use a dense [T, bpt8, P]). boundary_T[row] = Tb makes every row
// independent of every other. The forward's combine kernel (pair_rows_
// forward.cuh) holds Tb as it goes over a tile's rows and stores it on
// request, so no backward kernel walks a tile's whole range. The row layout,
// row_range, the staging, the reject radius and load4 / store4 are shared
// with the forward in pair_rows.cuh, the alpha path in pair_alpha.cuh.
//
// One kernel body, `pairs_rows_kernel`, one thread block per row, and two
// small kernels:
//   pass 1 (kPass2 = false): per pixel the row's total of w*g;
//   suffix (`rows_suffix_kernel`, one thread per four pixels of a tile):
//           the totals, last row first, become the INCLUSIVE suffix over
//           this and all later blocks of the tile;
//   pass 2 (kPass2 = true): each thread walks its row's pairs forward from
//           boundary_T with the running inclusive prefix of w*g; S_i =
//           suffix - prefix_i. (The difference cancels: its absolute error
//           is about 1e-7 of the tile's sum of |w g|, far below the 2e-3
//           max|g| gradient tolerance.) Every stream position belongs to
//           one row, so the ten per-pair gradients are written once to the
//           stream-ordered [10, Pc] buffer with no global atomics;
//   fold (`fold_layout_kernel`, then `fold_kernel`): each Gaussian's
//           gradient is the sum of its pairs' gradients in stream order,
//           from 0.
//
// What bounds it on this card, and what the design does about it. Both
// passes are bound by operations (about 35 and 70 per (pair, pixel) against
// 40 bytes a pair). One thread per pixel with one shuffle reduction per
// feature would make pass 2 wait for the shuffle unit instead: 50 shuffle
// instructions per (pair, warp) at one a clock per SM beside 70 arithmetic
// instructions at four a clock. So
// - a thread owns four neighbouring pixels (ids 4*tid .. 4*tid+3: cot,
//   forward output, boundary_T and suffix are one 16-byte load each), walks
//   their four independent chains together, and adds their ten
//   contributions in registers before any cross-lane step: a 32x32 tile is
//   256 threads;
// - the ten per-lane sums go through ONE halving butterfly (5 + 3 + 2 + 1 +
//   1 = 12 shuffles: at each step a lane sends the half of its values it
//   does not keep), which leaves feature f's warp total on the lanes whose
//   bits 1..4 spell f;
// - each warp stores its totals for pair j in its own shared-memory slot,
//   and after the walk the block adds the slots in warp order: no atomics,
//   so the per-pair gradients are bit-identical from launch to launch, and
//   so, through the ordered fold, are the per-Gaussian ones;
// - a staged pair is three float4 (ten features, a reject radius, a pad),
//   read by broadcast once for four pixels;
// - a warp whose pixel patch (128 consecutive pixel ids: 32x4 at tile 32)
//   lies wholly outside the pair's reach skips it before any exp: per pair
//   the staging computes r2 with op*exp(-lambda_min r2 / 2) = 1/255, made
//   conservative by 1% of lambda_min, 1e-5 of the conic's magnitude (f32
//   rounding of the forward's power), 0.05 in the exponent and 0.01 pixel,
//   so it never skips a pixel the forward kept; no comparison with a NaN
//   holds, so a pair with a non-finite feature is never rejected and goes
//   through the chain as every other (a NaN colour reaches the gradients
//   as it does in the plain version);
// - a warp with no kept pixel for a pair skips the chain and the butterfly
//   (__any_sync), and leaves the row once all its pixels are blocked;
// - a row is staged once, pair j by thread j (ten coalesced loads, three
//   float4 stores). A persistent grid that copies the next row with
//   cp.async under the current row's walk measured slower at one, two and
//   four blocks an SM (rows differ in cost; PERF.md) and is not kept.
// The pixel sum is formally three products [chunk, P] x [P, 6 | 1 | 4], but
// their left factors are made one pixel a thread, serially over pairs, and
// would reach wgmma only through three shared-memory stores per (pair,
// pixel), the traffic the butterfly avoids, in TF32's 10 mantissa bits:
// tensor cores are not used.
//
// The alpha path is the forward's, with the same explicitly rounded
// intrinsics, and every keep/refuse decision is taken on the same
// expressions, so both passes decide exactly as the forward did.
//
// Bound on this card (pairs = sum of counts, P = tile pixels, R = rows):
//   pass 1: reads pairs*40 + T*P*20 bytes, writes R*P*8 bytes; about 35
//           operations per (pair, pixel);
//   suffix: reads and writes R*P*4 bytes; bound by bytes;
//   pass 2: reads pairs*40 + T*P*24 + R*P*8 bytes, writes pairs*40 bytes;
//           about 70 operations per (pair, pixel);
//   fold:   its function reads U*(40 + 4) bytes (the gradients and ids of
//           the U positions before `used`) and writes N*40 bytes; one add
//           per (pair, feature): bound by bytes. The layout kernel, the
//           design's own, reads the E emission slots' 8-byte sort indices
//           and writes their 4-byte positions: E*12 bytes.
// Pass 1 and pass 2 are bound by operations at every operating point of the
// repo.
//
// The fold. The TPU version scatter-adds the [10, Pc] gradients into
// [10, N] with one `.at[].add`; on the card an index_add_ does that with
// atomics, which add in the order the threads arrive, so two runs of one
// fit part after the first densify. Here each Gaussian's sum is taken over
// its pairs in stream order, from 0: the result depends only on the stream,
// and equals index_add_ on the CPU, which adds serially in stream order,
// bit for bit. The order comes from the binning, with no second sort. It
// emits Gaussian-major: a tier-1 Gaussian g owns slots g*m1 .. g*m1+m1-1,
// the Gaussian in tier-2 row s owns n*m1 + s*m2 .. + m2-1, each Gaussian
// emits real keys into one tier only, in row-major tile order, and all its
// keys share one depth field, so its pairs lie in the sorted stream in its
// slot order; its culled and unused slots carry the sentinel tile and sort
// past `used`. The binning hands over its sort's indices (perm: position
// -> slot) and the Gaussian of each tier-2 row, both of which it computes
// for the sort anyway. `fold_layout_kernel` inverts the indices (one
// thread a slot, every slot written once: pos[perm[p]] = p + shift, the
// shift of a stream moved to a band's block offsets; it also zeroes the
// output), and `fold_kernel` reads each Gaussian's own slots in order: one
// thread for a tier-1
// Gaussian (at most m1 slots), a warp for each tier-2 row (up to m2 slots;
// lanes stage 32 slots' ten gradients in shared memory and lanes 0..9 add
// one feature each, in slot order), so no thread walks a long serial run
// and the tier-2 rows, whose Gaussians' ids may cluster, spread over the
// card. What bounds it: each pair gathers ten floats that lie Pc apart in
// K4's [10, Pc] output, ten sectors for 40 useful bytes.

#include "pair_rows.cuh"

namespace {

using namespace dge;

constexpr int kMaxDevices = 64;

// 1/x in one MUFU instruction, for x in [0.01, 1] (about 1 ulp).
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// One step of the halving butterfly: the lane keeps `lo` (upper = false) or
// `hi`, sends the other to its partner across `mask`, and returns the kept
// value plus the partner's.
__device__ __forceinline__ float halve(float lo, float hi, bool upper,
                                       int mask) {
  const float got = __shfl_xor_sync(kFullWarp, upper ? lo : hi, mask);
  return (upper ? hi : lo) + got;
}

// The warp totals of v[0..9]: feature 5*b4 + 3*b3 + 2*b2 + b1 ends on the
// lanes with those bits (see `butterfly_feature`); other lanes end with
// sums of padding.
__device__ __forceinline__ float butterfly10(const float (&v)[kFeat],
                                             int lane) {
  float u[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) u[i] = halve(v[i], v[i + 5], lane & 16, 16);
  const bool b3 = lane & 8;
  const float w0 = halve(u[0], u[3], b3, 8);
  const float w1 = halve(u[1], u[4], b3, 8);
  const float w2 = halve(u[2], 0.0f, b3, 8);
  const bool b2 = lane & 4;
  const float x0 = halve(w0, w2, b2, 4);
  const float x1 = halve(w1, 0.0f, b2, 4);
  const float y = halve(x0, x1, lane & 2, 2);
  return y + __shfl_xor_sync(kFullWarp, y, 1);
}

// The feature whose total `butterfly10` leaves on this lane, or -1.
__device__ __forceinline__ int butterfly_feature(int lane) {
  const int wi = ((lane >> 1) & 1) + 2 * ((lane >> 2) & 1);
  const int ui = wi + 3 * ((lane >> 3) & 1);
  if ((lane & 1) || wi >= 3 || ui >= 5) return -1;
  return ui + 5 * ((lane >> 4) & 1);
}

template <bool kPass2>
__global__ void __launch_bounds__(kMaxThreads, 2) pairs_rows_kernel(
    const float* __restrict__ data,        // [kFeat, pc]
    int pc,
    const int* __restrict__ starts,        // [T]
    const int* __restrict__ counts,        // [T]
    const int* __restrict__ blk_off,       // [T]
    const int* __restrict__ row_tile,      // [R] tile of each row, T = unused
    const float* __restrict__ cot,         // [T, 5, P]
    const float* __restrict__ fwd_out,     // [T, 5, P], row 4 = T_fin (pass 2)
    const float* __restrict__ boundary_t,  // [R, P]
    const float* __restrict__ suffix,      // [R, P] (pass 2)
    int num_tiles, int tiles_x, int tile_px, int chunk, int vec,
    float* __restrict__ out) {  // pass 1: totals [R, P]; pass 2: [kFeat, pc]
  extern __shared__ float4 stage4[];
  // the staged row [chunk, kStride], then pass 2's [warps, chunk, kFeat]
  float* const partial = reinterpret_cast<float*>(stage4) + chunk * kStride;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = tile_px * tile_px;
  const int q0 = kPix * tid;
  const int row = blockIdx.x;
  const Row cur = row_range(row, row_tile, starts, counts, blk_off, num_tiles,
                            chunk);
  if (cur.n <= 0) return;  // a row not in use
  const int t = cur.t, n = cur.n;

  stage_row(data, pc, cur, stage4);
  float* const my_partial = partial + warp * chunk * kFeat;
  if (kPass2) {
    for (int i = lane; i < kFeat * n; i += 32) my_partial[i] = 0.0f;
  }
  __syncthreads();

  const float ox = static_cast<float>((t % tiles_x) * tile_px);
  const float oy = static_cast<float>((t / tiles_x) * tile_px);
  // this warp's pixel patch: the pixel ids 128*warp .. 128*warp + 127
  const int q_first = 32 * kPix * warp;
  const WarpPatch patch(q_first, min(q_first + 32 * kPix, p) - 1, tile_px,
                        ox, oy);

  // a pixel blocked to the end of the row carries tb = 0 (a committed
  // T is at least 1e-4), and so do the lanes past the tile's pixels,
  // which only take part in the warp votes
  float px[kPix], py[kPix], tb[kPix], cr[kPix], cg[kPix], cb[kPix],
      cd[kPix], c0[kPix], cp[kPix], acc[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int q = q0 + i;
    px[i] = ox + static_cast<float>(q % tile_px);
    py[i] = oy + static_cast<float>(q / tile_px);
    tb[i] = cr[i] = cg[i] = cb[i] = cd[i] = c0[i] = acc[i] = 0.0f;
    cp[i] = 1.0f;
  }
  if (q0 < p) {
    const float* c = cot + static_cast<size_t>(t) * 5 * p;
    load4(c + 0 * p, q0, p, vec, cr);
    load4(c + 1 * p, q0, p, vec, cg);
    load4(c + 2 * p, q0, p, vec, cb);
    load4(c + 3 * p, q0, p, vec, cd);
    load4(boundary_t + static_cast<size_t>(row) * p, q0, p, vec, tb);
    if (kPass2) {
      float ct[kPix], tfin[kPix];
      load4(c + 4 * p, q0, p, vec, ct);
      load4(fwd_out + (static_cast<size_t>(t) * 5 + 4) * p, q0, p, vec,
            tfin);
      load4(suffix + static_cast<size_t>(row) * p, q0, p, vec, c0);
#pragma unroll
      for (int i = 0; i < kPix; ++i) c0[i] += ct[i] * tfin[i];
    }
  }

  const int my_feature = butterfly_feature(lane);
  for (int j = 0; j < n; ++j) {
    const float4 f0 = stage4[3 * j + 0];  // mx, my, a, b
    const float4 f1 = stage4[3 * j + 1];  // c, op, r, g
    const float4 f2 = stage4[3 * j + 2];  // b, d, reject r2, pad
    if (patch.far(f0, f2)) continue;  // warp-uniform

    const float a = f0.z, b = f0.w, c = f1.x;
    float dx[kPix], dy[kPix], ex[kPix], raw[kPix], alpha[kPix];
    bool keep[kPix];
    bool any_keep = false;
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      // the forward's arithmetic to the bit
      keep[i] = alpha_at(f0.x, f0.y, a, b, c, f1.y, px[i], py[i], dx[i],
                         dy[i], ex[i], raw[i], alpha[i]) &&
                (tb[i] > 0.0f);
      any_keep |= keep[i];
    }
    if (!__any_sync(kFullWarp, any_keep)) continue;

    // branch-free from here: a pixel that does not apply the pair adds
    // zeros (selected, never multiplied: exp may have overflowed)
    float v[kFeat];
#pragma unroll
    for (int f = 0; f < kFeat; ++f) v[f] = 0.0f;
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const float one_minus = 1.0f - alpha[i];
      const float cp_next = cp[i] * one_minus;
      const bool ok = keep[i] && (tb[i] * cp_next >= kTEps);
      const float t_prev = tb[i] * cp[i];
      // refused: the rest of the block too
      tb[i] = keep[i] && !ok ? 0.0f : tb[i];
      const float w = ok ? alpha[i] * t_prev : 0.0f;
      const float g = f1.z * cr[i] + f1.w * cg[i] + f2.x * cb[i] +
                      f2.y * cd[i];
      acc[i] += w * g;  // pass 1: the row's total; pass 2: the prefix
      cp[i] = ok ? cp_next : cp[i];
      if (kPass2) {
        v[6] += w * cr[i];
        v[7] += w * cg[i];
        v[8] += w * cb[i];
        v[9] += w * cd[i];
        const bool chained = ok && raw[i] < kAlphaMax;
        const float dalpha_applied =
            t_prev * g - (c0[i] - acc[i]) * rcp_approx(one_minus);
        const float dalpha = chained ? dalpha_applied : 0.0f;
        const float dpow = chained ? dalpha * raw[i] : 0.0f;
        const float dpx = dpow * dx[i], dpy = dpow * dy[i];
        v[0] -= a * dpx + b * dpy;
        v[1] -= c * dpy + b * dpx;
        v[2] -= 0.5f * dpx * dx[i];
        v[3] -= dpx * dy[i];
        v[4] -= 0.5f * dpy * dy[i];
        v[5] += chained ? dalpha * ex[i] : 0.0f;
      }
    }
    if (kPass2) {
      const float total = butterfly10(v, lane);
      if (my_feature >= 0) my_partial[j * kFeat + my_feature] = total;
    }
    const bool all_blocked =
        fmaxf(fmaxf(tb[0], tb[1]), fmaxf(tb[2], tb[3])) <= 0.0f;
    if (__all_sync(kFullWarp, all_blocked)) break;
  }

  if (kPass2) {
    __syncthreads();
    const int warps = blockDim.x >> 5;
    for (int i = tid; i < kFeat * n; i += blockDim.x) {
      const int f = i / n;
      const int j = i - f * n;
      float sum = 0.0f;
      for (int w = 0; w < warps; ++w)  // fixed order: reproducible
        sum += partial[(w * chunk + j) * kFeat + f];
      out[static_cast<size_t>(f) * pc + cur.lo + j] = sum;
    }
  } else if (q0 < p) {
    store4(out + static_cast<size_t>(row) * p, q0, p, vec, acc);
  }
}

// Per tile and pixel: the rows' totals, last row first, become the
// inclusive suffix over this and all later rows of the tile.
__global__ void __launch_bounds__(kMaxThreads) rows_suffix_kernel(
    const float* __restrict__ totals,  // [R, P]
    const int* __restrict__ starts,    // [T]
    const int* __restrict__ counts,    // [T]
    const int* __restrict__ blk_off,   // [T]
    int p, int chunk, int vec,
    float* __restrict__ suffix) {      // [R, P]
  const int t = blockIdx.x;
  const int count = counts[t];
  if (count <= 0) return;
  const int start = starts[t];
  const int rows = (start + count - 1) / chunk - start / chunk + 1;
  const int row0 = blk_off[t];
  for (int q0 = kPix * threadIdx.x; q0 < p; q0 += kPix * blockDim.x) {
    float run[kPix] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = row0 + rows - 1; r >= row0; --r) {
      float v[kPix];
      load4(totals + static_cast<size_t>(r) * p, q0, p, vec, v);
#pragma unroll
      for (int i = 0; i < kPix; ++i) run[i] += v[i];
      store4(suffix + static_cast<size_t>(r) * p, q0, p, vec, run);
    }
  }
}

// Launch the row kernel, one block per row. Dynamic shared memory above the
// 48 KB default (pass 2 beyond chunk 128) is asked for once per device and
// size.
template <bool kPass2>
int launch_rows(const float* data, int pc, const int* starts,
                const int* counts, const int* blk_off, const int* row_tile,
                int num_rows, const float* cot, const float* fwd_out,
                const float* boundary_t, const float* suffix, int num_tiles,
                int tiles_x, int tile_px, int chunk, float* out,
                cudaStream_t stream) {
  if (num_rows <= 0) return 0;
  static size_t granted[kMaxDevices] = {};
  const int p = tile_px * tile_px;
  const int threads = threads_for(p);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(chunk) * kStride +
                       (kPass2 ? static_cast<size_t>(threads / 32) * chunk *
                                     kFeat
                               : 0));
  if (smem > 48 * 1024) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess && (device >= kMaxDevices || smem > granted[device])) {
      err = cudaFuncSetAttribute(pairs_rows_kernel<kPass2>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err == cudaSuccess && device < kMaxDevices) granted[device] = smem;
    }
    if (err != cudaSuccess) {
      cudaGetLastError();  // reported here; leave no error behind
      return static_cast<int>(err);
    }
  }
  const int vec = p % kPix == 0 && aligned16(cot) && aligned16(boundary_t) &&
                  (kPass2 ? aligned16(fwd_out) && aligned16(suffix)
                          : aligned16(out));
  pairs_rows_kernel<kPass2><<<num_rows, threads, smem, stream>>>(
      data, pc, starts, counts, blk_off, row_tile, cot, fwd_out, boundary_t,
      suffix, num_tiles, tiles_x, tile_px, chunk, vec, out);
  return static_cast<int>(cudaGetLastError());
}

// The fold's layout: pos[perm[t]] = t + shift, the stream position of each
// emission slot (the inverse of the binning's sort; every slot is written
// once), and the fold's output set to +0.0 (out_size = kFeat * n), which
// the fold kernel leaves as it is for a Gaussian with no pair below lim.
__global__ void fold_layout_kernel(const int64_t* __restrict__ perm, int e,
                                   int shift, int out_size,
                                   int* __restrict__ pos,
                                   float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < e) pos[perm[t]] = t + shift;
  if (t < out_size) out[t] = 0.0f;
}

constexpr int kFoldThreads = 128;
constexpr int kFoldWarps = kFoldThreads / 32;
constexpr int kFoldStride = kFeat + 1;  // a lane's staged features, padded
constexpr int kFoldGroup = 4;           // tier-1 slots gathered together

// The ordered fold: out[f, g] = sum of grads[f, pos[e]] over Gaussian g's
// emission slots e whose position is below lim = min(used, pc), added in
// slot order from 0. Adding a +0.0 to a sum that started at +0.0 leaves
// its bits as they are, so a slot past lim may add a 0 instead of being
// skipped. No atomics. The first tier1_blocks blocks take the tier-1 slots
// (g*m1 .. g*m1 + m1 - 1), one thread a Gaussian, four slots' gathers in
// flight at once; it writes only a Gaussian with a slot below lim, since
// a tier-2 Gaussian's tier-1 slots carry the sentinel tile and lie past
// the last tile's range, `used`. The other blocks take
// the tier-2 rows, one warp a row (slots n*m1 + s*m2 .. + m2 - 1 of the
// Gaussian tier2_ids[s]; >= n: an empty row), 32 slots at a time: lane j
// stages slot j's ten gradients in shared memory (0 past lim), then lane
// f < 10 adds the 32 staged values of feature f in slot order.
__global__ void __launch_bounds__(kFoldThreads)
    fold_kernel(const float* __restrict__ grads,  // [kFeat, pc]
                int pc, const int* __restrict__ pos,
                const int* __restrict__ tier2_ids,  // [rows]
                int rows, int n, int m1, int m2, int tier1_blocks,
                const int* __restrict__ used,  // 0-dim
                float* __restrict__ out) {     // [kFeat, n]
  const int lim = min(*used, pc);
  if (static_cast<int>(blockIdx.x) < tier1_blocks) {
    const int g = blockIdx.x * kFoldThreads + threadIdx.x;
    if (g >= n) return;
    float acc[kFeat];
#pragma unroll
    for (int f = 0; f < kFeat; ++f) acc[f] = 0.0f;
    bool any = false;
    const int* mine = pos + static_cast<int64_t>(g) * m1;
    for (int j0 = 0; j0 < m1; j0 += kFoldGroup) {
      int p[kFoldGroup];
#pragma unroll
      for (int k = 0; k < kFoldGroup; ++k) {
        p[k] = j0 + k < m1 ? mine[j0 + k] : lim;
        any |= p[k] < lim;
      }
      float v[kFoldGroup][kFeat];
#pragma unroll
      for (int k = 0; k < kFoldGroup; ++k)
#pragma unroll
        for (int f = 0; f < kFeat; ++f)
          v[k][f] = p[k] < lim ? grads[static_cast<int64_t>(f) * pc + p[k]]
                               : 0.0f;
#pragma unroll
      for (int k = 0; k < kFoldGroup; ++k)
#pragma unroll
        for (int f = 0; f < kFeat; ++f) acc[f] += v[k][f];
    }
    if (any) {
#pragma unroll
      for (int f = 0; f < kFeat; ++f)
        out[static_cast<int64_t>(f) * n + g] = acc[f];
    }
    return;
  }
  __shared__ float stage[kFoldWarps][32 * kFoldStride];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = (blockIdx.x - tier1_blocks) * kFoldWarps + warp;
  if (s >= rows) return;  // the whole warp
  const int g = tier2_ids[s];
  if (g >= n) return;  // an empty row; the whole warp
  const int* row = pos + static_cast<int64_t>(n) * m1 +
                   static_cast<int64_t>(s) * m2;
  float* st = stage[warp];
  float acc = 0.0f;
  for (int c = 0; c < m2; c += 32) {
    const int p = c + lane < m2 ? row[c + lane] : lim;
#pragma unroll
    for (int f = 0; f < kFeat; ++f)
      st[lane * kFoldStride + f] =
          p < lim ? grads[static_cast<int64_t>(f) * pc + p] : 0.0f;
    __syncwarp();
    if (lane < kFeat) {
#pragma unroll
      for (int k = 0; k < 32; ++k) acc += st[k * kFoldStride + lane];
    }
    __syncwarp();
  }
  if (lane < kFeat) out[static_cast<int64_t>(lane) * n + g] = acc;
}

}  // namespace

// Plain C entries for ctypes. Each returns the CUDA error of its launch
// (0 = success); the caller raises on anything else.
extern "C" int pairs_row_totals(const float* data, int pc, const int* starts,
                                const int* counts, const int* blk_off,
                                const int* row_tile, int num_rows,
                                const float* cot, const float* boundary_t,
                                int num_tiles, int tiles_x, int tile_px,
                                int chunk, float* totals, void* stream) {
  return launch_rows<false>(data, pc, starts, counts, blk_off, row_tile,
                            num_rows, cot, nullptr, boundary_t, nullptr,
                            num_tiles, tiles_x, tile_px, chunk, totals,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int pairs_rows_suffix(const float* totals, const int* starts,
                                 const int* counts, const int* blk_off,
                                 int num_tiles, int tile_px, int chunk,
                                 float* suffix, void* stream) {
  if (num_tiles <= 0) return 0;
  const int p = tile_px * tile_px;
  const int vec = p % kPix == 0 && aligned16(totals) && aligned16(suffix);
  rows_suffix_kernel<<<num_tiles, min(threads_for(p), kMaxThreads), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      totals, starts, counts, blk_off, p, chunk, vec, suffix);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pairs_pass2(const float* data, int pc, const int* starts,
                           const int* counts, const int* blk_off,
                           const int* row_tile, int num_rows, const float* cot,
                           const float* fwd_out, const float* boundary_t,
                           const float* suffix, int num_tiles, int tiles_x,
                           int tile_px, int chunk, float* grads,
                           void* stream) {
  return launch_rows<true>(data, pc, starts, counts, blk_off, row_tile,
                           num_rows, cot, fwd_out, boundary_t, suffix,
                           num_tiles, tiles_x, tile_px, chunk, grads,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int pairs_fold(const float* grads, int pc, const int64_t* perm,
                          int e, int shift, const int* tier2_ids, int rows,
                          int n, int m1, int m2, const int* used, int* pos,
                          float* out, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int span = max(e, kFeat * n);
  fold_layout_kernel<<<(span + 255) / 256, 256, 0, st>>>(
      perm, e, shift, kFeat * n, pos, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tier1_blocks = (n + kFoldThreads - 1) / kFoldThreads;
  const int tier2_blocks = (rows + kFoldWarps - 1) / kFoldWarps;
  fold_kernel<<<tier1_blocks + tier2_blocks, kFoldThreads, 0, st>>>(
      grads, pc, pos, tier2_ids, rows, n, m1, m2, tier1_blocks, used, out);
  return static_cast<int>(cudaGetLastError());
}
