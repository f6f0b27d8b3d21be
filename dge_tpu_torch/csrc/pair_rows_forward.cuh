// The forward pair-stream compositing as two kernels, templated on how the
// in-block prefix of transmittance is formed: kLog = false is K1
// (pairs_composite.cu, a running product), kLog = true is its log-space arm
// K5 (pairs_logdot.cu, a running sum of logf(1 - alpha) and one expf a kept
// pair). Each source instantiates its form and has its own C entry points.
// pairs_composite.cu's source note states what the pair computes, the block
// rule, the design and the bound.

#pragma once

#include "pair_rows.cuh"

namespace dge {

constexpr int kRowFields = 7;      // [R, 7(8), P] scratch: see below
constexpr int kCombineWarps = 4;   // mask groups (warps) a combine block
constexpr int kBatch = 4;          // pairs a walk takes the alphas of at once

// Scratch fields per (row, pixel), computed as if the row were entered with
// transmittance 1; a pixel's walk stops at its first kept pair whose prefix
// cp falls below 1e-4 (no entering T <= 1 can then apply every pair):
//   0 cp_last  the prefix after the last pair walked (< 1e-4 if stopped)
//   1 cp_first 1 - alpha of the first kept pair (K5: expf(logf(...))), or 1
//   2 j0       the first kept pair's index in the row, or n
//   3-6 L      sum over applied pairs of alpha * cp_before * (r, g, b, depth)
//   7 cp_min   K5 only: the least prefix walked (expf is not monotone)
// and the keep mask [R, G, W] (G groups of 32 pixels, W = ceil(chunk/32)
// words): bit j of (row, group) is set iff some pixel of the group keeps
// pair j while its prefix is still >= 1e-4. A walk visits only those pairs:
// a pixel whose prefix from T = 1 has fallen below 1e-4 is refused, for any
// entering T <= 1, at or before that pair.
//
// A group is eight threads of a row kernel's warp, lanes 2a, 2a + 1 of each
// eight (group 4 * warp + a): in a 32-pixel-wide tile an 8x4 pixel patch,
// which fewer Gaussians touch than a line of 32 pixels, so a walk over the
// group's mask visits fewer pairs. G = 4 per 128 pixels.
__host__ __device__ constexpr int row_fields(bool log_space) {
  return log_space ? kRowFields + 1 : kRowFields;
}

__host__ __device__ constexpr int mask_groups(int p) {
  return 4 * ((p + 32 * kPix - 1) / (32 * kPix));
}

// Pixel id of lane `lane` of group `g` (lane / 4 picks the group's thread,
// lane % 4 the thread's pixel).
__device__ __forceinline__ int group_pixel(int g, int lane) {
  const int tid = 32 * (g >> 2) + 8 * (lane >> 3) + 2 * (g & 3) +
                  ((lane >> 2) & 1);
  return kPix * tid + (lane & 3);
}

// Whether any lane of the (whole, converged) warp holds `x`.
__device__ __forceinline__ bool on_any(bool x) {
  return __any_sync(kFullWarp, x);
}

template <bool kLog>
__global__ void __launch_bounds__(kMaxThreads, 2) rows_forward_kernel(
    const float* __restrict__ data,    // [kFeat, pc]
    int pc,
    const int* __restrict__ starts,    // [T]
    const int* __restrict__ counts,    // [T]
    const int* __restrict__ blk_off,   // [T]
    const int* __restrict__ row_tile,  // [R] tile of each row, T = unused
    int num_tiles, int tiles_x, int tile_px, int chunk, int vec,
    float* __restrict__ scratch,       // [R, row_fields, P]
    unsigned* __restrict__ mask) {     // [R, G, W]
  extern __shared__ float4 stage4[];   // [chunk, kStride], then [G, W] mask
  constexpr int kF = row_fields(kLog);
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
  const int groups = mask_groups(p);
  const int words = (chunk + 31) / 32;
  unsigned* const mask_s = reinterpret_cast<unsigned*>(stage4 + 3 * chunk);
  for (int i = tid; i < groups * words; i += blockDim.x) mask_s[i] = 0u;
  __syncthreads();

  const float ox = static_cast<float>((t % tiles_x) * tile_px);
  const float oy = static_cast<float>((t / tiles_x) * tile_px);
  const int q_first = 32 * kPix * warp;
  const WarpPatch patch(q_first, min(q_first + 32 * kPix, p) - 1, tile_px,
                        ox, oy);

  // a stopped pixel carries cp < 1e-4; the lanes past the tile's pixels
  // start stopped and only take part in the warp votes
  float px[kPix], py[kPix], cp[kPix], cp_first[kPix], cp_min[kPix],
      ls[kPix], lr[kPix], lg[kPix], lb[kPix], ld[kPix];
  int j0[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int q = q0 + i;
    px[i] = ox + static_cast<float>(q % tile_px);
    py[i] = oy + static_cast<float>(q / tile_px);
    cp[i] = cp_min[i] = q < p ? 1.0f : 0.0f;
    cp_first[i] = 1.0f;
    ls[i] = lr[i] = lg[i] = lb[i] = ld[i] = 0.0f;
    j0[i] = n;
  }

  for (int j = 0; j < n; ++j) {
    const float4 f0 = stage4[3 * j + 0];  // mx, my, a, b
    const float4 f1 = stage4[3 * j + 1];  // c, op, r, g
    const float4 f2 = stage4[3 * j + 2];  // b, d, reject r2, pad
    if (patch.far(f0, f2)) continue;  // warp-uniform

    float alpha[kPix];
    bool keep[kPix];
    bool any_keep = false;
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      float dx, dy, ex, raw;
      keep[i] = alpha_at(f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, px[i], py[i],
                         dx, dy, ex, raw, alpha[i]) &&
                (cp[i] >= kTEps);
      any_keep |= keep[i];
    }
    const unsigned keepers = __ballot_sync(kFullWarp, any_keep);
    if (!keepers) continue;
    // lane a < 4 records the bit of group 4 * warp + a
    if (lane < 4 && ((keepers >> (2 * lane)) & 0x03030303u))
      mask_s[(4 * warp + lane) * words + (j >> 5)] |= 1u << (j & 31);

#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      if (!keep[i]) continue;
      const float one_minus = 1.0f - alpha[i];
      float cp_next;
      if (kLog) {
        ls[i] += logf(one_minus);
        cp_next = expf(ls[i]);
        cp_min[i] = fminf(cp_min[i], cp_next);
      } else {
        cp_next = cp[i] * one_minus;
      }
      if (j0[i] == n) {
        j0[i] = j;
        cp_first[i] = cp_next;
      }
      if (cp_next >= kTEps) {  // applied when entered with T = 1
        const float w = alpha[i] * cp[i];
        lr[i] += w * f1.z;
        lg[i] += w * f1.w;
        lb[i] += w * f2.x;
        ld[i] += w * f2.y;
      }
      cp[i] = cp_next;
    }
    const bool all_stopped =
        fmaxf(fmaxf(cp[0], cp[1]), fmaxf(cp[2], cp[3])) < kTEps;
    if (__all_sync(kFullWarp, all_stopped)) break;
  }

  if (q0 < p) {
    float* s = scratch + static_cast<size_t>(row) * kF * p;
    float j0f[kPix];
#pragma unroll
    for (int i = 0; i < kPix; ++i) j0f[i] = static_cast<float>(j0[i]);
    store4(s + 0 * p, q0, p, vec, cp);
    store4(s + 1 * p, q0, p, vec, cp_first);
    store4(s + 2 * p, q0, p, vec, j0f);
    store4(s + 3 * p, q0, p, vec, lr);
    store4(s + 4 * p, q0, p, vec, lg);
    store4(s + 5 * p, q0, p, vec, lb);
    store4(s + 6 * p, q0, p, vec, ld);
    if (kLog) store4(s + 7 * p, q0, p, vec, cp_min);
  }
  __syncthreads();
  unsigned* const m = mask + static_cast<size_t>(row) * groups * words;
  for (int i = tid; i < groups * words; i += blockDim.x) m[i] = mask_s[i];
}

// One thread a pixel, one warp per mask group of a tile (its 32 pixels),
// each warp on its own: the warp goes over its tile's rows in order from
// T = 1 and settles each row from the scratch (all applied / none applied),
// or, where some lane's entering T falls between the two, walks the row's
// pairs together with the other such lanes from the first of their first
// kept pairs, over the pairs its group's keep mask holds, with the
// arithmetic of the one-block-per-tile walk, until every walking lane is
// refused.
template <bool kLog>
__global__ void __launch_bounds__(32 * kCombineWarps) rows_combine_kernel(
    const float* __restrict__ scratch,  // [R, row_fields, P]
    const unsigned* __restrict__ mask,  // [R, G, W]
    const float* __restrict__ data,     // [kFeat, pc]
    int pc,
    const int* __restrict__ starts,     // [T]
    const int* __restrict__ counts,     // [T]
    const int* __restrict__ blk_off,    // [T]
    int tiles_x, int tile_px, int chunk,
    float* __restrict__ out,            // [T, 5, P]: r, g, b, depth, final T
    float* __restrict__ boundary_t) {   // [R, P] entering T per row, or null
  __shared__ float4 word_s[kCombineWarps][32][3];  // a walk's mask word
  constexpr int kF = row_fields(kLog);
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = tile_px * tile_px;
  const int groups = mask_groups(p);
  const int words = (chunk + 31) / 32;
  const int g = blockIdx.y * kCombineWarps + warp;
  // a group past the tile's pixels (its lane 0 holds its least pixel)
  if (g >= groups || group_pixel(g, 0) >= p) return;
  const int q = group_pixel(g, lane);
  const bool valid = q < p;
  float4 (*const stage)[3] = word_s[warp];

  const float ox = static_cast<float>((t % tiles_x) * tile_px);
  const float oy = static_cast<float>((t / tiles_x) * tile_px);
  const float px = ox + static_cast<float>(q % tile_px);
  const float py = oy + static_cast<float>(q / tile_px);

  float trans = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  const int start = starts[t];
  const int end = start + counts[t];
  const int row0 = blk_off[t];
  // an empty tile has no row (its start may lie past a block's edge)
  const int first = start < end ? (start / chunk) * chunk : end;
  // a row's scratch is loaded one row ahead, so its loads are in flight
  // while the current row is settled or walked
  float next[kF];
  const float* s = scratch + static_cast<size_t>(row0) * kF * p + q;
#pragma unroll
  for (int f = 0; f < kF; ++f) next[f] = valid && first < end ? s[f * p] : 0.0f;
  for (int base = first, row = row0; base < end; base += chunk, ++row) {
    const int lo = max(start, base);
    const int n = min(end, base + chunk) - lo;
    float cur[kF];
#pragma unroll
    for (int f = 0; f < kF; ++f) cur[f] = next[f];
    s += kF * p;
#pragma unroll
    for (int f = 0; f < kF; ++f)
      next[f] = valid && base + chunk < end ? s[f * p] : 0.0f;
    bool walk = false;
    int j0 = n;
    if (valid) {
      if (boundary_t) boundary_t[static_cast<size_t>(row) * p + q] = trans;
      const float cp_last = cur[0];
      if (trans * cur[kLog ? 7 : 0] >= kTEps) {  // every kept pair applied
        acc_r += trans * cur[3];
        acc_g += trans * cur[4];
        acc_b += trans * cur[5];
        acc_d += trans * cur[6];
        trans = trans * cp_last;
      } else if (trans * cur[1] >= kTEps) {  // some applied: walk
        walk = true;
        j0 = static_cast<int>(cur[2]);
      }  // else the first kept pair is refused: nothing applied
    }
    if (!__any_sync(kFullWarp, walk)) continue;

    // walk the pairs of the group's mask from the least j0, one mask word
    // (32 pairs) at a time: lane l stages pair 32w + l in the warp's shared
    // slot (ten coalesced loads, one round trip a word), then the word's
    // pairs are read back, kBatch at a time (their alphas together), and
    // applied in order
    const unsigned* gm =
        mask + (static_cast<size_t>(row) * groups + g) * words;
    const int jstart = __reduce_min_sync(kFullWarp, j0);
    const int last_word = (n - 1) >> 5;  // < words <= 32
    const unsigned lane_word = lane <= last_word ? gm[lane] : 0u;
    const float tb = trans;
    float cp = 1.0f, ls = 0.0f;
    bool on = walk;
    for (int w = jstart >> 5; on_any(on) && w <= last_word; ++w) {
      unsigned bits = __shfl_sync(kFullWarp, lane_word, w);
      if (w == jstart >> 5) bits &= ~0u << (jstart & 31);
      if (bits == 0u) continue;
      float mine[kFeat];
      const float* col = data + lo + min(32 * w + lane, n - 1);
#pragma unroll
      for (int k = 0; k < kFeat; ++k)
        mine[k] = col[static_cast<size_t>(k) * pc];
      __syncwarp();  // the previous word's reads are done
      stage[lane][0] = make_float4(mine[0], mine[1], mine[2], mine[3]);
      stage[lane][1] = make_float4(mine[4], mine[5], mine[6], mine[7]);
      stage[lane][2] = make_float4(mine[8], mine[9], 0.0f, 0.0f);
      __syncwarp();
      while (bits != 0u && on_any(on)) {
        int us[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          us[u] = bits ? __ffs(bits) - 1 : -1;
          bits &= bits - 1u;
        }
        float4 f0[kBatch], f1[kBatch], f2[kBatch];  // as the row stage
        float alpha[kBatch];
        bool keep[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int slot = max(us[u], 0);
          f0[u] = stage[slot][0];
          f1[u] = stage[slot][1];
          f2[u] = stage[slot][2];
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          float dx, dy, ex, raw;
          keep[u] = us[u] >= 0 &&
                    alpha_at(f0[u].x, f0[u].y, f0[u].z, f0[u].w, f1[u].x,
                             f1[u].y, px, py, dx, dy, ex, raw, alpha[u]);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (!(keep[u] && on)) continue;
          const float one_minus = 1.0f - alpha[u];
          float cp_next;
          if (kLog) {
            ls += logf(one_minus);
            cp_next = expf(ls);
          } else {
            cp_next = cp * one_minus;
          }
          const float t_hyp = tb * cp_next;
          if (t_hyp >= kTEps) {
            const float wgt = alpha[u] * tb * (cp_next / one_minus);
            acc_r += wgt * f1[u].z;
            acc_g += wgt * f1[u].w;
            acc_b += wgt * f2[u].x;
            acc_d += wgt * f2[u].y;
            cp = cp_next;
            trans = t_hyp;
          } else {
            on = false;  // refused: the rest of this row too
          }
        }
      }
    }
  }

  if (valid) {
    float* o = out + static_cast<size_t>(t) * 5 * p + q;
    o[0 * p] = acc_r;
    o[1 * p] = acc_g;
    o[2 * p] = acc_b;
    o[3 * p] = acc_d;
    o[4 * p] = trans;
  }
}

template <bool kLog>
int launch_rows_forward(const float* data, int pc, const int* starts,
                        const int* counts, const int* blk_off,
                        const int* row_tile, int num_rows, int num_tiles,
                        int tiles_x, int tile_px, int chunk, float* scratch,
                        unsigned* mask, cudaStream_t stream) {
  if (num_rows <= 0) return 0;
  const int p = tile_px * tile_px;
  const size_t smem =
      sizeof(float4) * 3 * static_cast<size_t>(chunk) +
      sizeof(unsigned) * mask_groups(p) * ((chunk + 31) / 32);
  const int vec = p % kPix == 0 && aligned16(scratch);
  rows_forward_kernel<kLog><<<num_rows, threads_for(p), smem, stream>>>(
      data, pc, starts, counts, blk_off, row_tile, num_tiles, tiles_x,
      tile_px, chunk, vec, scratch, mask);
  return static_cast<int>(cudaGetLastError());
}

template <bool kLog>
int launch_rows_combine(const float* scratch, const unsigned* mask,
                        const float* data, int pc,
                        const int* starts, const int* counts,
                        const int* blk_off, int num_tiles, int tiles_x,
                        int tile_px, int chunk, float* out, float* boundary_t,
                        cudaStream_t stream) {
  if (num_tiles <= 0) return 0;
  const int p = tile_px * tile_px;
  const dim3 grid(num_tiles,
                  (mask_groups(p) + kCombineWarps - 1) / kCombineWarps);
  rows_combine_kernel<kLog><<<grid, 32 * kCombineWarps, 0, stream>>>(
      scratch, mask, data, pc, starts, counts, blk_off, tiles_x, tile_px,
      chunk, out, boundary_t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dge
