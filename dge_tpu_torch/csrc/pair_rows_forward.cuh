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
constexpr int kBatch = 4;          // pairs a walk takes the alphas of at once
constexpr int kBandWarps = 8;      // consumer warps (mask groups) a combine block
constexpr int kMaxStages = 8;      // rows a combine ring holds at most
constexpr size_t kRingBytes = 64 * 1024;  // a combine ring's target size

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

// Shared-memory primitives of the combine's ring: mbarriers, bulk copies
// (the Tensor Memory Accelerator, completion counted in bytes on a stage's
// "full" barrier) and 4-byte cp.async copies for what is not 16-byte
// aligned (each lane's arrival on the barrier waits for its own copies).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the bulk-copy unit.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared.b64 state, [%0];\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// One arrival on `bar` that also expects `bytes` more of bulk copies.
__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar,
                                                  unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory, counted on `bar` as it lands.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// One arrival on `bar` once every cp.async this thread has issued so far
// has landed (the arrival counts against the barrier's expected count).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Floats a field of a row's pairs takes in a stage: the row's n <= chunk
// values at their own 16-byte phase (up to 3 floats before the first).
__host__ __device__ constexpr int pair_field_floats(int chunk) {
  return (chunk + 3 + 3) / 4 * 4;
}

// A stage of the combine's ring holds one row for one block: the row's
// pairs field by field [kFeat, pair_field_floats] (field k of pair j at
// k * field + phase_k + j, phase_k the 16-byte phase of the field's first
// value in global memory, so that the aligned middle of every field is one
// bulk copy), the scratch of the block's 32 W pixels [kF, 32 W] (W groups
// of 32 are 32 W pixels in a row, from 128 * (g0 / 4)), and the keep-mask
// words of the block's W groups [W, words]. Every part is a multiple of 16
// bytes (W is 4 or 8).
__host__ __device__ constexpr size_t combine_stage_floats(bool log_space,
                                                          int chunk,
                                                          int band) {
  return static_cast<size_t>(kFeat) * pair_field_floats(chunk) +
         static_cast<size_t>(row_fields(log_space)) * 32 * band +
         static_cast<size_t>(band) * ((chunk + 31) / 32);
}

// The 16-byte phase of a float's address, in floats.
__device__ __forceinline__ int phase4(const float* x) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(x) >> 2) & 3);
}

// Copy floats [a, a + n) to dst (at the same 16-byte phase, dst - phase4(a)
// 16-byte aligned) by one thread: the aligned middle as one bulk copy
// counted on `bar`, the ends with 4-byte cp.async. Returns the bulk bytes.
__device__ __forceinline__ unsigned copy_span(float* dst, const float* a,
                                              int n, uint64_t* bar) {
  const int head = min((4 - phase4(a)) & 3, n);
  const int body = (n - head) & ~3;
  for (int i = 0; i < head; ++i) cp_async4(dst + i, a + i);
  for (int i = head + body; i < n; ++i) cp_async4(dst + i, a + i);
  if (body > 0) bulk_copy(dst + head, a + head, 4u * body, bar);
  return 4u * body;
}

// The bulk bytes copy_span moves for [a, a + n).
__device__ __forceinline__ unsigned span_bytes(const float* a, int n) {
  const int head = min((4 - phase4(a)) & 3, n);
  return 4u * ((n - head) & ~3);
}

// A block takes one tile, or a band of W of its mask groups: one producer
// warp and W consumer warps, one consumer thread a pixel, one consumer warp
// a group. The producer walks the tile's rows in order and copies each into
// a ring of `stages` shared-memory stages, up to stages rows ahead of the
// consumers (nothing it copies depends on T): one lane a field of the
// row's pairs and one a field of the band's scratch, each the aligned
// middle as one bulk copy and the unaligned ends (a row's first stream
// position has no alignment) with 4-byte cp.async; so the copies take the
// lanes a few instructions a row whatever the row's length. The consumers
// go over the rows in order from T = 1 as the stages fill (a stage's
// "full" barrier), and settle each from its staged scratch (all applied /
// none applied), or, where some lane's entering T falls between the two,
// walk the row's staged pairs together with the other such lanes from the
// first of their first kept pairs, over the pairs their group's staged
// keep mask holds, with the arithmetic of the one-block-per-tile walk,
// until every walking lane is refused; then the warp releases the stage
// (its "empty" barrier, one arrival a consumer warp) for the producer to
// refill. So the chain of rows waits on shared memory, and a warp may run
// up to the ring's depth ahead of the block's slowest.
template <bool kLog>
__global__ void __launch_bounds__(32 * (kBandWarps + 1)) rows_combine_kernel(
    const float* __restrict__ scratch,  // [R, row_fields, P]
    const unsigned* __restrict__ mask,  // [R, G, W]
    const float* __restrict__ data,     // [kFeat, pc]
    int pc,
    const int* __restrict__ starts,     // [T]
    const int* __restrict__ counts,     // [T]
    const int* __restrict__ blk_off,    // [T]
    int tiles_x, int tile_px, int chunk, int stages,
    int vec,  // scratch and mask 16-byte aligned, P a multiple of 4
    float* __restrict__ out,            // [T, 5, P]: r, g, b, depth, final T
    float* __restrict__ boundary_t) {   // [R, P] entering T per row, or null
  extern __shared__ __align__(16) unsigned char ring[];
  constexpr int kF = row_fields(kLog);
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;  // 0 the producer, 1 .. W consumers
  const int band = blockDim.x / 32 - 1;
  const int p = tile_px * tile_px;
  const int groups = mask_groups(p);
  const int words = (chunk + 31) / 32;
  const int g0 = blockIdx.y * band;
  const int px0 = 32 * kPix * (g0 >> 2);  // the band's first pixel
  const int band_px = min(32 * band, p - px0);
  const int band_words = min(band, groups - g0) * words;
  const int start = starts[t];
  const int end = start + counts[t];
  const int row0 = blk_off[t];
  // an empty tile has no row (its start may lie past a block's edge)
  if (start >= end) {
    if (warp > 0) {
      const int g = g0 + warp - 1;
      const int q = g < groups ? group_pixel(g, lane) : p;
      if (q < p) {
        float* o = out + static_cast<size_t>(t) * 5 * p + q;
        o[0 * p] = o[1 * p] = o[2 * p] = o[3 * p] = 0.0f;
        o[4 * p] = 1.0f;
      }
    }
    return;
  }
  const int first = (start / chunk) * chunk;
  const int nrows = (end - 1) / chunk - start / chunk + 1;

  uint64_t* const full = reinterpret_cast<uint64_t*>(ring);
  uint64_t* const empty = full + stages;
  float* const stage0 = reinterpret_cast<float*>(ring + 16 * stages);
  const int field = pair_field_floats(chunk);
  const int pair_floats = kFeat * field;
  const int sc_floats = kF * 32 * band;
  const size_t stage_floats = combine_stage_floats(kLog, chunk, band);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 33);     // the producer's lanes, and its bytes
      mbar_init(empty + s, band);  // the consumer warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 0) {  // the producer
    for (int r = 0; r < nrows; ++r) {
      const int s = r % stages;
      if (r >= stages) mbar_wait(empty + s, (r / stages + 1) & 1);
      float* const st = stage0 + s * stage_floats;
      const int base = first + r * chunk;
      const int lo = max(start, base);
      const int n = min(end, base + chunk) - lo;
      const float* const srow =
          scratch + static_cast<size_t>(row0 + r) * kF * p + px0;
      const float* const mrow =
          reinterpret_cast<const float*>(mask) +
          (static_cast<size_t>(row0 + r) * groups + g0) * words;
      // lane k < kFeat: pair field k; then, where aligned, a scratch field
      // a lane and the mask words
      const float* src = nullptr;
      float* dst = nullptr;
      int len = 0;
      if (lane < kFeat) {
        src = data + static_cast<size_t>(lane) * pc + lo;
        dst = st + lane * field + phase4(src);
        len = n;
      } else if (vec && lane < kFeat + kF) {
        src = srow + static_cast<size_t>(lane - kFeat) * p;
        dst = st + pair_floats + (lane - kFeat) * 32 * band;
        len = band_px;
      } else if (vec && lane == kFeat + kF) {
        src = mrow;
        dst = st + pair_floats + sc_floats;
        len = band_words;
      }
      const unsigned bytes =
          __reduce_add_sync(kFullWarp, len > 0 ? span_bytes(src, len) : 0u);
      if (lane == 0) mbar_expect_bytes(full + s, bytes);
      __syncwarp();
      if (len > 0) copy_span(dst, src, len, full + s);
      if (!vec) {  // scratch and mask, 4 bytes a copy
        for (int f = 0; f < kF; ++f)
          for (int i = lane; i < band_px; i += 32)
            cp_async4(st + pair_floats + f * 32 * band + i,
                      srow + static_cast<size_t>(f) * p + i);
        for (int i = lane; i < band_words; i += 32)
          cp_async4(st + pair_floats + sc_floats + i, mrow + i);
      }
      cp_async_arrive(full + s);
    }
    cp_async_wait_all();
    return;
  }

  const int cw = warp - 1;
  const int g = g0 + cw;
  const int q = g < groups ? group_pixel(g, lane) : p;
  const bool valid = q < p;
  const float ox = static_cast<float>((t % tiles_x) * tile_px);
  const float oy = static_cast<float>((t / tiles_x) * tile_px);
  const float px = ox + static_cast<float>(q % tile_px);
  const float py = oy + static_cast<float>(q / tile_px);

  float trans = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  for (int r = 0; r < nrows; ++r) {
    const int s = r % stages;
    mbar_wait(full + s, (r / stages) & 1);
    const float* const st = stage0 + s * stage_floats;
    const int base = first + r * chunk;
    const int lo = max(start, base);
    const int n = min(end, base + chunk) - lo;
    const int row = row0 + r;
    bool walk = false;
    int j0 = n;
    if (valid) {
      float cur[kF];
#pragma unroll
      for (int f = 0; f < kF; ++f)
        cur[f] = st[pair_floats + f * 32 * band + q - px0];
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
    if (__any_sync(kFullWarp, walk)) {
      // walk the staged pairs of the group's mask from the least j0, one
      // mask word (32 pairs) at a time, kBatch pairs' alphas together,
      // applied in order
      int fk[kFeat];  // field k of the row's pair j at st[fk[k] + j]
#pragma unroll
      for (int k = 0; k < kFeat; ++k)
        fk[k] = k * field + phase4(data + static_cast<size_t>(k) * pc + lo);
      const unsigned* const ms =
          reinterpret_cast<const unsigned*>(st + pair_floats + sc_floats) +
          cw * words;
      const int jstart = __reduce_min_sync(kFullWarp, j0);
      const int last_word = (n - 1) >> 5;  // < words <= 32
      const unsigned lane_word = lane <= last_word ? ms[lane] : 0u;
      const float tb = trans;
      float cp = 1.0f, ls = 0.0f;
      bool on = walk;
      for (int w = jstart >> 5; on_any(on) && w <= last_word; ++w) {
        unsigned bits = __shfl_sync(kFullWarp, lane_word, w);
        if (w == jstart >> 5) bits &= ~0u << (jstart & 31);
        while (bits != 0u && on_any(on)) {
          int us[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            us[u] = bits ? __ffs(bits) - 1 : -1;
            bits &= bits - 1u;
          }
          float f[kBatch][kFeat];  // mx, my, a, b, c, op, r, g, b, d
          float alpha[kBatch];
          bool keep[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int j = 32 * w + max(us[u], 0);
#pragma unroll
            for (int k = 0; k < kFeat; ++k) f[u][k] = st[fk[k] + j];
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            float dx, dy, ex, raw;
            alpha[u] = 0.0f;
            keep[u] = us[u] >= 0 &&
                      alpha_at(f[u][0], f[u][1], f[u][2], f[u][3], f[u][4],
                               f[u][5], px, py, dx, dy, ex, raw, alpha[u]);
          }
          // the batch's pairs in order: the prefix, the committed T and
          // whether the lane still walks, then the weights of the applied
          // pairs (their divisions wait on no other pair) and the sums in
          // order: the operands and order of one pair at a time
          float cpn[kBatch], om[kBatch];
          bool app[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            om[u] = 1.0f - alpha[u];
            const bool go = keep[u] && on;
            float cp_next;
            if (kLog) {
              const float ls_next = ls + logf(om[u]);
              cp_next = expf(ls_next);
              if (go) ls = ls_next;
            } else {
              cp_next = cp * om[u];
            }
            const float t_hyp = tb * cp_next;
            app[u] = go && t_hyp >= kTEps;
            if (go && !app[u]) on = false;  // refused: the rest of this row
            if (app[u]) {
              cp = cp_next;
              trans = t_hyp;
            }
            cpn[u] = cp_next;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (!app[u]) continue;
            const float wgt = alpha[u] * tb * (cpn[u] / om[u]);
            acc_r += wgt * f[u][6];
            acc_g += wgt * f[u][7];
            acc_b += wgt * f[u][8];
            acc_d += wgt * f[u][9];
          }
        }
      }
    }
    __syncwarp();  // the warp's reads of the stage are done
    if (lane == 0) mbar_arrive(empty + s);
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

// Launch the combine: a block per (tile, band of W mask groups), W + 1
// warps, a ring as deep as fits kRingBytes (2 to kMaxStages rows); shared
// memory above the 48 KB default is asked for once per device and size.
template <bool kLog>
int launch_rows_combine(const float* scratch, const unsigned* mask,
                        const float* data, int pc,
                        const int* starts, const int* counts,
                        const int* blk_off, int num_tiles, int tiles_x,
                        int tile_px, int chunk, float* out, float* boundary_t,
                        cudaStream_t stream) {
  if (num_tiles <= 0) return 0;
  static size_t granted[kMaxDevices] = {};
  const int groups = mask_groups(tile_px * tile_px);
  const int band = groups < kBandWarps ? groups : kBandWarps;
  const size_t stage =
      sizeof(float) * combine_stage_floats(kLog, chunk, band);
  const size_t fit = kRingBytes / stage;
  const int stages = fit < 2 ? 2 : fit > kMaxStages ? kMaxStages
                                                    : static_cast<int>(fit);
  const size_t smem = (2 * sizeof(uint64_t) + stage) * stages;
  const int err = grant_dynamic_smem(rows_combine_kernel<kLog>, smem, granted);
  if (err != 0) return err;
  const int vec = tile_px * tile_px % 4 == 0 && aligned16(scratch) &&
                  aligned16(mask);
  const dim3 grid(num_tiles, (groups + band - 1) / band);
  rows_combine_kernel<kLog><<<grid, 32 * (band + 1), smem, stream>>>(
      scratch, mask, data, pc, starts, counts, blk_off, tiles_x, tile_px,
      chunk, stages, vec, out, boundary_t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dge
