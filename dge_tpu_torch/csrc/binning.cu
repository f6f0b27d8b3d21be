// Pair binning for NVIDIA Hopper (sm_90a): the two-tier (tile, Gaussian)
// keys of `bin_gaussians_pairs` with the tight cull, and the tile ranges and
// pair ids recovered from the sorted keys, in three kernels around one
// `torch.sort`.
//
// Replaces no Pallas kernel. It replaces, on the card, the jnp binning of
// dge_tpu/ops/binning.py (`bin_gaussians_pairs`, `_bucketed_pair_keys`,
// `_compact_tier`), which the port first carried over as plain PyTorch
// (`_pair_sort` in dge_tpu_torch/ops/binning.py, still the CPU twin). That
// version runs 172 aten ops a call, 478 with the tight cull, most of them
// small elementwise launches (the tier-2 cull alone walks a [r, b2] grid,
// 2.1 M elements, once per step of the quadratic's minimum, then sorts it per
// column), and uploads four host constants, each a stream drain: the render
// of a 1920x1080 view of 144k Gaussians spent 10.6 ms of its ~16 ms frame in
// it with the card idle most of that time. Python side:
// dge_tpu_torch/ops/binning.py (`_pair_sort_kernels`), which builds this
// file with nvcc at first use and loads it with ctypes. Upstream's
// counterparts are duplicateWithKeys / identifyTileRanges
// (rasterizer_impl.cu); the emission, culling and caps are this port's own.
//
// What it computes, bit for bit as `_pair_sort` on the card:
//   rects   one thread per Gaussian: tile_rects' (x0, y0, w, h) and vis,
//           the tier-2 member flag vis & w*h > m1, and the min and max of
//           the depths over vis (over `seen` with depth_keys): a warp and
//           block reduction, then one atomicMax a block on the float's
//           ordered bits (min and max do not depend on order, so this is
//           exact; a NaN depth makes both NaN, as torch.min / max do).
//   (the wrapper takes the members' inclusive prefix sum with torch.cumsum)
//   emit    tier 1, one thread per slot g*m1 + j: the j-th tile of g's
//           row-major rect, or the sentinel tile; tier 2, one warp per row
//           s at slot N*m1 + s*m2: the row's Gaussian (the s-th member by
//           id, found by a binary search of the prefix sum) walks its rect
//           tiles j < r = min(T, max(256, 2*m2)), 32 at a time, and writes
//           the tiles the cull keeps, in order, into its first m2 slots (a
//           ballot and a popcount give each its slot) while it counts the
//           kept tiles past m2 for the slot spill. Keys are
//           tile << depth_bits | dq. It also writes tier2_ids and the slot
//           and cap spills (integer atomics, exact in any order).
//   (the wrapper sorts the keys: torch.sort(keys, stable=True))
//   ranges  one thread per tile: the lower bounds of t << bits and (t+1) <<
//           bits in the sorted keys (searchsorted's values), the counts
//           under max_per_tile and max_pairs, the tile and stream spills and
//           the stream length; one thread per stream position p <
//           max_pairs: pair_ids[p] from the slot perm[p] (slot / m1 in tier
//           1, the row's Gaussian in tier 2, 0 for an empty row), so the
//           [E] ids and their gather are never built.
//
// Exactness. Each float operation of the torch path is repeated one by one
// in its order with __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn (nvcc
// fuses none of them into an FMA), logf for torch.log, truncating float to
// int32 casts; torch.maximum / minimum / clamp keep a NaN as PyTorch's CUDA
// kernels do. A tensor divided by a Python number is multiplied on the card
// by the number's float reciprocal, as PyTorch's CUDA kernel does (`/
// tile_px`); a tensor divided by a tensor is divided.
//
// Bound. Bytes, and far below what the launches cost: the Gaussians' 33
// bytes each read (mean2d, depth, radius, visible, conic, opacity), E int32
// keys written and sorted, max_pairs ids written; at 1080p (144k Gaussians,
// E ~0.84 M) some 30 MB with the sort, under 0.01 ms at 3.35 TB/s. The
// design therefore spends launches, not bytes: three kernels of its own,
// every constant a kernel argument (no upload, so no stream drain), no
// [E]-sized intermediate but the keys the sort needs.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// the workspace, int32 [8] zeroed by the wrapper: the depths' min (as the
// complement of its ordered bits, so that both reductions are atomicMax)
// and max, a NaN flag, then spill_parts (slot, cap, tile, stream) and spill
enum { kMinKey, kMaxKey, kNan, kSlot, kCap, kTile, kStream, kSpill };

// Python's float constants as PyTorch passes them to a float kernel: the
// double rounded to float
constexpr float kMinClamp = static_cast<float>(1e-12);
constexpr float kQMargin = static_cast<float>(1e-3);  // binning.CULL_Q_MARGIN
constexpr float kQRel = static_cast<float>(2e-5);     // binning.CULL_Q_REL

// a float's bits mapped to an unsigned order that agrees with the floats'
__device__ __forceinline__ unsigned ordered_bits(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// torch.maximum / torch.minimum on the card: a NaN wins, else max / min
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return tmin(tmax(x, lo), hi);
}

__device__ __forceinline__ void add_spill(unsigned* ws, int part,
                                          unsigned v) {
  atomicAdd(ws + part, v);
  atomicAdd(ws + kSpill, v);
}

// _quantize_depth: the depth field of the keys from the reduced min / max
struct DepthField {
  float dmin, den, scale;
  int maxq;
};

__device__ __forceinline__ DepthField depth_field(const unsigned* ws,
                                                  int bits) {
  float dmin = INFINITY, dmax = -INFINITY;
  if (ws[kNan]) {
    dmin = dmax = NAN;
  } else {
    if (ws[kMinKey]) dmin = from_ordered(~ws[kMinKey]);
    if (ws[kMaxKey]) dmax = from_ordered(ws[kMaxKey]);
  }
  DepthField f;
  f.dmin = dmin;
  f.den = tmax(__fsub_rn(dmax, dmin), kMinClamp);
  f.maxq = (1 << bits) - 1;
  f.scale = static_cast<float>(f.maxq);
  return f;
}

__device__ __forceinline__ int quantize(float d, const DepthField& f) {
  float v = clip(__fdiv_rn(__fsub_rn(d, f.dmin), f.den), 0.0f, 1.0f);
  const int q = __float2int_rz(__fmul_rn(v, f.scale));
  return min(max(q, 0), f.maxq);  // clamp after the cast, as the torch path
}

// one Gaussian's terms of the tight cull (_tile_keep_mask_T)
struct Cull {
  float mx, my, a, c, b2, nb, asafe, csafe, qc;
};

__device__ __forceinline__ Cull cull_terms(const float* mean2d,
                                           const float* conic,
                                           const float* opacity, int g) {
  Cull k;
  k.mx = mean2d[2 * g];
  k.my = mean2d[2 * g + 1];
  k.a = conic[3 * g];
  const float b = conic[3 * g + 1];
  k.c = conic[3 * g + 2];
  k.b2 = __fmul_rn(b, 2.0f);
  k.nb = -b;
  k.asafe = tmax(k.a, kMinClamp);
  k.csafe = tmax(k.c, kMinClamp);
  const float qcut = __fmul_rn(
      logf(__fmul_rn(tmax(opacity[g], kMinClamp), 255.0f)), 2.0f);
  k.qc = __fadd_rn(qcut, kQMargin);
  return k;
}

// q_pair: the quadratic at (u, v) and its cancellation scale
__device__ __forceinline__ void q_pair(const Cull& k, float u, float v,
                                       float& q, float& qa) {
  const float cross = __fmul_rn(__fmul_rn(k.b2, u), v);
  const float au = __fmul_rn(__fmul_rn(k.a, u), u);
  const float cv = __fmul_rn(__fmul_rn(k.c, v), v);
  q = __fadd_rn(__fadd_rn(au, cross), cv);
  qa = __fadd_rn(__fadd_rn(au, fabsf(cross)), cv);
}

// _tile_min_q_T and the keep test for tile (tx, ty): t = tile_px, tm1 =
// tile_px - 1
__device__ bool keep_tile(const Cull& k, int tx, int ty, float t,
                          float tm1) {
  const float txf = __fmul_rn(static_cast<float>(tx), t);
  const float tyf = __fmul_rn(static_cast<float>(ty), t);
  const float u0 = __fsub_rn(k.mx, __fadd_rn(txf, tm1));
  const float u1 = __fsub_rn(k.mx, txf);
  const float v0 = __fsub_rn(k.my, __fadd_rn(tyf, tm1));
  const float v1 = __fsub_rn(k.my, tyf);
  const bool inside = u0 <= 0.0f && 0.0f <= u1 && v0 <= 0.0f && 0.0f <= v1;
  float m, ma, q, qa;
  q_pair(k, u0, clip(__fdiv_rn(__fmul_rn(k.nb, u0), k.csafe), v0, v1), m,
         ma);
  q_pair(k, u1, clip(__fdiv_rn(__fmul_rn(k.nb, u1), k.csafe), v0, v1), q,
         qa);
  if (q < m) m = q, ma = qa;
  q_pair(k, clip(__fdiv_rn(__fmul_rn(k.nb, v0), k.asafe), u0, u1), v0, q,
         qa);
  if (q < m) m = q, ma = qa;
  q_pair(k, clip(__fdiv_rn(__fmul_rn(k.nb, v1), k.asafe), u0, u1), v1, q,
         qa);
  if (q < m) m = q, ma = qa;
  const float qmin = inside ? 0.0f : tmax(m, 0.0f);
  const float qabs = inside ? 0.0f : ma;
  return qmin <= __fadd_rn(k.qc, __fmul_rn(qabs, kQRel));
}

template <bool kSeen>
__global__ void __launch_bounds__(kThreads) rects_kernel(
    const float* __restrict__ mean2d, const float* __restrict__ radius,
    const bool* __restrict__ visible, const float* __restrict__ depth,
    const bool* __restrict__ seen, int n, float inv_tile, float tile_f,
    int tiles_x, int tiles_y, int m1,
    int4* __restrict__ rect,        // [n] x0, y0, w, vis ? h : 0
    int* __restrict__ member,       // [n] vis & w*h > m1
    unsigned* __restrict__ ws) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  unsigned lo = 0, hi = 0;  // ~ordered min, ordered max; 0 = none
  int nan = 0;
  if (g < n) {
    const float mx = mean2d[2 * g], my = mean2d[2 * g + 1], r = radius[g];
    const float fx = static_cast<float>(tiles_x);
    const float fy = static_cast<float>(tiles_y);
    const float x0f = clip(floorf(__fmul_rn(__fsub_rn(mx, r), inv_tile)),
                           0.0f, fx);
    const float y0f = clip(floorf(__fmul_rn(__fsub_rn(my, r), inv_tile)),
                           0.0f, fy);
    const float x1f = clip(floorf(__fmul_rn(
        __fsub_rn(__fadd_rn(__fadd_rn(mx, r), tile_f), 1.0f), inv_tile)),
        0.0f, fx);
    const float y1f = clip(floorf(__fmul_rn(
        __fsub_rn(__fadd_rn(__fadd_rn(my, r), tile_f), 1.0f), inv_tile)),
        0.0f, fy);
    const bool empty =
        __fmul_rn(__fsub_rn(x1f, x0f), __fsub_rn(y1f, y0f)) == 0.0f;
    const bool vis = visible[g] && !empty;
    const int x0 = __float2int_rz(x0f), y0 = __float2int_rz(y0f);
    const int w = __float2int_rz(x1f) - x0, h = __float2int_rz(y1f) - y0;
    rect[g] = make_int4(x0, y0, w, vis ? h : 0);
    member[g] = vis && w * h > m1;
    if (kSeen ? seen[g] : vis) {
      const float d = depth[g];
      if (isnan(d)) {
        nan = 1;
      } else {
        hi = ordered_bits(d);
        lo = ~hi;
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = max(lo, __shfl_xor_sync(kFull, lo, o));
    hi = max(hi, __shfl_xor_sync(kFull, hi, o));
    nan |= __shfl_xor_sync(kFull, nan, o);
  }
  __shared__ unsigned s_lo[kWarps], s_hi[kWarps];
  __shared__ int s_nan[kWarps];
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
    s_nan[warp] = nan;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kWarps; ++i) {
      lo = max(lo, s_lo[i]);
      hi = max(hi, s_hi[i]);
      nan |= s_nan[i];
    }
    if (lo) atomicMax(ws + kMinKey, lo);
    if (hi) atomicMax(ws + kMaxKey, hi);
    if (nan) atomicOr(ws + kNan, 1u);
  }
}

template <bool kCull>
__global__ void __launch_bounds__(kThreads) emit_kernel(
    const int4* __restrict__ rect, const int* __restrict__ member,
    const int* __restrict__ incl,  // [n] inclusive prefix sum of member
    const float* __restrict__ depth, const float* __restrict__ mean2d,
    const float* __restrict__ conic, const float* __restrict__ opacity,
    int n, int tiles_x, int num_tiles, int bits, int m1, int m2, int b2,
    int rows, int r, float tile_f, float tm1, int tier1_blocks,
    int* __restrict__ keys, int* __restrict__ tier2_ids,
    unsigned* __restrict__ ws) {
  const DepthField field = depth_field(ws, bits);
  const int total = incl[n - 1];  // tier-2 members
  if (static_cast<int>(blockIdx.x) < tier1_blocks) {
    const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
    if (k >= static_cast<int64_t>(n) * m1) return;
    const int g = static_cast<int>(k / m1), j = static_cast<int>(k % m1);
    const int4 rc = rect[g];
    const int cnt = rc.z * rc.w;
    const int mem = member[g];
    const int excl = incl[g] - mem;
    const bool overflowed = mem && excl >= b2;
    const int wsafe = max(rc.z, 1);
    const int tx = rc.x + j % wsafe, ty = rc.y + j / wsafe;
    bool valid = j < cnt && (!mem || overflowed);
    if (kCull && valid)
      valid = keep_tile(cull_terms(mean2d, conic, opacity, g), tx, ty, tile_f,
                        tm1);
    keys[k] = ((valid ? ty * tiles_x + tx : num_tiles) << bits) |
              quantize(depth[g], field);
    if (j == 0) {
      if (overflowed) add_spill(ws, kCap, static_cast<unsigned>(cnt - m1));
      // rows: the members in id order, then n + the others in id order
      const int row = mem ? excl : total + g - excl;
      if (row < rows) tier2_ids[row] = mem ? g : n + g;
    }
    return;
  }
  const int s = (static_cast<int>(blockIdx.x) - tier1_blocks) * kWarps +
                static_cast<int>(threadIdx.x / 32);
  const int lane = threadIdx.x & 31;
  if (s >= rows) return;
  int* row_keys = keys + static_cast<int64_t>(n) * m1 +
                  static_cast<int64_t>(s) * m2;
  if (s >= total) {  // an empty row: sentinels with Gaussian 0's depth
    const int key = (num_tiles << bits) | quantize(depth[0], field);
    for (int j = lane; j < m2; j += 32) row_keys[j] = key;
    return;
  }
  int lo = 0, hi = n - 1;  // the s-th member: the first g with incl > s
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (incl[mid] > s) hi = mid; else lo = mid + 1;
  }
  const int g = lo;
  const int4 rc = rect[g];
  const int cnt = rc.z * rc.w;
  const int wsafe = max(rc.z, 1);
  const int dq = quantize(depth[g], field);
  const int sentinel = (num_tiles << bits) | dq;
  int spill;
  if (!kCull) {
    for (int j = lane; j < m2; j += 32)
      row_keys[j] = j < cnt ? (((rc.y + j / wsafe) * tiles_x + rc.x +
                                j % wsafe) << bits) | dq
                            : sentinel;
    spill = max(cnt - m2, 0);
  } else {
    const Cull terms = cull_terms(mean2d, conic, opacity, g);
    const int lim = min(cnt, r);
    int kept = 0;
    for (int base = 0; base < lim; base += 32) {
      const int j = base + lane;
      const int tx = rc.x + j % wsafe, ty = rc.y + j / wsafe;
      const bool keep = j < lim && keep_tile(terms, tx, ty, tile_f, tm1);
      const unsigned ballot = __ballot_sync(kFull, keep);
      const int pos = kept + __popc(ballot & ((1u << lane) - 1u));
      if (keep && pos < m2) row_keys[pos] = ((ty * tiles_x + tx) << bits) | dq;
      kept += __popc(ballot);
    }
    for (int j = min(kept, m2) + lane; j < m2; j += 32) row_keys[j] = sentinel;
    spill = max(kept - m2, 0) + max(cnt - r, 0);
  }
  if (lane == 0 && spill > 0) add_spill(ws, kSlot, static_cast<unsigned>(spill));
}

__global__ void __launch_bounds__(kThreads) ranges_kernel(
    const int* __restrict__ keys, int e, int num_tiles, int bits,
    int max_per_tile, int max_pairs, const int64_t* __restrict__ perm,
    int npairs, int n, int m1, int m2, const int* __restrict__ tier2_ids,
    int* __restrict__ starts, int* __restrict__ counts,
    int* __restrict__ length, int* __restrict__ pair_ids,
    unsigned* __restrict__ ws) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  unsigned tile_spill = 0, stream_spill = 0;
  if (i < num_tiles) {
    // the lower bounds of i << bits and (i + 1) << bits, searched together
    const int v0 = i << bits, v1 = (i + 1) << bits;
    int lo0 = 0, hi0 = e, lo1 = 0, hi1 = e;
    while (lo0 < hi0 || lo1 < hi1) {
      if (lo0 < hi0) {
        const int mid = (lo0 + hi0) >> 1;
        if (keys[mid] < v0) lo0 = mid + 1; else hi0 = mid;
      }
      if (lo1 < hi1) {
        const int mid = (lo1 + hi1) >> 1;
        if (keys[mid] < v1) lo1 = mid + 1; else hi1 = mid;
      }
    }
    const int raw = lo1 - lo0;
    const int capped = min(raw, max_per_tile);
    const int cnt = min(capped, max(max_pairs - lo0, 0));
    starts[i] = lo0;
    counts[i] = cnt;
    tile_spill = static_cast<unsigned>(raw - capped);
    stream_spill = static_cast<unsigned>(capped - cnt);
    if (i == num_tiles - 1) *length = lo1;
  }
  if (i < npairs) {
    const int64_t slot = perm[i];
    const int64_t tier1 = static_cast<int64_t>(n) * m1;
    int id;
    if (slot < tier1) {
      id = static_cast<int>(slot / m1);
    } else {
      const int g = tier2_ids[(slot - tier1) / m2];
      id = g < n ? g : 0;
    }
    pair_ids[i] = id;
  }
  for (int o = 16; o > 0; o >>= 1) {
    tile_spill += __shfl_xor_sync(kFull, tile_spill, o);
    stream_spill += __shfl_xor_sync(kFull, stream_spill, o);
  }
  if ((threadIdx.x & 31) == 0) {
    if (tile_spill) add_spill(ws, kTile, tile_spill);
    if (stream_spill) add_spill(ws, kStream, stream_spill);
  }
}

int blocks(int64_t threads) {
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entries for ctypes. Each returns the CUDA error of its launch (0 =
// success); the caller raises on anything else. `seen` may be null (the
// reduction then runs over the rects' own vis).
extern "C" int binning_rects(const float* mean2d, const float* radius,
                             const bool* visible, const float* depth,
                             const bool* seen, int n, int tile_px,
                             int tiles_x, int tiles_y, int m1, int* rect,
                             int* member, int* ws, void* stream) {
  if (n <= 0) return 0;
  const float tile_f = static_cast<float>(tile_px);
  const float inv_tile = 1.0f / tile_f;  // PyTorch's `/ tile_px` on the card
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int4* r4 = reinterpret_cast<int4*>(rect);
  unsigned* w = reinterpret_cast<unsigned*>(ws);
  if (seen != nullptr)
    rects_kernel<true><<<blocks(n), kThreads, 0, st>>>(
        mean2d, radius, visible, depth, seen, n, inv_tile, tile_f, tiles_x,
        tiles_y, m1, r4, member, w);
  else
    rects_kernel<false><<<blocks(n), kThreads, 0, st>>>(
        mean2d, radius, visible, depth, seen, n, inv_tile, tile_f, tiles_x,
        tiles_y, m1, r4, member, w);
  return static_cast<int>(cudaGetLastError());
}

// `conic` and `opacity` both null: no cull.
extern "C" int binning_emit(const int* rect, const int* member,
                            const int* incl, const float* depth,
                            const float* mean2d, const float* conic,
                            const float* opacity, int n, int tiles_x,
                            int num_tiles, int bits, int m1, int m2, int b2,
                            int rows, int r, int tile_px, int* keys,
                            int* tier2_ids, int* ws, void* stream) {
  if (n <= 0) return 0;
  const float tile_f = static_cast<float>(tile_px);
  const float tm1 = static_cast<float>(static_cast<double>(tile_px) - 1.0);
  const int tier1 = blocks(static_cast<int64_t>(n) * m1);
  const int grid = tier1 + (rows + kWarps - 1) / kWarps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* r4 = reinterpret_cast<const int4*>(rect);
  unsigned* w = reinterpret_cast<unsigned*>(ws);
  if (conic != nullptr)
    emit_kernel<true><<<grid, kThreads, 0, st>>>(
        r4, member, incl, depth, mean2d, conic, opacity, n, tiles_x,
        num_tiles, bits, m1, m2, b2, rows, r, tile_f, tm1, tier1, keys,
        tier2_ids, w);
  else
    emit_kernel<false><<<grid, kThreads, 0, st>>>(
        r4, member, incl, depth, mean2d, conic, opacity, n, tiles_x,
        num_tiles, bits, m1, m2, b2, rows, r, tile_f, tm1, tier1, keys,
        tier2_ids, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int binning_ranges(const int* keys, int e, int num_tiles,
                              int bits, int max_per_tile, int max_pairs,
                              const int64_t* perm, int npairs, int n, int m1,
                              int m2, const int* tier2_ids, int* starts,
                              int* counts, int* length, int* pair_ids,
                              int* ws, void* stream) {
  const int threads = num_tiles > npairs ? num_tiles : npairs;
  if (threads <= 0) return 0;
  ranges_kernel<<<blocks(threads), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      keys, e, num_tiles, bits, max_per_tile, max_pairs, perm, npairs, n, m1,
      m2, tier2_ids, starts, counts, length, pair_ids,
      reinterpret_cast<unsigned*>(ws));
  return static_cast<int>(cudaGetLastError());
}
