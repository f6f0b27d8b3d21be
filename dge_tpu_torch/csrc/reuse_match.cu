// The pivot reuse's epipolar-masked cosine argmax for NVIDIA Hopper
// (sm_90a): for every query token of every (frame, key) pair, the index of
// the pivot token of highest similarity, a pivot token off the query's
// epipolar band counting as similarity 0, and the unmasked argmax where
// every pivot token is off the band. One kernel, nothing of size
// [F, K, S, ...] written.
//
// Replaces no Pallas kernel. It replaces, on the card, the jnp einsum and
// argmax of dge_tpu/models/layers.py:246-313 (`epi_blockwise_argmax`, bf16
// operands with preferred_element_type=float32), which XLA fused there and
// which the port carried over as a blockwise PyTorch loop
// (`_epi_argmax_torch` in dge_tpu_torch/models/layers.py, still the CPU
// twin). On the card that loop cast both operands to f32, ran the
// similarity as an f32 SIMT GEMM and built seven f32 arrays of
// [F, K, S, 512] a key block for the distances, the mask and the two
// argmaxes. Python side: `_epi_argmax_kernel` in the same module, which
// builds this file with nvcc at first use (ops/cuda_build.py) and loads it
// with ctypes. Upstream's counterpart is the cosine-similarity gather of
// make_dge_block (DGE's dge_utils.py:407-571).
//
// Semantics. sim[q, t] = sum_d img[f, q, d] * piv[f, k, t, d], bf16
// products accumulated in f32 on the tensor cores (wgmma), the reference's
// own precision: only the summation order differs from any other f32
// accumulation. A pair violates where |l0*p0 + l1*p1 + l2*p2| > threshold
// (the query row's line l, the key's homogeneous pixel p), in f32. Each
// thread keeps two running (value, index) pairs a query row: the masked
// similarity (a violating key counts 0.0, not -inf) and the raw one, and a
// flag that every key so far violated. A thread visits its keys in
// increasing index and replaces on a strictly greater value; the four
// threads that share a row merge by (greater value, or equal value and
// smaller index). So an exact tie goes to the first index, as the blockwise
// loop gives it. The answer is the raw argmax where the row's flag holds,
// else the masked one.
//
// Bound. 2*S*S*D operations a (frame, key) pair: at 20 frames, 2 keys,
// 4,096 tokens of 320 channels 429 GFLOP, 0.434 ms at 989 TFLOP/s; the
// bytes (tokens read once, indices written) are ~1/500 of that. Design: a
// block takes BM query rows of one (frame, key) pair, a warpgroup each 64
// of them (BM 128, or 64 where 128-row tiles would not give two blocks a
// streaming multiprocessor), and walks every key tile of 128 tokens, the
// channels in stages of 64 (128 bytes a token), double-buffered through
// cp.async in shared memory laid out as wgmma's 128-byte swizzle (16-byte
// chunk c of row r at chunk c ^ (r % 8), 1,024-byte aligned atoms), so
// neither the copies nor the tensor cores' reads conflict on banks. The
// channel loop and the key loop are one stream of stages: the copies of the
// next key tile overlap the last stage and the epilogue of this one. Each
// warpgroup's 64 x 128 similarity tile accumulates in registers through
// m64n128k16 wgmmas that read both operands from shared memory; the
// epilogue evaluates the band test from the query lines in registers and
// the key tile's pixels, staged with the tile's last stage, and updates the
// running pairs. The query tile is read again from L2 for every key tile.
// Two stages, not three or more: a block of 256 threads needs ~126
// registers, so two blocks fill a streaming multiprocessor whatever the
// stages, and the 64-row tiles of short token counts fit four blocks with
// two stages (an H100, 576 tokens of 1,280 channels: 0.173 ms against
// 0.259 with three; deeper rings at one block a multiprocessor were slower
// at every shape).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBN = 128;            // key tokens a tile: wgmma's N
constexpr int kBK = 64;             // channels a stage
constexpr int kRowBytes = kBK * 2;  // one token's stage, bf16: 8 chunks

template <int BM>
struct Tiles {
  static constexpr int kThreads = BM / 64 * 128;  // a warpgroup a 64 rows
  static constexpr int kStages = 2;
  static constexpr int kABytes = BM * kRowBytes;
  static constexpr int kBBytes = kBN * kRowBytes;
  static constexpr int kPtsBytes = kBN * 16;  // (x, y, z, unused) a key
  static constexpr int kStageBytes = kABytes + kBBytes + kPtsBytes;
  static_assert(kStageBytes % 1024 == 0, "swizzle atoms stay aligned");
  // the ring, and room to align its start to 1,024 bytes
  static constexpr int kSmem = kStages * kStageBytes + 1024;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled where !valid (nothing read)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// what this thread's copies wrote, visible to the tensor cores' reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A K-major operand tile in shared memory for wgmma: rows of 128 bytes in
// the 128-byte swizzle, eight-row atoms 1,024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(1) << 16) |          // leading offset: unused
         (static_cast<uint64_t>(1024 >> 4) << 32) |  // stride: one atom
         (static_cast<uint64_t>(1) << 62);           // 128-byte swizzle
}

// d (64 x 128, f32, this warpgroup's) = a (64 x 16) * b (16 x 128) + (d
// where scale_d), both operands bf16 in shared memory
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t desc_a,
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// keep the compiler from moving accumulator reads and writes across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The byte offset of 16-byte chunk `chunk` of row `row` in a stage tile.
__device__ __forceinline__ unsigned swizzled(int row, int chunk) {
  return row * kRowBytes + ((chunk ^ (row & 7)) << 4);
}

// (v, i) takes (ov, oi) where that is greater, or equal at a smaller index.
__device__ __forceinline__ void take(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <int BM>
__global__ void __launch_bounds__(Tiles<BM>::kThreads, 2)
    reuse_match_kernel(const uint16_t* __restrict__ img,
                       const uint16_t* __restrict__ piv,
                       const float* __restrict__ lines,
                       const float* __restrict__ pts, int n_key, int s, int d,
                       float threshold, long long* __restrict__ out) {
  using T = Tiles<BM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int fk = blockIdx.y;  // the (frame, key) pair
  const int q0 = blockIdx.x * BM;
  const uint16_t* const a_src =
      img + static_cast<size_t>(fk / n_key) * s * d;
  const uint16_t* const b_src = piv + static_cast<size_t>(fk) * s * d;
  const int n_chunks = (d + kBK - 1) / kBK;
  const int total = n_chunks * ((s + kBN - 1) / kBN);
  const unsigned raw0 = smem_addr(smem_raw);
  const unsigned smem0 = (raw0 + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (smem0 - raw0);

  // stage `it` of the stream (key tile it / n_chunks, channel stage
  // it % n_chunks) into ring slot `slot`; a key tile's pixels ride with its
  // last channel stage
  auto load = [&](int it, int slot) {
    const int tile = it / n_chunks, chunk = it - tile * n_chunks;
    const unsigned a_dst = smem0 + slot * T::kStageBytes;
    const unsigned b_dst = a_dst + T::kABytes;
    const int d0 = chunk * kBK, n0 = tile * kBN;
#pragma unroll
    for (int i = tid; i < BM * 8; i += T::kThreads) {
      const int r = i >> 3, c = i & 7, q = q0 + r, dd = d0 + c * 8;
      const bool ok = q < s && dd < d;
      cp_async16(a_dst + swizzled(r, c),
                 ok ? a_src + static_cast<size_t>(q) * d + dd : a_src, ok);
    }
#pragma unroll
    for (int i = tid; i < kBN * 8; i += T::kThreads) {
      const int r = i >> 3, c = i & 7, t = n0 + r, dd = d0 + c * 8;
      const bool ok = t < s && dd < d;
      cp_async16(b_dst + swizzled(r, c),
                 ok ? b_src + static_cast<size_t>(t) * d + dd : b_src, ok);
    }
    if (chunk == n_chunks - 1) {
      const unsigned p_dst = b_dst + T::kBBytes;
      for (int i = tid; i < kBN * 3; i += T::kThreads) {
        const int key = i / 3, c = i - key * 3, t = n0 + key;
        const bool ok = t < s;
        cp_async4(p_dst + key * 16 + c * 4, ok ? pts + t * 3 + c : pts, ok);
      }
    }
  };

  // this thread's two query rows (h = 0, 1) of its warpgroup's 64
  const int wg_row = (warp >> 2) * 64;
  float ln[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q0 + wg_row + (warp & 3) * 16 + h * 8 + (lane >> 2);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      ln[h][c] = q < s ? lines[(static_cast<size_t>(fk) * s + q) * 3 + c]
                       : 0.0f;
  }
  float best_m[2], best_r[2];
  int idx_m[2], idx_r[2];
  unsigned all_bad = 0x3u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    best_m[h] = best_r[h] = -INFINITY;
    idx_m[h] = idx_r[h] = 0;
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int st = 0; st < T::kStages - 1; ++st) {
    if (st < total) load(st, st);
    cp_async_commit();
  }
  int chunk = 0, n0 = 0;
  for (int it = 0; it < total; ++it) {
    cp_async_wait<T::kStages - 2>();
    fence_proxy_async();
    __syncthreads();  // stage `it` landed; slot (it - 1) % kStages is free
    if (it + T::kStages - 1 < total)
      load(it + T::kStages - 1, (it + T::kStages - 1) % T::kStages);
    cp_async_commit();
    const int slot = it % T::kStages;
    const unsigned a_st =
        smem0 + slot * T::kStageBytes + wg_row * kRowBytes;
    const unsigned b_st = smem0 + slot * T::kStageBytes + T::kABytes;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_bf16(acc, smem_desc(a_st + kk * 32), smem_desc(b_st + kk * 32),
                 (chunk > 0 || kk > 0) ? 1 : 0);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    if (++chunk < n_chunks) continue;
    // the key tile's similarities are whole: the band test and the two
    // running argmaxes, keys in increasing index within the thread
    const float4* const p_s = reinterpret_cast<const float4*>(
        smem + slot * T::kStageBytes + T::kABytes + T::kBBytes);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int lc = j * 8 + 2 * (lane & 3) + e;
        const int col = n0 + lc;
        if (col >= s) continue;
        const float4 p = p_s[lc];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float sim = acc[j * 4 + h * 2 + e];
          const float dist = fabsf(
              fmaf(ln[h][2], p.z, fmaf(ln[h][1], p.y, ln[h][0] * p.x)));
          const bool viol = dist > threshold;
          const float m = viol ? 0.0f : sim;
          if (m > best_m[h]) {
            best_m[h] = m;
            idx_m[h] = col;
          }
          if (sim > best_r[h]) {
            best_r[h] = sim;
            idx_r[h] = col;
          }
          if (!viol) all_bad &= ~(1u << h);
        }
      }
    }
    chunk = 0;
    n0 += kBN;
  }
  cp_async_wait<0>();

  // merge the four lanes of a quad: together they hold a row's keys
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned b = (all_bad >> h) & 1u;
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      take(best_m[h], idx_m[h], __shfl_xor_sync(0xffffffffu, best_m[h], off),
           __shfl_xor_sync(0xffffffffu, idx_m[h], off));
      take(best_r[h], idx_r[h], __shfl_xor_sync(0xffffffffu, best_r[h], off),
           __shfl_xor_sync(0xffffffffu, idx_r[h], off));
      b &= __shfl_xor_sync(0xffffffffu, b, off);
    }
    const int q = q0 + wg_row + (warp & 3) * 16 + h * 8 + (lane >> 2);
    if ((lane & 3) == 0 && q < s)
      out[static_cast<size_t>(fk) * s + q] = b ? idx_r[h] : idx_m[h];
  }
}

template <int BM>
int launch_tiles(const void* img, const void* piv, const float* lines,
                 const float* pts, int f, int k, int s, int d,
                 float threshold, long long* out, cudaStream_t st) {
  using T = Tiles<BM>;
  cudaError_t err = cudaFuncSetAttribute(
      reuse_match_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + BM - 1) / BM, f * k);
  reuse_match_kernel<BM><<<grid, T::kThreads, T::kSmem, st>>>(
      static_cast<const uint16_t*>(img), static_cast<const uint16_t*>(piv),
      lines, pts, k, s, d, threshold, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img [f, s, d] and piv [f, k, s, d] bf16, lines [f, k, s, 3] and pts
// [s, 3] f32, out [f, k, s] int64; d a multiple of 16. The query tile is
// 128 rows where that gives at least two blocks a streaming multiprocessor,
// else 64.
extern "C" int reuse_match(const void* img, const void* piv,
                           const float* lines, const float* pts, int f, int k,
                           int s, int d, float threshold, long long* out,
                           void* stream) {
  if (f <= 0 || k <= 0 || s <= 0) return 0;
  if (d <= 0 || d % 16 != 0 || static_cast<long long>(f) * k > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks128 = static_cast<long long>(f) * k * ((s + 127) / 128);
  if (blocks128 >= 2LL * sms)
    return launch_tiles<128>(img, piv, lines, pts, f, k, s, d, threshold,
                             out, st);
  return launch_tiles<64>(img, piv, lines, pts, f, k, s, d, threshold, out,
                          st);
}
