// Banded sliding-window flash attention, forward (kernel K6).
//
// Replaces the TPU kernel anemoi_tpu/ops/pallas/window_attention.py:
// _flash_band_kernel (via _flash_window_forward).  For batch row b, head h
// and query position i of n, over the keys j with |i - j| <= w, 0 <= j < n:
//
//     s_ij  = q_i . k_j / sqrt(D)  [-> cap * tanh(s_ij / cap)]  [- slope_h |i - j|]
//     out_i = sum_j softmax_j(s_ij) v_j           lse_i = log sum_j exp(s_ij)
//
// What bounds it: operations.  Per (batch row, head) the band holds about
// n (2w + 1) pairs, each costing 4D flops (q.k and p.v); at the Transformer
// preset (n = 10 242, w = 512, D = 64, 16 heads) that is 41.9 GFLOP against
// 85 MB of q, k, v, out and lse -- ~500 flop per byte, above the H100's
// ~295 flop/byte ridge even for bf16 tensor cores.
//
// Which instantiation each type takes (the choice depends on the type only):
//   bfloat16 (D 16, 32, 64, 128): window_attention_fwd_wgmma_kernel<D>, both
//     products on the warpgroup tensor cores (wgmma.mma_async m64nNk16, bf16
//     in, float32 accumulate; window_wgmma.cuh);
//   float32: window_attention_fwd_kernel<float, D>, float32 FMAs on CUDA
//     cores (TF32 tensor cores keep ~10 bits, too few for the float32 gate
//     of 1e-4).
//
// Both: one block per (64-query tile, head, batch row), walking the 64-key
// tiles that meet the tile's band [q0 - w, q0 + 63 + w] within [0, n)
// (band::band_tiles, 17 at w = 512), with the exact running-max online
// softmax per row in float32; logits, the running max, the denominator and
// the output accumulate in float32, and out is rounded once on its store.
// The TPU kernel's padding of n to a multiple of w and its [BH, N, D]
// transposition are not needed: q, k, v are read in place as [B, N, H, D]
// and keys at or past n are masked.  Each block alone writes its rows, so
// the result is bitwise repeatable.
//
// float32 design.  256 threads; K and V staged in shared memory as float32;
// each thread holds a 4 x 4 patch of the 64 x 64 logits, masks it
// (|i - j| <= w, j < n), and keeps the online softmax of its four rows in
// registers (max and sum over the 16 threads of a row by warp shuffles).
// The probabilities go through shared memory into the 64 x D output
// accumulator, 4 rows x D/16 columns per thread.
//
// bf16 design.  One warpgroup (128 threads, 4 warps) a block; warp w owns
// query rows 16w .. 16w + 15.  The Q tile is staged once, K and V through a
// two-stage cp.async ring (16-byte copies, hardware zero-fill past n), all in
// wgmma's swizzled layouts (D = 128 as two 64-column slabs).  Per key tile,
// one barrier: the tile's copies have landed for every thread, whose next
// copies then refill the other stage while this tile is computed.  Then:
//   1. S = Q K^T: D / 16 wgmma m64n64k16, Q and K K-major from shared
//      memory; commit, wait.
//   2. In registers: scale, softcap, ALiBi, the band and n masks (P = 0
//      exactly outside; a row with no key yet uses m = 0), the running max
//      (over the row's 4 lanes by shuffles) and P = exp(s - m) by the SFU
//      (ex2.approx).  A tile with every pair in the band and no softcap or
//      ALiBi skips the masks and folds the scale into the exponent.  The
//      denominator l sums the float32 P; O is rescaled by the correction.
//   3. O += P V: 4 wgmma m64nDk16, A = P from registers (the accumulators
//      of two neighbouring n8-tiles packed to bf16 are one k16 step's A
//      fragment), B = V N-major from shared memory (the transpose flag).
//      P is rounded to bf16 once, for this product only, as the JAX kernel
//      does (p.astype(v.dtype)).
// Then out = O / l as bf16 pairs and lse = m + log l.

#include <type_traits>

#include "window_common.cuh"
#include "window_wgmma.cuh"

namespace {

using band::Args;
using band::kLdP;
using band::kThreads;
using band::kTile;
using tc::bf16;

template <int D>
constexpr size_t fwd_smem() {
  return (3 * kTile * (D + 1) + kTile * kLdP) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    window_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, T* __restrict__ out,
                                float* __restrict__ lse, Args a) {
  constexpr int LD = D + 1, ND = D / 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kTile * LD;
  float* sv = sk + kTile * LD;
  float* sp = sv + kTile * LD;  // [64][65] probabilities
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;

  band::load_tile<T, D>(sq, band::row0<T, D>(q, b, h, a), q0, a);
  const T* kb = band::row0<T, D>(k, b, h, a);
  const T* vb = band::row0<T, D>(v, b, h, a);

  float m[4], l[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[i][c] = 0.f;
  }

  int first, last;
  band::band_tiles(q0, a, first, last);
  for (int k0 = first; k0 < last; k0 += kTile) {
    __syncthreads();  // the previous tile's reads of sk, sv, sp are done (and sq is loaded)
    band::load_tile<T, D>(sk, kb, k0, a);
    band::load_tile<T, D>(sv, vb, k0, a);
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sq[(ty * 4 + i) * LD + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sk[(tx + 16 * j) * LD + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qpos = q0 + r;
      float rmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float t;
        const float x = band::logit(s[i][j], qpos, kpos, slope, a, t);
        s[i][j] = band::in_band(qpos, kpos, a) ? x : -CUDART_INF_F;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], band::row_max(rmax));
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;  // no row key seen yet
      const float corr = expf(m[i] - m_use);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_use);
        sp[r * kLdP + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * corr + band::row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < ND; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float vv[ND];
#pragma unroll
      for (int c = 0; c < ND; ++c) vv[c] = sv[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sp[(ty * 4 + i) * kLdP + kk];
#pragma unroll
        for (int c = 0; c < ND; ++c) acc[i][c] += p * vv[c];
      }
    }
  }

  const size_t stride = static_cast<size_t>(a.heads) * D;
  T* ob = out + (static_cast<size_t>(b) * a.n * a.heads + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= a.n) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) ob[qpos * stride + tx + 16 * c] = band::from_float<T>(acc[i][c] * inv);
    if (tx == 0)
      lse[(static_cast<size_t>(b) * a.heads + h) * a.n + qpos] =
          l[i] > 0.f ? m[i] + logf(l[i]) : -CUDART_INF_F;
  }
}

// ---- bf16 on the warpgroup tensor cores ----

constexpr int kWgThreads = 128;  // one warpgroup; warp w owns query rows 16w .. 16w + 15

// The blocks an SM for which __launch_bounds__ caps the registers.  At
// D <= 64, 5 (96 registers at D = 64) timed faster on the H100 than 3 or 4
// (107 registers), the other launch bounds built as development variants
// (PERF.md §6); D = 128: 2, which its shared memory allows.
__host__ __device__ constexpr int wg_blocks_per_sm(int d) { return d <= 64 ? 5 : 2; }

// A bf16 [64][D] tile as D / kCols slabs [64][kCols] in wgmma's swizzled
// layouts (window_wgmma.cuh), each starting on a 1024-byte boundary.
template <int D>
struct WgTile {
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kSlabs = D / kCols;
  static constexpr int kElems = kTile * D;
  static constexpr uint32_t kSlabBytes = kTile * kCols * sizeof(bf16);
};
// The Q tile, then a two-stage ring of K and V; 1024 bytes of slack for
// the alignment.
template <int D>
constexpr size_t wg_smem() {
  return 5 * WgTile<D>::kElems * sizeof(bf16) + 1024;
}

// Stage rows [pos0, pos0 + 64) of one (batch row, head) into a tile; rows
// at or past n are zero-filled.  Every thread of the block calls it.  A
// thread copies chunk c of rows r0 + kRowStep i of every slab: their
// swizzled offsets differ by whole rows only.
template <int D>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, int pos0, int n,
                                           int stride) {
  using L = WgTile<D>;
  constexpr int kChunks = L::kCols / 8, kRowStep = kWgThreads / kChunks;
  const int r0 = threadIdx.x / kChunks, c = threadIdx.x % kChunks;
  const int to = tc::Swizzle<L::kCols>::at(r0, c);
#pragma unroll
  for (int sl = 0; sl < L::kSlabs; ++sl)
#pragma unroll
    for (int i = 0; i < kTile / kRowStep; ++i) {
      const int pos = pos0 + r0 + i * kRowStep;
      tc::cp_async16(dst + sl * kTile * L::kCols + to + i * kRowStep * L::kCols,
                     src + sl * L::kCols + (pos < n ? pos : n - 1) * stride + c * 8, pos < n);
    }
}

// Descriptors of k-step kk: columns 16kk .. of a tile as a K-major operand
// (Q, K), rows 16kk .. of a tile as the N-major B operand (V).
template <int D>
__device__ __forceinline__ uint64_t k_major(const bf16* tile, int kk) {
  using L = WgTile<D>;
  return wg::smem_desc<L::kCols>(
      tile + (16 * kk / L::kCols) * kTile * L::kCols + (16 * kk) % L::kCols, 16);
}
template <int D>
__device__ __forceinline__ uint64_t n_major(const bf16* tile, int kk) {
  using L = WgTile<D>;
  return wg::smem_desc<L::kCols>(tile + 16 * kk * L::kCols, L::kSlabBytes);
}

using gt::exp2_approx;

// Max / sum over the 4 lanes (lane & 3) that hold one row of a fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, wg_blocks_per_sm(D))
    window_attention_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                      const bf16* __restrict__ v, bf16* __restrict__ out,
                                      float* __restrict__ lse, Args a) {
  constexpr int kT = WgTile<D>::kElems;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw + (-tc::smem_addr(smem_raw) & 1023u));
  bf16* sk = sq + kT;      // [2 stages][tile]
  bf16* sv = sk + 2 * kT;  // [2 stages][tile]
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
  const int stride = a.heads * D;  // n * H * D < 2^31 (the wrapper checks)
  const bf16* kb = band::row0<bf16, D>(k, b, h, a);
  const bf16* vb = band::row0<bf16, D>(v, b, h, a);
  int first, last;
  band::band_tiles(q0, a, first, last);

  stage_tile<D>(sq, band::row0<bf16, D>(q, b, h, a), q0, a.n, stride);
  stage_tile<D>(sk, kb, first, a.n, stride);
  stage_tile<D>(sv, vb, first, a.n, stride);
  tc::cp_async_commit();

  // The thread's rows: qrow (i = 0) and qrow + 8 (i = 1).  l[i] sums the
  // thread's own columns; the row's 4 lanes are totalled at the end.
  const int qrow = q0 + m0 + (lane >> 2);
  const bool plain = a.softcap == 0.f && a.slopes == nullptr;  // logits need only the scale
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  int stage = 0;
  for (int k0 = first; k0 < last; k0 += kTile, stage ^= 1) {
    // This tile's copies (the only ones in flight) have landed, for every
    // thread, and every thread is done with the other stage: refill it with
    // the next tile, which lands while this one is computed.
    tc::cp_async_wait<0>();
    wg::fence_smem();
    __syncthreads();
    if (k0 + kTile < last) {
      stage_tile<D>(sk + (stage ^ 1) * kT, kb, k0 + kTile, a.n, stride);
      stage_tile<D>(sv + (stage ^ 1) * kT, vb, k0 + kTile, a.n, stride);
      tc::cp_async_commit();
    }
    const bf16* tk = sk + stage * kT;
    const bf16* tv = sv + stage * kT;

    float s[kTile / 8][4];  // S = Q K^T (the first k-step overwrites)
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::mma_ss_n64(s, k_major<D>(sq, kk), k_major<D>(tk, kk), kk);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(s);

    // Every pair of the tile in the band and below n, no softcap or ALiBi:
    // no masks, the scale folded into the exponent (15 of the 17 tiles at
    // the Transformer preset; without this branch the kernel took 1.4x as
    // long there on the H100, PERF.md §6).  Otherwise s becomes the logit,
    // -inf outside the band and past n.
    const bool inside = plain && q0 + kTile <= a.n && k0 + kTile <= a.n &&
                        q0 + kTile - 1 - k0 <= a.w && k0 + kTile - 1 - q0 <= a.w;
    float mult, rmax[2] = {-CUDART_INF_F, -CUDART_INF_F};
    if (inside) {
      mult = a.scale * kLog2e;
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) rmax[e >> 1] = fmaxf(rmax[e >> 1], s[nt][e]);
      rmax[0] *= a.scale;  // the largest logit: the scale is positive
      rmax[1] *= a.scale;
    } else {
      mult = kLog2e;
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = qrow + ((e >> 1) << 3), kpos = k0 + tc::slab_col(lane, nt, e);
          float t;
          const float x = band::logit(s[nt][e], qpos, kpos, slope, a, t);
          s[nt][e] = band::in_band(qpos, kpos, a) ? x : -CUDART_INF_F;
          rmax[e >> 1] = fmaxf(rmax[e >> 1], s[nt][e]);
        }
    }
    float corr[2], m_log2[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(rmax[i]));
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;  // no key of the row seen yet
      corr[i] = exp2_approx((m[i] - m_use) * kLog2e);
      m_log2[i] = m_use * kLog2e;
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2_approx(fmaf(s[nt][e], mult, -m_log2[e >> 1]));  // P, 0 where masked
        psum[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + psum[i];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] *= corr[e >> 1];

    uint32_t pa[kTile / 16][4];  // P rounded to bf16 once, for P V
    tc::pack_slab<kTile>(pa, s);
    wg::fence_regs(o);
    wg::fence_regs(pa);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) wg::mma_rs_t<D>(o, pa[kk], n_major<D>(tv, kk));
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(o);
  }

  const size_t stat = (static_cast<size_t>(b) * a.heads + h) * a.n;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float total = quad_sum(l[i]);
    const int qpos = qrow + 8 * i;
    inv[i] = total > 0.f ? 1.f / total : 0.f;
    if ((lane & 3) == 0 && qpos < a.n)
      lse[stat + qpos] = total > 0.f ? m[i] + logf(total) : -CUDART_INF_F;
  }
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] *= inv[e >> 1];
  tc::store_rows<D>(out + (static_cast<size_t>(b) * a.n * a.heads + h) * D, o, 1.f, q0, m0, lane,
                    a.n, stride);
}

// bfloat16 takes the warpgroup tensor-core kernel, float32 the CUDA-core one.
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int batch,
           const Args& a, cudaStream_t stream) {
  static bool smem_set = false;
  const dim3 grid((a.n + kTile - 1) / kTile, a.heads, batch);
  if constexpr (std::is_same<T, bf16>::value) {
    const cudaError_t err =
        band::allow_smem(window_attention_fwd_wgmma_kernel<D>, wg_smem<D>(), smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    window_attention_fwd_wgmma_kernel<D><<<grid, kWgThreads, wg_smem<D>(), stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), lse, a);
  } else {
    const cudaError_t err =
        band::allow_smem(window_attention_fwd_kernel<T, D>, fwd_smem<D>(), smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    window_attention_fwd_kernel<T, D><<<grid, kThreads, fwd_smem<D>(), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), lse, a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* out, float* lse, int batch,
             const Args& a, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, lse, batch, a, stream);
    case 32: return launch<T, 32>(q, k, v, out, lse, batch, a, stream);
    case 64: return launch<T, 64>(q, k, v, out, lse, batch, a, stream);
    case 128: return launch<T, 128>(q, k, v, out, lse, batch, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 = float32, 1 = bfloat16;
// d: 16, 32, 64 or 128; softcap 0 = none; slopes: float32 [H] or null.
// Shapes and types are validated by the Python wrapper.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int window_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                    void* out, void* lse, const void* slopes, int batch, int n,
                                    int heads, int d, int w, float scale, float softcap,
                                    void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const Args a{n, heads, w, scale, softcap, static_cast<const float*>(slopes)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) return dispatch<float>(d, q, k, v, out, l, batch, a, st);
  if (dtype == 1) return dispatch<bf16>(d, q, k, v, out, l, batch, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
