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
// ~295 flop/byte ridge even for bf16 tensor cores.  This first version does
// the arithmetic on CUDA cores in float32 (simple and right first; mma.sync /
// wgmma with TMA staging is later work).
//
// Design.  One block per (64-query tile, head, batch row), 256 threads.
// The block walks the 64-key tiles that meet the tile's band
// [q0 - w, q0 + 63 + w] within [0, n), staging K and V in shared memory as
// float32; each thread holds a 4 x 4 patch of the 64 x 64 logits, masks it
// (|i - j| <= w, j < n), and keeps the exact running-max online softmax of its
// four rows in registers (max and sum over the 16 threads of a row by warp
// shuffles).  The probabilities go through shared memory into the 64 x D
// output accumulator, 4 rows x D/16 columns per thread.  Logits, the running
// max, the denominator and the output accumulate in float32; out is rounded
// once on its store.  The TPU kernel's padding of n to a multiple of w and
// its [BH, N, D] transposition are not needed: q, k, v are read in place as
// [B, N, H, D] and keys at or past n are masked.

#include "window_common.cuh"

namespace {

using band::Args;
using band::kLdP;
using band::kThreads;
using band::kTile;

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int batch,
           const Args& a, cudaStream_t stream) {
  static bool smem_set = false;
  const cudaError_t err =
      band::allow_smem(window_attention_fwd_kernel<T, D>, fwd_smem<D>(), smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.n + kTile - 1) / kTile, a.heads, batch);
  window_attention_fwd_kernel<T, D><<<grid, kThreads, fwd_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, a);
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
  if (dtype == 1) return dispatch<__nv_bfloat16>(d, q, k, v, out, l, batch, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
