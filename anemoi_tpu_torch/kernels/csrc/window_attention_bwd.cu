// Banded sliding-window flash attention, backward (kernel K7: two kernels).
//
// Replaces the TPU kernels of anemoi_tpu/ops/pallas/window_attention.py:
//   _flash_bwd_dq_kernel  -> window_attention_bwd_dq_kernel  (one block per query tile)
//   _flash_bwd_dkv_kernel -> window_attention_bwd_dkv_kernel (one block per key tile)
// (via _flash_window_backward).  With the forward's lse, g = dL/d out and
// delta_i = sum_c g_ic out_ic (float32 [B, H, N], formed by the caller), for
// each pair (i, j) of the band:
//
//     p_ij  = exp(s_ij - lse_i)                 (s_ij the forward's logit)
//     dp_ij = g_i . v_j
//     ds_ij = p_ij (dp_ij - delta_i) [* (1 - tanh^2(x_ij / cap))]   x_ij = q_i . k_j / sqrt(D)
//     dq_i += ds_ij k_j / sqrt(D)     dk_j += ds_ij q_i / sqrt(D)     dv_j += p_ij g_i
//
// Softcap is differentiated here (the factor 1 - tanh^2); the JAX package
// differentiates its XLA reference for that case instead.  ALiBi slopes are
// constants and get no gradient.
//
// What bounds them: operations.  dq costs 6D flops per pair (q.k, g.v, ds.k),
// dk/dv 8D (q.k, g.v, p.g, ds.q): 62.9 and 83.8 GFLOP at the Transformer
// preset against ~100 MB each.  Arithmetic on CUDA cores in float32, as in
// K6 (window_attention_fwd.cu); tensor cores are later work.
//
// Design.  Both kernels recompute P from lse, tile by tile, with the thread
// layout of K6 (window_common.cuh).  The dq kernel owns a 64-query tile and
// walks the key tiles of its band; the dk/dv kernel owns a 64-key tile and
// walks the query tiles of its band from the other side (the band is
// symmetric).  Each block alone writes its rows: no atomics, deterministic.
// Accumulators are float32; each output is rounded once on its store.

#include "window_common.cuh"

namespace {

using band::Args;
using band::kLdP;
using band::kThreads;
using band::kTile;

template <int D>
constexpr size_t dq_smem() {
  return (4 * kTile * (D + 1) + kTile * kLdP) * sizeof(float);
}

template <int D>
constexpr size_t dkv_smem() {
  return (4 * kTile * (D + 1) + 2 * kTile * kLdP + 2 * kTile) * sizeof(float);
}

// Raw products of a thread's 4 x 4 patch: s = A_r . B_c and dp = C_r . E_c,
// rows r = ty*4 + i of the [64][D+1] tiles A and C, columns c = tx + 16j of
// B and E.
template <int D>
__device__ __forceinline__ void two_products(const float* A, const float* B, const float* C,
                                             const float* E, int ty, int tx, float (&s)[4][4],
                                             float (&dp)[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < D; ++dd) {
    float a[4], c[4], bb[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(ty * 4 + i) * LD + dd];
      c[i] = C[(ty * 4 + i) * LD + dd];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bb[j] = B[(tx + 16 * j) * LD + dd];
      e[j] = E[(tx + 16 * j) * LD + dd];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += a[i] * bb[j];
        dp[i][j] += c[i] * e[j];
      }
  }
}

// dq for one 64-query tile.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    window_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, const T* __restrict__ g,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta, T* __restrict__ dq, Args a) {
  constexpr int LD = D + 1, ND = D / 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sg = sq + kTile * LD;
  float* sk = sg + kTile * LD;
  float* sv = sk + kTile * LD;
  float* sds = sv + kTile * LD;  // [64][65]
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
  const size_t stat = (static_cast<size_t>(b) * a.heads + h) * a.n;

  band::load_tile<T, D>(sq, band::row0<T, D>(q, b, h, a), q0, a);
  band::load_tile<T, D>(sg, band::row0<T, D>(g, b, h, a), q0, a);
  const T* kb = band::row0<T, D>(k, b, h, a);
  const T* vb = band::row0<T, D>(v, b, h, a);
  float row_lse[4], row_delta[4], acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    row_lse[i] = qpos < a.n ? lse[stat + qpos] : 0.f;
    row_delta[i] = qpos < a.n ? delta[stat + qpos] : 0.f;
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[i][c] = 0.f;
  }

  int first, last;
  band::band_tiles(q0, a, first, last);
  for (int k0 = first; k0 < last; k0 += kTile) {
    __syncthreads();
    band::load_tile<T, D>(sk, kb, k0, a);
    band::load_tile<T, D>(sv, vb, k0, a);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_products<D>(sq, sk, sg, sv, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float t;
        const float x = band::logit(s[i][j], qpos, kpos, slope, a, t);
        const float p = band::in_band(qpos, kpos, a) ? expf(x - row_lse[i]) : 0.f;
        sds[r * kLdP + tx + 16 * j] = p * (dp[i][j] - row_delta[i]) * (1.f - t * t);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float kv[ND];
#pragma unroll
      for (int c = 0; c < ND; ++c) kv[c] = sk[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = sds[(ty * 4 + i) * kLdP + kk];
#pragma unroll
        for (int c = 0; c < ND; ++c) acc[i][c] += ds * kv[c];
      }
    }
  }

  const size_t stride = static_cast<size_t>(a.heads) * D;
  T* out = dq + (static_cast<size_t>(b) * a.n * a.heads + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= a.n) continue;
#pragma unroll
    for (int c = 0; c < ND; ++c)
      out[qpos * stride + tx + 16 * c] = band::from_float<T>(acc[i][c] * a.scale);
  }
}

// dk and dv for one 64-key tile.  Thread rows are keys, columns queries.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    window_attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                    const T* __restrict__ v, const T* __restrict__ g,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta, T* __restrict__ dk,
                                    T* __restrict__ dv, Args a) {
  constexpr int LD = D + 1, ND = D / 16;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kTile * LD;
  float* sq = sv + kTile * LD;
  float* sg = sq + kTile * LD;
  float* sp = sg + kTile * LD;   // [64 keys][65] probabilities
  float* sds = sp + kTile * kLdP;  // [64 keys][65] logit gradients
  float* slse = sds + kTile * kLdP;  // [64] of the query tile
  float* sdelta = slse + kTile;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
  const size_t stat = (static_cast<size_t>(b) * a.heads + h) * a.n;

  band::load_tile<T, D>(sk, band::row0<T, D>(k, b, h, a), k0, a);
  band::load_tile<T, D>(sv, band::row0<T, D>(v, b, h, a), k0, a);
  const T* qb = band::row0<T, D>(q, b, h, a);
  const T* gb = band::row0<T, D>(g, b, h, a);
  float acc_k[4][ND], acc_v[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < ND; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  int first, last;
  band::band_tiles(k0, a, first, last);
  for (int q0 = first; q0 < last; q0 += kTile) {
    __syncthreads();
    band::load_tile<T, D>(sq, qb, q0, a);
    band::load_tile<T, D>(sg, gb, q0, a);
    if (threadIdx.x < kTile) {
      const int qpos = q0 + threadIdx.x;
      slse[threadIdx.x] = qpos < a.n ? lse[stat + qpos] : 0.f;
      sdelta[threadIdx.x] = qpos < a.n ? delta[stat + qpos] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    two_products<D>(sk, sq, sv, sg, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, kpos = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cq = tx + 16 * j, qpos = q0 + cq;
        float t;
        const float x = band::logit(s[i][j], qpos, kpos, slope, a, t);
        const float p = band::in_band(qpos, kpos, a) ? expf(x - slse[cq]) : 0.f;
        sp[r * kLdP + cq] = p;
        sds[r * kLdP + cq] = p * (dp[i][j] - sdelta[cq]) * (1.f - t * t);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float gv[ND], qv[ND];
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        gv[c] = sg[qq * LD + tx + 16 * c];
        qv[c] = sq[qq * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sp[(ty * 4 + i) * kLdP + qq];
        const float ds = sds[(ty * 4 + i) * kLdP + qq];
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          acc_v[i][c] += p * gv[c];
          acc_k[i][c] += ds * qv[c];
        }
      }
    }
  }

  const size_t stride = static_cast<size_t>(a.heads) * D;
  const size_t base = (static_cast<size_t>(b) * a.n * a.heads + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= a.n) continue;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const size_t o = base + kpos * stride + tx + 16 * c;
      dk[o] = band::from_float<T>(acc_k[i][c] * a.scale);
      dv[o] = band::from_float<T>(acc_v[i][c]);
    }
  }
}

struct Ptrs {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  void *dq, *dk, *dv;
};

template <typename T, int D>
int launch(bool dkv, const Ptrs& p, int batch, const Args& a, cudaStream_t stream) {
  const dim3 grid((a.n + kTile - 1) / kTile, a.heads, batch);
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* g = static_cast<const T*>(p.g);
  cudaError_t err;
  if (dkv) {
    static bool smem_set = false;
    err = band::allow_smem(window_attention_bwd_dkv_kernel<T, D>, dkv_smem<D>(), smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    window_attention_bwd_dkv_kernel<T, D><<<grid, kThreads, dkv_smem<D>(), stream>>>(
        q, k, v, g, p.lse, p.delta, static_cast<T*>(p.dk), static_cast<T*>(p.dv), a);
  } else {
    static bool smem_set = false;
    err = band::allow_smem(window_attention_bwd_dq_kernel<T, D>, dq_smem<D>(), smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    window_attention_bwd_dq_kernel<T, D><<<grid, kThreads, dq_smem<D>(), stream>>>(
        q, k, v, g, p.lse, p.delta, static_cast<T*>(p.dq), a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, bool dkv, const Ptrs& p, int batch, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(dkv, p, batch, a, stream);
    case 32: return launch<T, 32>(dkv, p, batch, a, stream);
    case 64: return launch<T, 64>(dkv, p, batch, a, stream);
    case 128: return launch<T, 128>(dkv, p, batch, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run(int dtype, bool dkv, const Ptrs& p, const void* slopes, int batch, int n, int heads, int d,
        int w, float scale, float softcap, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const Args a{n, heads, w, scale, softcap, static_cast<const float*>(slopes)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(d, dkv, p, batch, a, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(d, dkv, p, batch, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points (bound with ctypes).  dtype: 0 = float32, 1 = bfloat16;
// d: 16, 32, 64 or 128; softcap 0 = none; slopes: float32 [H] or null; lse and
// delta float32 [B, H, N].  Shapes and types are validated by the Python
// wrappers.  Each returns the cudaError_t of its launch (0 on success).
extern "C" int window_attention_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                       const void* g, const void* lse, const void* delta,
                                       void* dq, const void* slopes, int batch, int n, int heads,
                                       int d, int w, float scale, float softcap, void* stream) {
  const Ptrs p{q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, nullptr, nullptr};
  return run(dtype, false, p, slopes, batch, n, heads, d, w, scale, softcap, stream);
}

extern "C" int window_attention_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                        const void* g, const void* lse, const void* delta,
                                        void* dk, void* dv, const void* slopes, int batch, int n,
                                        int heads, int d, int w, float scale, float softcap,
                                        void* stream) {
  const Ptrs p{q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
               nullptr, dk, dv};
  return run(dtype, true, p, slopes, batch, n, heads, d, w, scale, softcap, stream);
}
