// Sparse graph-transformer attention, forward (kernels K1 and K2).
//
// Replaces the TPU kernel anemoi_tpu/ops/pallas/paged_gt.py:_fwd_kernel
// (K1: fuse_edge=True, public op paged_gt_attention_flat_fe; K2:
// fuse_edge=False, public op paged_gt_attention_flat).  For every destination
// i, batch row b and head h, over the incoming edges j -> i of the
// dst-sorted CSR (dst_ptr, src):
//
//     e_ij   = attr_ij . W + bias         (K1; K2 reads e_ij [E, HD])
//     a_ij   = softmax_j( q_i . (k_j + e_ij) / sqrt(d) )
//     out_i  = sum_j a_ij (v_j + e_ij)    lse_i = log sum_j exp(logit_ij)
//
// What bounds it: memory.  Each launch reads q, k and v once, the CSR and
// the edge features, and writes out and lse; it does about 4*E*HD flops, far
// below the ~295 flop/byte at which an H100 turns compute-bound.  The
// design keeps every per-edge intermediate out of device memory: k_j + e_ij,
// v_j + e_ij and the logits live in registers, and K1 never forms the
// projected [E, HD] edge tensor (each thread holds its column of W and bias
// in registers; F, the raw edge width, is 3 in the flagship).
//
// Design (simple first; wgmma/TMA/shared-memory staging are later work):
//   - one block per (destination, batch row); thread c owns channel c;
//   - the per-head dot product is a warp-shuffle butterfly over the d lanes
//     of the head (d <= 32, a power of two), or a butterfly over the warp
//     plus a shared-memory sum over the head's warps (d a multiple of 32);
//   - the ordinary running-max online softmax in fp32 registers; the TPU
//     kernel's slot/page tables, one-hot matmul gathers and ln2-quantised
//     mean shift are artefacts of Mosaic lacking a row gather and do not
//     appear -- rows are gathered by index straight from device memory;
//   - a destination with no incoming edges gets out = 0 and lse = -inf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

#include "gt_common.cuh"

namespace {

using gt::edge_feature;
using gt::from_float;
using gt::head_sum;
using gt::kMaxEdgeFeatures;
using gt::load_edge_column;
using gt::to_float;

template <typename T, bool FUSE_EDGE>
__global__ void __launch_bounds__(gt::kMaxThreads) gt_attention_fwd_kernel(
    const T* __restrict__ q,        // [B, Nd, HD]
    const T* __restrict__ k,        // [B, Ns, HD]
    const T* __restrict__ v,        // [B, Ns, HD]
    const int* __restrict__ src,    // [E] source of each dst-sorted edge
    const int* __restrict__ dst_ptr,  // [Nd + 1]
    const T* __restrict__ edge,     // K2: e [E, HD]; K1: raw attributes [E, F]
    const T* __restrict__ w,        // K1: W, element (t, c) at t*w_sf + c*w_sc
    const T* __restrict__ bias,     // K1: [HD]
    T* __restrict__ out,            // [B, Nd, HD]
    float* __restrict__ lse,        // [B, Nd, H]
    int n_dst, int n_src, int hd, int d, int f, long long w_sf, long long w_sc,
    float scale) {
  extern __shared__ float partial[];
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  const int c = threadIdx.x;
  const bool active = c < hd;

  const size_t row = (static_cast<size_t>(b) * n_dst + i) * hd;
  const T* kb = k + static_cast<size_t>(b) * n_src * hd;
  const T* vb = v + static_cast<size_t>(b) * n_src * hd;
  const float qc = active ? to_float(q[row + c]) : 0.f;

  float wc[kMaxEdgeFeatures] = {};
  float bc = 0.f;
  if (FUSE_EDGE) load_edge_column(w, bias, c, active, f, w_sf, w_sc, wc, bc);

  float m = -CUDART_INF_F;  // running max of the head's logits
  float l = 0.f;            // running denominator
  float acc = 0.f;          // running numerator of channel c
  const int beg = dst_ptr[i];
  const int end = dst_ptr[i + 1];
  for (int j = beg; j < end; ++j) {
    const size_t s = static_cast<size_t>(src[j]) * hd;
    const float e = edge_feature<T, FUSE_EDGE>(edge, j, c, active, hd, f, wc, bc);
    const float kc = active ? to_float(kb[s + c]) + e : 0.f;
    const float vc = active ? to_float(vb[s + c]) + e : 0.f;
    const float logit = head_sum(qc * kc, d, partial) * scale;
    const float m_new = fmaxf(m, logit);
    const float corr = expf(m - m_new);
    const float p = expf(logit - m_new);
    l = l * corr + p;
    acc = acc * corr + p * vc;
    m = m_new;
  }
  if (active) {
    out[row + c] = from_float<T>(l > 0.f ? acc / l : 0.f);
    if (c % d == 0)
      lse[(static_cast<size_t>(b) * n_dst + i) * (hd / d) + c / d] =
          l > 0.f ? m + logf(l) : -CUDART_INF_F;
  }
}

template <typename T>
void launch(bool fuse_edge, const void* q, const void* k, const void* v, const int* src,
            const int* dst_ptr, const void* edge, const void* w, const void* bias, void* out,
            float* lse, int batch, int n_dst, int n_src, int hd, int d, int f, long long w_sf,
            long long w_sc, float scale, cudaStream_t stream) {
  const dim3 grid(n_dst, batch);
  const int threads = (hd + 31) / 32 * 32;
  const size_t smem = d > 32 ? (threads / 32) * sizeof(float) : 0;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* et = static_cast<const T*>(edge);
  if (fuse_edge) {
    gt_attention_fwd_kernel<T, true><<<grid, threads, smem, stream>>>(
        qt, kt, vt, src, dst_ptr, et, static_cast<const T*>(w), static_cast<const T*>(bias),
        static_cast<T*>(out), lse, n_dst, n_src, hd, d, f, w_sf, w_sc, scale);
  } else {
    gt_attention_fwd_kernel<T, false><<<grid, threads, smem, stream>>>(
        qt, kt, vt, src, dst_ptr, et, nullptr, nullptr, static_cast<T*>(out), lse, n_dst, n_src,
        hd, d, 0, 0, 0, scale);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// Shapes and types are validated by the Python wrapper.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int gt_attention_fwd(int dtype, int fuse_edge, const void* q, const void* k,
                                const void* v, const void* src, const void* dst_ptr,
                                const void* edge, const void* w, const void* bias, void* out,
                                void* lse, int batch, int n_dst, int n_src, int hd,
                                int num_heads, int f, long long w_sf, long long w_sc,
                                float scale, void* stream) {
  const int d = hd / num_heads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* s = static_cast<const int*>(src);
  const int* p = static_cast<const int*>(dst_ptr);
  float* l = static_cast<float*>(lse);
  if (n_dst > 0 && batch > 0) {
    if (dtype == 0)
      launch<float>(fuse_edge != 0, q, k, v, s, p, edge, w, bias, out, l, batch, n_dst, n_src, hd,
                    d, f, w_sf, w_sc, scale, st);
    else if (dtype == 1)
      launch<__nv_bfloat16>(fuse_edge != 0, q, k, v, s, p, edge, w, bias, out, l, batch, n_dst,
                            n_src, hd, d, f, w_sf, w_sc, scale, st);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
