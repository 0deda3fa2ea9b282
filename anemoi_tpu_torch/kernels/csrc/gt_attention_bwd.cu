// Sparse graph-transformer attention, backward (kernels K3, K4 and K5).
//
// Replaces the TPU kernels of anemoi_tpu/ops/pallas/paged_gt.py:
//   K3  _bwd_kernel           -> gt_attention_bwd_dst_kernel (destination pass)
//   K4  _reduce_kernel        -> gt_attention_bwd_src_kernel (source pass)
//   K5  _fused_reduce_kernel  -> gt_attention_bwd_src_fused_kernel (source
//                                pass that recomputes instead of reading dkv)
//
// With e_ij, k_eff = k_j + e_ij, v_eff = v_j + e_ij and the softmax statistic
// lse_i of the forward (gt_attention_fwd.cu), g = dL/d out and, per
// destination and head, delta_i = sum_c out_ic g_ic (formed in float32 by the
// caller), the gradient of an edge j -> i is, per head:
//
//     alpha_ij = exp(q_i . k_eff / sqrt(d) - lse_i)
//     dl_ij    = alpha_ij (g_i . v_eff - delta_i) / sqrt(d)
//     dq_i    += dl_ij k_eff          dk_eff = dl_ij q_i     dv_eff = alpha_ij g_i
//     de_ij    = dk_eff + dv_eff      (e is added to both k and v)
//
// and dk_j = sum over j's edges of dk_eff, dv_j likewise.  With the edge
// projection fused (FUSE_EDGE, e = attr . W + bias):
// d_attr_j = de_j . W^T, dW = sum_j attr_j^T de_j, dbias = sum_j de_j.
//
// What bounds them: memory, as for the forward.  K3 reads q, g, k, v, the
// CSR and the edge input once and writes dq and (unless the fused backward
// is chosen) the per-edge buffer dkv [B, E, 2HD]; K4 reads dkv back once; K5
// reads what K3 reads and writes dk, dv.  All three do O(E * HD) flops, far
// below the ~295 flop/byte at which an H100 turns compute-bound.  dkv
// dominates the bytes (bf16, processor edge set: 168 MB, ~50 us at 3.35 TB/s);
// K5 exists to drop it, at the price of recomputing alpha and dl per edge.
//
// Design (simple first; wgmma/TMA staging are later work).  Thread c owns
// channel c, per-head dot products are head_sum butterflies (gt_common.cuh),
// all arithmetic is float32 and each output is rounded once on its store.
//   - K3 is a grid-stride launch over destinations with as many blocks as
//     fit on the card at once.  A block walks its destination's edges for
//     each batch row in turn: the edges of destination i belong to one block,
//     so that block alone sums their gradients over the batch rows (no
//     atomics).  Per-edge d_e (K2) and d_attr (K1) are float32 buffers; the
//     d_attr row is a block reduction over channels.  Thread c keeps its
//     column of dW and dbias in registers across every edge the block visits
//     and writes one partial per block; a second short kernel sums the
//     partials in a fixed order.  Every K3 output is therefore deterministic
//     run to run on a given card (the block count follows the card's SM count
//     and the kernel's occupancy).
//   - K4 and K5 use one block per (source, batch row) and walk the source's
//     edges through the source-ordered view (src_ptr, src_perm: the edge ids
//     sorted by source, stable by destination).  No atomics: deterministic.
//     A source without edges writes dk = dv = 0.
//   - The TPU kernels' slot/page tables and one-hot matmul gathers are
//     artefacts of Mosaic lacking a row gather and do not appear.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "gt_common.cuh"

namespace {

using gt::edge_feature;
using gt::from_float;
using gt::head_sum;
using gt::kMaxEdgeFeatures;
using gt::load_edge_column;
using gt::to_float;

constexpr int kFinalizeWarps = 8;

// K3: the destination pass.
template <typename T, bool FUSE_EDGE>
__global__ void __launch_bounds__(gt::kMaxThreads) gt_attention_bwd_dst_kernel(
    const T* __restrict__ q,          // [B, Nd, HD]
    const T* __restrict__ k,          // [B, Ns, HD]
    const T* __restrict__ v,          // [B, Ns, HD]
    const T* __restrict__ g,          // [B, Nd, HD]
    const float* __restrict__ lse,    // [B, Nd, H]
    const float* __restrict__ delta,  // [B, Nd, H]
    const int* __restrict__ src,      // [E] source of each dst-sorted edge
    const int* __restrict__ dst_ptr,  // [Nd + 1]
    const T* __restrict__ edge,       // K2: e [E, HD]; K1: raw attributes [E, F]
    const T* __restrict__ w,          // K1: W, element (t, c) at t*w_sf + c*w_sc
    const T* __restrict__ bias,       // K1: [HD]
    T* __restrict__ dq,               // [B, Nd, HD]
    T* __restrict__ dkv,              // [B, E, 2HD] (dk_eff | dv_eff), or null
    float* __restrict__ d_edge,       // K2: d_e [E, HD]; K1: d_attr [E, F]; or null
    float* __restrict__ dw_part,      // K1: [gridDim.x, F + 1, HD] (dW rows, dbias), or null
    int batch, int n_dst, int n_src, int n_edges, int hd, int d, int f, long long w_sf,
    long long w_sc, float scale) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  float* partial = smem;        // [warps], head_sum
  float* red = smem + warps;    // [warps, kMaxEdgeFeatures], the d_attr reduction
  const int c = threadIdx.x;
  const int lane = c & 31;
  const int warp = c >> 5;
  const bool active = c < hd;
  const int n_heads = hd / d;
  const int head = active ? c / d : 0;

  float wc[kMaxEdgeFeatures] = {};
  float bc = 0.f;
  if (FUSE_EDGE) load_edge_column(w, bias, c, active, f, w_sf, w_sc, wc, bc);
  float dw_acc[kMaxEdgeFeatures] = {};
  float db_acc = 0.f;

  for (int i = blockIdx.x; i < n_dst; i += gridDim.x) {
    const int beg = dst_ptr[i];
    const int end = dst_ptr[i + 1];
    for (int b = 0; b < batch; ++b) {
      const size_t row = (static_cast<size_t>(b) * n_dst + i) * hd;
      const size_t hrow = (static_cast<size_t>(b) * n_dst + i) * n_heads + head;
      const T* kb = k + static_cast<size_t>(b) * n_src * hd;
      const T* vb = v + static_cast<size_t>(b) * n_src * hd;
      const float qc = active ? to_float(q[row + c]) : 0.f;
      const float gc = active ? to_float(g[row + c]) : 0.f;
      // read only when the destination has edges: an empty one has lse = -inf
      const float lse_h = (active && end > beg) ? lse[hrow] : 0.f;
      const float delta_h = (active && end > beg) ? delta[hrow] : 0.f;
      float dq_acc = 0.f;
      for (int j = beg; j < end; ++j) {
        const size_t s = static_cast<size_t>(src[j]) * hd;
        const float e = edge_feature<T, FUSE_EDGE>(edge, j, c, active, hd, f, wc, bc);
        const float kc = active ? to_float(kb[s + c]) + e : 0.f;
        const float vc = active ? to_float(vb[s + c]) + e : 0.f;
        const float logit = head_sum(qc * kc, d, partial) * scale;
        const float alpha = active ? expf(logit - lse_h) : 0.f;
        const float dalpha = head_sum(gc * vc, d, partial);
        const float dl = alpha * (dalpha - delta_h) * scale;
        dq_acc += dl * kc;
        const float dk_e = dl * qc;
        const float dv_e = alpha * gc;
        if (dkv != nullptr && active) {
          const size_t r = (static_cast<size_t>(b) * n_edges + j) * 2 * hd;
          dkv[r + c] = from_float<T>(dk_e);
          dkv[r + hd + c] = from_float<T>(dv_e);
        }
        const float de = dk_e + dv_e;  // 0 on inactive threads
        if (FUSE_EDGE) {
          if (dw_part != nullptr) {
#pragma unroll
            for (int t = 0; t < kMaxEdgeFeatures; ++t)
              if (t < f) dw_acc[t] += to_float(edge[static_cast<size_t>(j) * f + t]) * de;
            db_acc += de;
          }
          if (d_edge != nullptr) {  // d_attr[j, t] = sum_c de_c W[t, c]
            float part[kMaxEdgeFeatures];
#pragma unroll
            for (int t = 0; t < kMaxEdgeFeatures; ++t) {
              part[t] = de * wc[t];
              if (t < f)
                for (int off = 16; off > 0; off >>= 1)
                  part[t] += __shfl_xor_sync(0xffffffffu, part[t], off);
            }
            __syncthreads();  // the previous edge's reads of `red` are done
            if (lane == 0)
#pragma unroll
              for (int t = 0; t < kMaxEdgeFeatures; ++t)
                if (t < f) red[warp * kMaxEdgeFeatures + t] = part[t];
            __syncthreads();
            if (c < f) {
              float sum = 0.f;
              for (int w2 = 0; w2 < warps; ++w2) sum += red[w2 * kMaxEdgeFeatures + c];
              float* p = d_edge + static_cast<size_t>(j) * f + c;
              *p = b == 0 ? sum : *p + sum;
            }
          }
        } else if (d_edge != nullptr && active) {
          float* p = d_edge + static_cast<size_t>(j) * hd + c;
          *p = b == 0 ? de : *p + de;
        }
      }
      if (active) dq[row + c] = from_float<T>(dq_acc);
    }
  }
  if (FUSE_EDGE && dw_part != nullptr && active) {
    float* p = dw_part + static_cast<size_t>(blockIdx.x) * (f + 1) * hd;
    for (int t = 0; t < f; ++t) p[static_cast<size_t>(t) * hd + c] = dw_acc[t];
    p[static_cast<size_t>(f) * hd + c] = db_acc;
  }
}

// K3's second step: dW [F, HD] and dbias [HD] from the per-block partials
// [n_part, F + 1, HD], summed in a fixed order.  Block: 32 consecutive
// outputs, its warps splitting the partials.
__global__ void gt_attention_bwd_dw_finalize_kernel(const float* __restrict__ part, int n_part,
                                                    int f, int hd, float* __restrict__ dw,
                                                    float* __restrict__ db) {
  __shared__ float acc[kFinalizeWarps][32];
  const int n = (f + 1) * hd;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int idx = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (idx < n)
    for (int p = warp; p < n_part; p += kFinalizeWarps) s += part[static_cast<size_t>(p) * n + idx];
  acc[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && idx < n) {
    float t = 0.f;
    for (int w = 0; w < kFinalizeWarps; ++w) t += acc[w][lane];
    if (idx < f * hd)
      dw[idx] = t;
    else
      db[idx - f * hd] = t;
  }
}

// K4: the source pass, summing the per-edge rows of dkv into their source.
template <typename T>
__global__ void __launch_bounds__(gt::kMaxThreads) gt_attention_bwd_src_kernel(
    const T* __restrict__ dkv,          // [B, E, 2HD]
    const int* __restrict__ src_ptr,    // [Ns + 1]
    const int* __restrict__ src_perm,   // [E] edge ids sorted by source
    T* __restrict__ dk, T* __restrict__ dv,  // [B, Ns, HD]
    int n_src, int n_edges, int hd) {
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int c = threadIdx.x;
  if (c >= hd) return;
  const T* base = dkv + static_cast<size_t>(b) * n_edges * 2 * hd;
  float ak = 0.f, av = 0.f;
  const int end = src_ptr[s + 1];
  for (int p = src_ptr[s]; p < end; ++p) {
    const size_t r = static_cast<size_t>(src_perm[p]) * 2 * hd;
    ak += to_float(base[r + c]);
    av += to_float(base[r + hd + c]);
  }
  const size_t o = (static_cast<size_t>(b) * n_src + s) * hd + c;
  dk[o] = from_float<T>(ak);
  dv[o] = from_float<T>(av);
}

// K5: the source pass without dkv, recomputing each edge's alpha and dl
// (K3's math) from the destination's q, g, lse and delta.
template <typename T, bool FUSE_EDGE>
__global__ void __launch_bounds__(gt::kMaxThreads) gt_attention_bwd_src_fused_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ dst,       // [E] destination of each dst-sorted edge
    const int* __restrict__ src_ptr,   // [Ns + 1]
    const int* __restrict__ src_perm,  // [E]
    const T* __restrict__ edge, const T* __restrict__ w, const T* __restrict__ bias,
    T* __restrict__ dk, T* __restrict__ dv,  // [B, Ns, HD]
    int n_dst, int n_src, int hd, int d, int f, long long w_sf, long long w_sc, float scale) {
  extern __shared__ float partial[];
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int c = threadIdx.x;
  const bool active = c < hd;
  const int n_heads = hd / d;
  const int head = active ? c / d : 0;

  float wc[kMaxEdgeFeatures] = {};
  float bc = 0.f;
  if (FUSE_EDGE) load_edge_column(w, bias, c, active, f, w_sf, w_sc, wc, bc);
  const size_t row_s = (static_cast<size_t>(b) * n_src + s) * hd;
  const float k0 = active ? to_float(k[row_s + c]) : 0.f;
  const float v0 = active ? to_float(v[row_s + c]) : 0.f;
  float ak = 0.f, av = 0.f;
  const int end = src_ptr[s + 1];
  for (int p = src_ptr[s]; p < end; ++p) {
    const int j = src_perm[p];
    const int i = dst[j];
    const float e = edge_feature<T, FUSE_EDGE>(edge, j, c, active, hd, f, wc, bc);
    const float kc = active ? k0 + e : 0.f;
    const float vc = active ? v0 + e : 0.f;
    const size_t row = (static_cast<size_t>(b) * n_dst + i) * hd;
    const size_t hrow = (static_cast<size_t>(b) * n_dst + i) * n_heads + head;
    const float qc = active ? to_float(q[row + c]) : 0.f;
    const float gc = active ? to_float(g[row + c]) : 0.f;
    const float lse_h = active ? lse[hrow] : 0.f;  // i has an edge: lse is finite
    const float delta_h = active ? delta[hrow] : 0.f;
    const float logit = head_sum(qc * kc, d, partial) * scale;
    const float alpha = active ? expf(logit - lse_h) : 0.f;
    const float dalpha = head_sum(gc * vc, d, partial);
    const float dl = alpha * (dalpha - delta_h) * scale;
    ak += dl * qc;
    av += alpha * gc;
  }
  if (active) {
    dk[row_s + c] = from_float<T>(ak);
    dv[row_s + c] = from_float<T>(av);
  }
}

int threads_for(int hd) { return (hd + 31) / 32 * 32; }

size_t dst_smem(int threads) { return (threads / 32) * (1 + kMaxEdgeFeatures) * sizeof(float); }

template <typename T, bool FUSE_EDGE>
int dst_blocks_per_sm(int threads) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, gt_attention_bwd_dst_kernel<T, FUSE_EDGE>, threads, dst_smem(threads));
  return n;
}

template <typename T>
void launch_dst(bool fuse_edge, const void* q, const void* k, const void* v, const void* g,
                const float* lse, const float* delta, const int* src, const int* dst_ptr,
                const void* edge, const void* w, const void* bias, void* dq, void* dkv,
                float* d_edge, float* dw_part, int batch, int n_dst, int n_src, int n_edges, int hd,
                int d, int f, long long w_sf, long long w_sc, float scale, int blocks,
                cudaStream_t stream) {
  const int threads = threads_for(hd);
  const size_t smem = dst_smem(threads);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gtt = static_cast<const T*>(g);
  const T* et = static_cast<const T*>(edge);
  if (fuse_edge) {
    gt_attention_bwd_dst_kernel<T, true><<<blocks, threads, smem, stream>>>(
        qt, kt, vt, gtt, lse, delta, src, dst_ptr, et, static_cast<const T*>(w),
        static_cast<const T*>(bias), static_cast<T*>(dq), static_cast<T*>(dkv), d_edge, dw_part,
        batch, n_dst, n_src, n_edges, hd, d, f, w_sf, w_sc, scale);
  } else {
    gt_attention_bwd_dst_kernel<T, false><<<blocks, threads, smem, stream>>>(
        qt, kt, vt, gtt, lse, delta, src, dst_ptr, et, nullptr, nullptr, static_cast<T*>(dq),
        static_cast<T*>(dkv), d_edge, nullptr, batch, n_dst, n_src, n_edges, hd, d, 0, 0, 0,
        scale);
  }
}

template <typename T>
void launch_src_fused(bool fuse_edge, const void* q, const void* k, const void* v, const void* g,
                      const float* lse, const float* delta, const int* dst, const int* src_ptr,
                      const int* src_perm, const void* edge, const void* w, const void* bias,
                      void* dk, void* dv, int batch, int n_dst, int n_src, int hd, int d, int f,
                      long long w_sf, long long w_sc, float scale, cudaStream_t stream) {
  const dim3 grid(n_src, batch);
  const int threads = threads_for(hd);
  const size_t smem = d > 32 ? (threads / 32) * sizeof(float) : 0;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gtt = static_cast<const T*>(g);
  const T* et = static_cast<const T*>(edge);
  if (fuse_edge) {
    gt_attention_bwd_src_fused_kernel<T, true><<<grid, threads, smem, stream>>>(
        qt, kt, vt, gtt, lse, delta, dst, src_ptr, src_perm, et, static_cast<const T*>(w),
        static_cast<const T*>(bias), static_cast<T*>(dk), static_cast<T*>(dv), n_dst, n_src, hd,
        d, f, w_sf, w_sc, scale);
  } else {
    gt_attention_bwd_src_fused_kernel<T, false><<<grid, threads, smem, stream>>>(
        qt, kt, vt, gtt, lse, delta, dst, src_ptr, src_perm, et, nullptr, nullptr,
        static_cast<T*>(dk), static_cast<T*>(dv), n_dst, n_src, hd, d, 0, 0, 0, scale);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// Shapes and types are validated by the Python wrappers.  Each returns the
// cudaError_t of its launches (0 on success).

// Blocks of K3 that fit on the current card at once (SMs x occupancy): the
// grid of the destination pass and the row count of its dW partials.
extern "C" int gt_attention_bwd_dst_blocks(int dtype, int fuse_edge, int hd, int* blocks) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int threads = threads_for(hd);
  int per_sm = 0;
  if (dtype == 0)
    per_sm = fuse_edge ? dst_blocks_per_sm<float, true>(threads)
                       : dst_blocks_per_sm<float, false>(threads);
  else if (dtype == 1)
    per_sm = fuse_edge ? dst_blocks_per_sm<__nv_bfloat16, true>(threads)
                       : dst_blocks_per_sm<__nv_bfloat16, false>(threads);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(cudaGetLastError());
}

// K3 (+ its dW finalize when dw is given).  dkv, d_edge, dw_part/dw/db may be
// null; dw_part holds `blocks` rows.
extern "C" int gt_attention_bwd_dst(int dtype, int fuse_edge, const void* q, const void* k,
                                    const void* v, const void* g, const void* lse,
                                    const void* delta, const void* src, const void* dst_ptr,
                                    const void* edge, const void* w, const void* bias, void* dq,
                                    void* dkv, void* d_edge, void* dw_part, void* dw, void* db,
                                    int batch, int n_dst, int n_src, int n_edges, int hd,
                                    int num_heads, int f, long long w_sf, long long w_sc,
                                    float scale, int blocks, void* stream) {
  const int d = hd / num_heads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* s = static_cast<const int*>(src);
  const int* p = static_cast<const int*>(dst_ptr);
  float* de = static_cast<float*>(d_edge);
  float* part = static_cast<float*>(dw_part);
  const int grid = n_dst < blocks ? n_dst : blocks;
  if (n_dst > 0 && batch > 0) {
    if (dtype == 0)
      launch_dst<float>(fuse_edge != 0, q, k, v, g, l, dl, s, p, edge, w, bias, dq, dkv, de, part,
                        batch, n_dst, n_src, n_edges, hd, d, f, w_sf, w_sc, scale, grid, st);
    else if (dtype == 1)
      launch_dst<__nv_bfloat16>(fuse_edge != 0, q, k, v, g, l, dl, s, p, edge, w, bias, dq, dkv,
                                de, part, batch, n_dst, n_src, n_edges, hd, d, f, w_sf, w_sc,
                                scale, grid, st);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (fuse_edge != 0 && dw != nullptr) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n = (f + 1) * hd;
    const int n_part = (n_dst > 0 && batch > 0) ? grid : 0;
    gt_attention_bwd_dw_finalize_kernel<<<(n + 31) / 32, 32 * kFinalizeWarps, 0, st>>>(
        part, n_part, f, hd, static_cast<float*>(dw), static_cast<float*>(db));
  }
  return static_cast<int>(cudaGetLastError());
}

// K4.
extern "C" int gt_attention_bwd_src(int dtype, const void* dkv, const void* src_ptr,
                                    const void* src_perm, void* dk, void* dv, int batch,
                                    int n_src, int n_edges, int hd, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(src_ptr);
  const int* perm = static_cast<const int*>(src_perm);
  if (n_src > 0 && batch > 0) {
    const dim3 grid(n_src, batch);
    const int threads = threads_for(hd);
    if (dtype == 0)
      gt_attention_bwd_src_kernel<float><<<grid, threads, 0, st>>>(
          static_cast<const float*>(dkv), p, perm, static_cast<float*>(dk),
          static_cast<float*>(dv), n_src, n_edges, hd);
    else if (dtype == 1)
      gt_attention_bwd_src_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(dkv), p, perm, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), n_src, n_edges, hd);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5.
extern "C" int gt_attention_bwd_src_fused(int dtype, int fuse_edge, const void* q, const void* k,
                                          const void* v, const void* g, const void* lse,
                                          const void* delta, const void* dst, const void* src_ptr,
                                          const void* src_perm, const void* edge, const void* w,
                                          const void* bias, void* dk, void* dv, int batch,
                                          int n_dst, int n_src, int hd, int num_heads, int f,
                                          long long w_sf, long long w_sc, float scale,
                                          void* stream) {
  const int d = hd / num_heads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* di = static_cast<const int*>(dst);
  const int* p = static_cast<const int*>(src_ptr);
  const int* perm = static_cast<const int*>(src_perm);
  if (n_src > 0 && batch > 0) {
    if (dtype == 0)
      launch_src_fused<float>(fuse_edge != 0, q, k, v, g, l, dl, di, p, perm, edge, w, bias, dk,
                              dv, batch, n_dst, n_src, hd, d, f, w_sf, w_sc, scale, st);
    else if (dtype == 1)
      launch_src_fused<__nv_bfloat16>(fuse_edge != 0, q, k, v, g, l, dl, di, p, perm, edge, w,
                                      bias, dk, dv, batch, n_dst, n_src, hd, d, f, w_sf, w_sc,
                                      scale, st);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
