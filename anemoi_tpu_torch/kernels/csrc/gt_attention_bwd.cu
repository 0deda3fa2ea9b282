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
// Design.  All arithmetic is float32 and each output is rounded once on its
// store.
//   - K3 is a grid-stride launch over destinations with as many blocks as
//     fit on the card at once.  A block of 256 threads holds several
//     destination groups (4 at bf16 HD = 512, 2 at HD = 1024): each lane of
//     a group owns V channels (V * sizeof(T) = 16 bytes: 8 bf16 or 4
//     float32, fewer when the head is smaller) and reads q, g, every k/v row
//     and e row, and writes dq and the dkv row, as one vector each.  The
//     group reads 32 edge sources at once (one per lane, spread by shuffles)
//     and issues the next edge's k/v/edge loads before the current edge's
//     arithmetic, so the gathers overlap.  A head's dot product is V FMAs and
//     log2(d / V) shuffles; only a head wider than 32 lanes (or of a width
//     that is not a power of two) takes one barrier of the group's own warps
//     per edge.  The edges of destination i belong to one group, which sums
//     their gradients over the batch rows (no atomics).  Per-edge d_e (K2
//     side) and d_attr (K1 side) are float32 buffers; the d_attr row is a
//     sum over the group's lanes.  Each lane keeps its V columns of dW and
//     dbias in registers across every edge its group visits; at the end the
//     block sums its groups' columns in a fixed order and writes one partial
//     row, and a second short kernel sums the partials in a fixed order.
//     Every K3 output is therefore deterministic run to run on a given card
//     (the block count follows the card's SM count and the kernel's
//     occupancy).  Thread c of K4 and K5 owns channel c; their per-head dot
//     products are head_sum butterflies (gt_common.cuh).
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

// ---- K3: the destination pass ---------------------------------------------

constexpr int kDstThreads = 256;  // a K3 block: 256 / GS destination groups of GS lanes

// V consecutive elements of T as one aligned access of V * sizeof(T) bytes
// (16 at V = 16 / sizeof(T)), held as raw 32-bit words until first use, so
// that a load issued an edge ahead stalls nothing before its values are read.
template <typename T, int V>
struct Vec {
  static constexpr int kBytes = V * static_cast<int>(sizeof(T));
  static constexpr int kWords = (kBytes + 3) / 4;
  unsigned w[kWords];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int x = 0; x < kWords; ++x) w[x] = 0u;
  }
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kBytes == 16) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = r.x, w[1] = r.y, w[2] = r.z, w[3] = r.w;
    } else if constexpr (kBytes == 8) {
      const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = r.x, w[1] = r.y;
    } else if constexpr (kBytes == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
  }
  // element x as float32 (bf16: the low half of a word is the lower element)
  __device__ __forceinline__ float get(int x) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[x]);
    } else {
      const unsigned u = w[x >> 1];
      return __uint_as_float((x & 1) ? (u & 0xffff0000u) : (u << 16));
    }
  }
};

// x[0..V) rounded once to T and stored as one aligned access.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&x)[V]) {
  Vec<T, V> o;
  o.zero();
#pragma unroll
  for (int c = 0; c < V; ++c) {
    if constexpr (sizeof(T) == 4) {
      o.w[c] = __float_as_uint(x[c]);
    } else {
      const unsigned h = __bfloat16_as_ushort(__float2bfloat16_rn(x[c]));
      o.w[c >> 1] |= (c & 1) ? (h << 16) : h;
    }
  }
  if constexpr (Vec<T, V>::kBytes == 16)
    *reinterpret_cast<uint4*>(p) = make_uint4(o.w[0], o.w[1], o.w[2], o.w[3]);
  else if constexpr (Vec<T, V>::kBytes == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(o.w[0], o.w[1]);
  else if constexpr (Vec<T, V>::kBytes == 4)
    *reinterpret_cast<unsigned*>(p) = o.w[0];
  else
    *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(o.w[0]);
}

// V float32 values from p (shared or global), as float4 where V allows.
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int c = 0; c < V; c += 4) {
      const float4 r = *reinterpret_cast<const float4*>(p + c);
      x[c] = r.x, x[c + 1] = r.y, x[c + 2] = r.z, x[c + 3] = r.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) x[c] = p[c];
  }
}

// p[0..V) = x (add: p += x), float32, as float4 where V allows.
template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&x)[V], bool add) {
  float y[V];
  if (add) {
    load_f32<V>(p, y);
#pragma unroll
    for (int c = 0; c < V; ++c) y[c] += x[c];
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) y[c] = x[c];
  }
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int c = 0; c < V; c += 4)
      *reinterpret_cast<float4*>(p + c) = make_float4(y[c], y[c + 1], y[c + 2], y[c + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) p[c] = y[c];
  }
}

// K3.  A destination is walked by a group of GS lanes (`gs`), lane l owning
// channels [lV, lV + V); lanes past HD / V only take part in the group's
// shuffles and barriers.  GS is HD / V rounded up to a power of two (at most
// 32) or to a multiple of 32, so a group is a slice of one warp or whole
// warps.  A head spans lh = d / V lanes; its dot products are V FMAs and a
// butterfly over `seg` lanes (the largest power of two dividing lh, at most
// 32), plus, when a head is wider than that (lh > 32, or lh not a power of
// two), one barrier of the group's lanes and a sum of the segments' partials
// through shared memory.  The smem scratch of each group holds two buffers
// used in turn, so that one barrier per exchange suffices.  Two blocks an SM
// (at most 128 registers a thread), except with room for 8 edge features
// (72 dW and dbias sums a lane) and at V = 1, whose groups may span 1024
// threads (HD = 1024 at d < 4).
template <typename T, int V, bool FUSE_EDGE, int FMAX>
__global__ void __launch_bounds__(V == 1 ? 1024 : kDstThreads, V == 1 || FMAX > 4 ? 1 : 2)
    gt_attention_bwd_dst_kernel(
        const T* __restrict__ q,          // [B, Nd, HD]
        const T* __restrict__ k,          // [B, Ns, HD]
        const T* __restrict__ v,          // [B, Ns, HD]
        const T* __restrict__ g,          // [B, Nd, HD]
        const float* __restrict__ lse,    // [B, Nd, H]
        const float* __restrict__ delta,  // [B, Nd, H]
        const int* __restrict__ src,      // [E] source of each dst-sorted edge
        const int* __restrict__ dst_ptr,  // [Nd + 1]
        const T* __restrict__ edge,       // K2 side: e [E, HD]; K1 side: raw attributes [E, F]
        const T* __restrict__ w,          // K1 side: W, element (t, c) at t*w_sf + c*w_sc
        const T* __restrict__ bias,       // K1 side: [HD]
        T* __restrict__ dq,               // [B, Nd, HD]
        T* __restrict__ dkv,              // [B, E, 2HD] (dk_eff | dv_eff), or null
        float* __restrict__ d_edge,       // K2 side: d_e [E, HD]; K1 side: d_attr [E, F]; or null
        float* __restrict__ dw_part,      // K1 side: [gridDim.x, F + 1, HD] (dW rows, dbias), or null
        int batch, int n_dst, int n_src, int n_edges, int hd, int d, int f, long long w_sf,
        long long w_sc, float scale, int gs, int seg) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int threads = blockDim.x;
  const int groups = threads / gs;
  const int group = threadIdx.x / gs;
  const int lane_g = threadIdx.x - group * gs;  // lane in the group
  const int lane = threadIdx.x & 31;
  const int base = gs < 32 ? (lane & ~(gs - 1)) : 0;  // warp lane of the group's first lane
  const unsigned mask = gs < 32 ? ((1u << gs) - 1u) << base : 0xffffffffu;
  const int chunk = gs < 32 ? gs : 32;  // edge sources read at once, one per lane
  const int cl = lane - base;           // this lane's entry of a chunk
  const bool active = lane_g * V < hd;
  const int c0 = active ? lane_g * V : 0;
  const int n_heads = hd / d;
  const int head = c0 / d;
  const int lh = d / V;
  float* scratch = smem + 4 * gs * group;  // [2][2 * gs] floats, used in turn
  float* wsm = smem + 4 * threads;         // K1 side: W as [F, HD] then bias, float32
  int parity = 0;

  if (FUSE_EDGE) {
    for (int x = threadIdx.x; x < (f + 1) * hd; x += threads) {
      const int t = x / hd, c = x - t * hd;
      wsm[x] = to_float(t < f ? w[t * w_sf + c * w_sc] : bias[c]);
    }
    __syncthreads();
  }

  auto group_sync = [&]() {
    if (gs <= 32)
      __syncwarp(mask);
    else  // the group's own warps only: named barrier 1 + group
      asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(gs) : "memory");
  };
  // x, y summed over the lh lanes of the calling lane's head
  auto head_sums = [&](float& x, float& y) {
    for (int off = seg >> 1; off > 0; off >>= 1) {
      x += __shfl_xor_sync(mask, x, off);
      y += __shfl_xor_sync(mask, y, off);
    }
    if (seg < lh) {
      float2* buf = reinterpret_cast<float2*>(scratch) + parity * gs;
      parity ^= 1;
      if ((lane_g & (seg - 1)) == 0) buf[lane_g / seg] = make_float2(x, y);
      group_sync();
      const int per = lh / seg;
      const float2* p = buf + (lane_g / lh) * per;
      float sx = 0.f, sy = 0.f;
      for (int s = 0; s < per; ++s) sx += p[s].x, sy += p[s].y;
      x = sx, y = sy;
    }
  };
  // part[0..f) summed over all lanes of the group, returned to every lane
  auto group_sum = [&](float (&part)[FMAX]) {
    const int width = gs < 32 ? gs : 32;
#pragma unroll
    for (int t = 0; t < FMAX; ++t)
      if (t < f)
        for (int off = width >> 1; off > 0; off >>= 1)
          part[t] += __shfl_xor_sync(mask, part[t], off);
    if (gs > 32) {
      float* buf = scratch + parity * 2 * gs;
      parity ^= 1;
      if (lane == 0)
#pragma unroll
        for (int t = 0; t < FMAX; ++t)
          if (t < f) buf[(lane_g >> 5) * FMAX + t] = part[t];
      group_sync();
#pragma unroll
      for (int t = 0; t < FMAX; ++t) {
        float s = 0.f;
        if (t < f)
          for (int wg = 0; wg < (gs >> 5); ++wg) s += buf[wg * FMAX + t];
        part[t] = s;
      }
    }
  };

  float dw_acc[FMAX][V] = {};  // K1 side: this lane's columns of dW
  float db_acc[V] = {};
  for (int i = blockIdx.x * groups + group; i < n_dst; i += gridDim.x * groups) {
    const int beg = dst_ptr[i];
    const int end = dst_ptr[i + 1];
    for (int b = 0; b < batch; ++b) {
      const size_t row = (static_cast<size_t>(b) * n_dst + i) * hd + c0;
      Vec<T, V> qr, gr;  // q and g, unpacked at each use (fewer registers)
      qr.zero();
      gr.zero();
      if (active) {
        qr.load(q + row);
        gr.load(g + row);
      }
      float dqv[V] = {};
      if (end > beg) {  // an empty destination has lse = -inf: not read
        const size_t hrow = (static_cast<size_t>(b) * n_dst + i) * n_heads + head;
        const float lse_h = active ? lse[hrow] : 0.f;
        const float delta_h = active ? delta[hrow] : 0.f;
        const T* kb = k + static_cast<size_t>(b) * n_src * hd + c0;
        const T* vb = v + static_cast<size_t>(b) * n_src * hd + c0;
        // the edge's k and v rows and edge input, and the next edge's in flight
        Vec<T, V> kc, vc, kn, vn, ec, en;
        T ac[FMAX], an[FMAX];
        kc.zero();
        vc.zero();
        kn.zero();
        vn.zero();
        ec.zero();
        en.zero();
        auto load_edge = [&](int j, int s, Vec<T, V>& kr, Vec<T, V>& vr, Vec<T, V>& er,
                             T (&ar)[FMAX]) {
          if (active) {
            kr.load(kb + static_cast<size_t>(s) * hd);
            vr.load(vb + static_cast<size_t>(s) * hd);
            if (!FUSE_EDGE) er.load(edge + static_cast<size_t>(j) * hd + c0);
          }
          if (FUSE_EDGE)
#pragma unroll
            for (int t = 0; t < FMAX; ++t)
              if (t < f) ar[t] = edge[static_cast<size_t>(j) * f + t];
        };
        int s_chunk = beg + cl < end ? src[beg + cl] : 0;
        load_edge(beg, __shfl_sync(mask, s_chunk, base), kc, vc, ec, ac);
        for (int j = beg; j < end; ++j) {
          if (j + 1 < end) {
            const int o = (j + 1 - beg) & (chunk - 1);
            if (o == 0) s_chunk = j + 1 + cl < end ? src[j + 1 + cl] : 0;
            load_edge(j + 1, __shfl_sync(mask, s_chunk, base + o), kn, vn, en, an);
          }
          float e[V], kf[V];
          if constexpr (FUSE_EDGE) {
            load_f32<V>(wsm + static_cast<size_t>(f) * hd + c0, e);
#pragma unroll
            for (int t = 0; t < FMAX; ++t) {
              if (t < f) {
                float wr[V];
                load_f32<V>(wsm + static_cast<size_t>(t) * hd + c0, wr);
                const float a = to_float(ac[t]);
#pragma unroll
                for (int x = 0; x < V; ++x) e[x] += a * wr[x];
              }
            }
          } else {
#pragma unroll
            for (int x = 0; x < V; ++x) e[x] = ec.get(x);
          }
          float logit = 0.f, dalpha = 0.f;
#pragma unroll
          for (int x = 0; x < V; ++x) {
            kf[x] = kc.get(x) + e[x];
            logit += qr.get(x) * kf[x];
            dalpha += gr.get(x) * (vc.get(x) + e[x]);
          }
          head_sums(logit, dalpha);
          const float alpha = active ? expf(logit * scale - lse_h) : 0.f;
          const float dl = active ? alpha * (dalpha - delta_h) * scale : 0.f;
          float dk_e[V], dv_e[V], de[V];
#pragma unroll
          for (int x = 0; x < V; ++x) {
            dqv[x] += dl * kf[x];
            dk_e[x] = dl * qr.get(x);
            dv_e[x] = alpha * gr.get(x);
            de[x] = dk_e[x] + dv_e[x];  // e is added to both k and v
          }
          if (dkv != nullptr && active) {
            T* r = dkv + (static_cast<size_t>(b) * n_edges + j) * 2 * hd + c0;
            store_vec<T, V>(r, dk_e);
            store_vec<T, V>(r + hd, dv_e);
          }
          if constexpr (FUSE_EDGE) {
            if (dw_part != nullptr) {
#pragma unroll
              for (int t = 0; t < FMAX; ++t) {
                if (t < f) {
                  const float a = to_float(ac[t]);
#pragma unroll
                  for (int x = 0; x < V; ++x) dw_acc[t][x] += a * de[x];
                }
              }
#pragma unroll
              for (int x = 0; x < V; ++x) db_acc[x] += de[x];
            }
            if (d_edge != nullptr) {  // d_attr[j, t] = sum_c de_c W[t, c]
              float part[FMAX];
#pragma unroll
              for (int t = 0; t < FMAX; ++t) {
                part[t] = 0.f;
                if (t < f) {
                  float wr[V];
                  load_f32<V>(wsm + static_cast<size_t>(t) * hd + c0, wr);
#pragma unroll
                  for (int x = 0; x < V; ++x) part[t] += de[x] * wr[x];  // 0 on inactive lanes
                }
              }
              group_sum(part);
              if (lane_g == 0) {
                float* p = d_edge + static_cast<size_t>(j) * f;
#pragma unroll
                for (int t = 0; t < FMAX; ++t)
                  if (t < f) p[t] = b == 0 ? part[t] : p[t] + part[t];
              }
            }
          } else if (d_edge != nullptr && active) {
            store_f32<V>(d_edge + static_cast<size_t>(j) * hd + c0, de, b > 0);
          }
          kc = kn;
          vc = vn;
          ec = en;
#pragma unroll
          for (int t = 0; t < FMAX; ++t)
            if (t < f) ac[t] = an[t];
        }
      }
      if (active) store_vec<T, V>(dq + row, dqv);
    }
  }

  if (FUSE_EDGE && dw_part != nullptr) {
    // the groups' dW and dbias columns summed in group order in shared
    // memory (W's copy is no longer read), then one partial row per block
    float* red = wsm;
    __syncthreads();
    for (int gi = 0; gi < groups; ++gi) {
      if (group == gi && active) {
#pragma unroll
        for (int t = 0; t < FMAX; ++t)
          if (t < f)
#pragma unroll
            for (int x = 0; x < V; ++x) {
              float* p = red + static_cast<size_t>(t) * hd + c0 + x;
              *p = gi == 0 ? dw_acc[t][x] : *p + dw_acc[t][x];
            }
#pragma unroll
        for (int x = 0; x < V; ++x) {
          float* p = red + static_cast<size_t>(f) * hd + c0 + x;
          *p = gi == 0 ? db_acc[x] : *p + db_acc[x];
        }
      }
      __syncthreads();
    }
    float* out = dw_part + static_cast<size_t>(blockIdx.x) * (f + 1) * hd;
    for (int x = threadIdx.x; x < (f + 1) * hd; x += threads) out[x] = red[x];
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

// K3's launch shape for HD, head size d, F edge features and the type's
// element size: V channels a lane (16 bytes, or the head size when that is
// smaller), GS lanes a destination group, the head butterfly's width, the
// block and its shared memory (two exchange buffers per group, plus W and
// bias as float32 on the K1 side, reused for the block's dW sum).
struct DstLayout {
  int v, gs, seg, threads;
  size_t smem;
};

DstLayout dst_layout(int elt, int hd, int d, int f, bool fuse_edge) {
  DstLayout l;
  const int vmax = 16 / elt;
  l.v = d >= vmax ? vmax : (d >= 4 ? 4 : 1);
  const int lanes = hd / l.v;
  if (lanes <= 32) {
    l.gs = 1;
    while (l.gs < lanes) l.gs *= 2;
  } else {
    l.gs = (lanes + 31) / 32 * 32;
  }
  l.threads = l.gs <= kDstThreads ? l.gs * (kDstThreads / l.gs) : l.gs;
  const int lh = d / l.v;
  l.seg = lh & -lh;
  if (l.seg > 32) l.seg = 32;
  l.smem = (4 * static_cast<size_t>(l.threads) + (fuse_edge ? (f + 1) * static_cast<size_t>(hd) : 0)) *
           sizeof(float);
  return l;
}

template <typename T>
using DstKernel = void (*)(const T*, const T*, const T*, const T*, const float*, const float*,
                           const int*, const int*, const T*, const T*, const T*, T*, T*, float*,
                           float*, int, int, int, int, int, int, int, long long, long long, float,
                           int, int);

template <typename T, int V>
DstKernel<T> dst_kernel_v(bool fuse_edge, int f) {
  if (!fuse_edge) return gt_attention_bwd_dst_kernel<T, V, false, 1>;
  return f <= 4 ? gt_attention_bwd_dst_kernel<T, V, true, 4>
                : gt_attention_bwd_dst_kernel<T, V, true, kMaxEdgeFeatures>;
}

// The instantiation of K3 for a layout: V = 16 bytes, 4 or 1; FMAX = 4 or 8.
template <typename T>
DstKernel<T> dst_kernel(const DstLayout& l, bool fuse_edge, int f) {
  constexpr int kVmax = 16 / static_cast<int>(sizeof(T));
  if (l.v == kVmax) return dst_kernel_v<T, kVmax>(fuse_edge, f);
  if (l.v == 4) return dst_kernel_v<T, 4>(fuse_edge, f);
  return dst_kernel_v<T, 1>(fuse_edge, f);
}

template <typename T>
cudaError_t prepare_dst(DstKernel<T> kernel, const DstLayout& l) {
  if (l.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(l.smem));
}

template <typename T>
int dst_blocks_per_sm(int hd, int d, int f, bool fuse_edge) {
  const DstLayout l = dst_layout(sizeof(T), hd, d, f, fuse_edge);
  const DstKernel<T> kernel = dst_kernel<T>(l, fuse_edge, f);
  int n = 0;
  if (prepare_dst<T>(kernel, l) == cudaSuccess)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, l.threads, l.smem);
  return n;
}

// Launches K3 with at most `blocks` blocks (fewer when the groups of fewer
// cover every destination); returns the grid, the row count of dw_part.
template <typename T>
int launch_dst(bool fuse_edge, const void* q, const void* k, const void* v, const void* g,
               const float* lse, const float* delta, const int* src, const int* dst_ptr,
               const void* edge, const void* w, const void* bias, void* dq, void* dkv,
               float* d_edge, float* dw_part, int batch, int n_dst, int n_src, int n_edges, int hd,
               int d, int f, long long w_sf, long long w_sc, float scale, int blocks,
               cudaStream_t stream) {
  const DstLayout l = dst_layout(sizeof(T), hd, d, f, fuse_edge);
  const DstKernel<T> kernel = dst_kernel<T>(l, fuse_edge, f);
  const int groups = l.threads / l.gs;
  const int needed = (n_dst + groups - 1) / groups;
  const int grid = needed < blocks ? needed : blocks;
  if (prepare_dst<T>(kernel, l) != cudaSuccess) return grid;  // cudaGetLastError reports it
  kernel<<<grid, l.threads, l.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, delta, src, dst_ptr, static_cast<const T*>(edge),
      static_cast<const T*>(w), static_cast<const T*>(bias), static_cast<T*>(dq),
      static_cast<T*>(dkv), d_edge, fuse_edge ? dw_part : nullptr, batch, n_dst, n_src, n_edges,
      hd, d, fuse_edge ? f : 0, w_sf, w_sc, scale, l.gs, l.seg);
  return grid;
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
extern "C" int gt_attention_bwd_dst_blocks(int dtype, int fuse_edge, int hd, int num_heads, int f,
                                           int* blocks) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int d = hd / num_heads;
  int per_sm = 0;
  if (dtype == 0)
    per_sm = dst_blocks_per_sm<float>(hd, d, f, fuse_edge != 0);
  else if (dtype == 1)
    per_sm = dst_blocks_per_sm<__nv_bfloat16>(hd, d, f, fuse_edge != 0);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(cudaGetLastError());
}

// K3 (+ its dW finalize when dw is given).  dkv, d_edge, dw_part/dw/db may be
// null; dw_part holds at least min(n_dst, blocks) rows.
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
  int grid = 0;
  if (n_dst > 0 && batch > 0) {
    if (dtype == 0)
      grid = launch_dst<float>(fuse_edge != 0, q, k, v, g, l, dl, s, p, edge, w, bias, dq, dkv,
                               de, part, batch, n_dst, n_src, n_edges, hd, d, f, w_sf, w_sc,
                               scale, blocks, st);
    else if (dtype == 1)
      grid = launch_dst<__nv_bfloat16>(fuse_edge != 0, q, k, v, g, l, dl, s, p, edge, w, bias,
                                       dq, dkv, de, part, batch, n_dst, n_src, n_edges, hd, d, f,
                                       w_sf, w_sc, scale, blocks, st);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (fuse_edge != 0 && dw != nullptr) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n = (f + 1) * hd;
    gt_attention_bwd_dw_finalize_kernel<<<(n + 31) / 32, 32 * kFinalizeWarps, 0, st>>>(
        part, grid, f, hd, static_cast<float*>(dw), static_cast<float*>(db));
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
