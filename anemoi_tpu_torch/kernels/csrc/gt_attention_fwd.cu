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
// Its bound is bytes: each launch reads q, k and v once, the CSR and the edge
// input, and writes out and lse; it does about 9 float32 operations per edge
// and channel (2F more for K1's projection), far below the ~295 flop/byte at
// which an H100 turns compute-bound.  Every per-edge
// intermediate stays out of device memory: k_j + e_ij, v_j + e_ij and the
// logits live in registers, and K1 never forms the projected [E, HD] edge
// tensor (F, the raw edge width, is 3 in the flagship).
//
// Design (the group layout of K3, gt_attention_bwd.cu; all arithmetic
// float32, each output rounded once on its store):
//   - a block of 256 threads holds 256 / GS destination groups (gt::dst_layout:
//     4 at bf16 HD = 512, 2 at HD = 1024).  Lane l of a group owns V channels
//     (V * sizeof(T) = 16 bytes: 8 bf16 or 4 float32; 4 or 1 when the head is
//     smaller) and reads q and every k, v (and K2's e) row, and writes out,
//     as one vector each.  The grid is the card's resident blocks (SMs x
//     occupancy) per batch row, and each group strides over destinations,
//     loading the next destination's edge range and q row while it walks
//     this one's edges;
//   - the k, v (and e) rows of kStages edges are in flight at once: the group
//     copies them with cp.async into its own ring in shared memory, kStages - 1
//     edges ahead of the arithmetic, and each lane reads back only the 16
//     bytes it copied, so the ring needs no barrier.  Edge sources are read 32
//     at a time, one a lane, and spread by shuffles; an edge's F raw
//     attributes are read by every lane from the same address;
//   - K1's W and bias sit in shared memory as float32, staged once per block
//     (the kernel's only block barrier), so an edge's projection is
//     (F + 1) x V / 4 float4 reads and F x V FMAs a lane;
//   - a head's dot product is V FMAs and log2(d / V) shuffles (2 at bf16 d =
//     32, 3 at d = 64); a head wider than 32 lanes, or of a width that is not
//     a power of two, adds one exchange of partial sums through the group's
//     shared memory behind a barrier of the group's own warps (`bar.sync id,
//     n`).  A group of whole warps names the full shuffle mask as a constant;
//   - the online softmax in base 2 (log2(e) / sqrt(d) folded into q): each
//     lane keeps its head's running max and denominator as one float each, 2
//     exponentials (ex2.approx) a lane per edge, and V numerators; lse is
//     written in the natural log;
//   - a destination with no incoming edges gets out = 0 and lse = -inf.
// What limits it on the card (PERF.md §6) is not bytes but the
// instructions each edge issues: more resident warps and deeper prefetch
// moved it little, fewer instructions an edge moved it most.
// The TPU kernel's slot/page tables, one-hot matmul gathers and
// ln2-quantised mean shift are artefacts of Mosaic lacking a row gather and
// do not appear.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

#include "gt_common.cuh"

namespace {

using gt::cp_async;
using gt::cp_async_commit;
using gt::cp_async_wait;
using gt::DstLayout;
using gt::dst_layout;
using gt::exp2_approx;
using gt::kDstThreads;
using gt::load_f32;
using gt::store_vec;
using gt::to_float;
using gt::Vec;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kStages = 4;  // edges of a group whose rows are in flight at once

// Bytes of the per-group rings: kStages slots of the k and v rows (and K2's
// e row), V elements a lane.
constexpr size_t ring_bytes(int threads, int v, int elt, bool fuse_edge) {
  return static_cast<size_t>(kStages) * (fuse_edge ? 2 : 3) * threads * v * elt;
}

// K1 (FUSE_EDGE) and K2.  Lanes past HD / V take part in the group's
// shuffles and barriers and are masked out of loads and stores.  At most 80
// registers a thread, so that three blocks fit an SM: bf16 K1 at the
// flagship's shape takes 78, no spills, and timed the same under a bound of
// 2 blocks (PERF.md §6; at 4 blocks an earlier design spilled and ran
// 1.4-1.8x slower).  One block with room for 8 edge features, and at V = 1,
// whose groups may span 1024 threads (HD = 1024 at d < 4).
template <typename T, int V, bool FUSE_EDGE, int FMAX>
__global__ void __launch_bounds__(V == 1 ? 1024 : kDstThreads, V == 1 || FMAX > 4 ? 1 : 3)
    gt_attention_fwd_kernel(
        const T* __restrict__ q,          // [B, Nd, HD]
        const T* __restrict__ k,          // [B, Ns, HD]
        const T* __restrict__ v,          // [B, Ns, HD]
        const int* __restrict__ src,      // [E] source of each dst-sorted edge
        const int* __restrict__ dst_ptr,  // [Nd + 1]
        const T* __restrict__ edge,       // K2: e [E, HD]; K1: raw attributes [E, F]
        const T* __restrict__ w,          // K1: W, element (t, c) at t*w_sf + c*w_sc
        const T* __restrict__ bias,       // K1: [HD]
        T* __restrict__ out,              // [B, Nd, HD]
        float* __restrict__ lse,          // [B, Nd, H]
        int n_dst, int n_src, int hd, int d, int f, long long w_sf, long long w_sc,
        float q_scale, int gs, int seg) {
  extern __shared__ float4 smem4[];
  constexpr int kRows = FUSE_EDGE ? 2 : 3;  // rows a ring slot holds: k, v (and e)
  // shared memory: each group's ring, [kStages][kRows][gs] vectors of V
  // elements; K1's W as [F, HD] then bias, float32; each group's exchange
  // buffers, [2][gs] floats used in turn
  T* rings = reinterpret_cast<T*>(smem4);
  float* wsm =
      reinterpret_cast<float*>(rings + static_cast<size_t>(kStages) * kRows * blockDim.x * V);
  gt::Group<true> grp(V, gs, seg, hd, d, wsm + (FUSE_EDGE ? (f + 1) * hd : 0), 1);
  const int groups = blockDim.x / gs;
  const int b = blockIdx.y;
  const int lane_g = grp.lane_g;
  const bool active = grp.active;
  const int c0 = grp.c0;
  T* ring = rings + static_cast<size_t>(grp.id) * kStages * kRows * gs * V;

  if constexpr (FUSE_EDGE) {
    for (int x = threadIdx.x; x < (f + 1) * hd; x += blockDim.x) {
      const int t = x / hd, c = x - t * hd;
      wsm[x] = to_float(t < f ? w[t * w_sf + c * w_sc] : bias[c]);
    }
    __syncthreads();  // once, before any destination
  }
  const T* kb = k + static_cast<size_t>(b) * n_src * hd + c0;
  const T* vb = v + static_cast<size_t>(b) * n_src * hd + c0;

  // the group's destinations stride by `step`; the next one's edge range
  // and q row are loaded while this one's edges are walked
  const int step = gridDim.x * groups;
  int beg_n = 0, end_n = 0;
  Vec<T, V> q_n;
  q_n.zero();
  auto prefetch = [&](int i) {
    if (i < n_dst) {
      beg_n = dst_ptr[i];
      end_n = dst_ptr[i + 1];
      if (active) q_n.load(q + (static_cast<size_t>(b) * n_dst + i) * hd + c0);
    }
  };
  prefetch(blockIdx.x * groups + grp.id);
  for (int i = blockIdx.x * groups + grp.id; i < n_dst; i += step) {
    const size_t row = (static_cast<size_t>(b) * n_dst + i) * hd + c0;
    const int beg = beg_n;
    const int end = end_n;
    float qf[V];  // q * log2(e) / sqrt(d): the logits come out in base 2
#pragma unroll
    for (int x = 0; x < V; ++x) qf[x] = q_n.get(x) * q_scale;
    prefetch(i + step);

    float m = -CUDART_INF_F;  // running max of the head's logits
    float l = 0.f;            // running denominator
    float acc[V] = {};        // running numerators of the lane's channels
    if (end > beg) {
      // edges are copied kStages - 1 ahead of the one whose arithmetic runs;
      // the copies take their sources from s_chunk, refilled 32 edges (one a
      // lane) at a time
      const int cl = grp.cl;
      int s_chunk = beg + cl < end ? src[beg + cl] : 0;  // this lane's edge's source
      int lead = beg;  // the next edge to copy
      auto issue = [&]() {  // copies of edge `lead` (if any) into its slot, as one group
        if (lead < end) {
          const int o = (lead - beg) & (grp.chunk - 1);
          if (o == 0 && lead != beg) s_chunk = lead + cl < end ? src[lead + cl] : 0;
          const int s = grp.shfl(s_chunk, grp.base + o);
          if (active) {
            T* slot = ring + static_cast<size_t>((lead - beg) & (kStages - 1)) * kRows * gs * V;
            cp_async<T, V>(slot + lane_g * V, kb + static_cast<size_t>(s) * hd);
            cp_async<T, V>(slot + (gs + lane_g) * V, vb + static_cast<size_t>(s) * hd);
            if (!FUSE_EDGE)
              cp_async<T, V>(slot + (2 * gs + lane_g) * V,
                             edge + static_cast<size_t>(lead) * hd + c0);
          }
        }
        cp_async_commit();
        ++lead;
      };
#pragma unroll
      for (int t = 0; t < kStages - 1; ++t) issue();
      for (int j = beg; j < end; ++j) {
        issue();         // edge j + kStages - 1
        float a[FMAX];   // K1: edge j's raw attributes, the same for every lane
        if constexpr (FUSE_EDGE) {
#pragma unroll
          for (int t = 0; t < FMAX; ++t)
            a[t] = t < f ? to_float(__ldg(edge + static_cast<size_t>(j) * f + t)) : 0.f;
        }
        cp_async_wait<kStages - 1>();  // edge j's rows have landed (this lane's copies)
        const T* slot = ring + static_cast<size_t>((j - beg) & (kStages - 1)) * kRows * gs * V;
        Vec<T, V> kc, vc;
        kc.load_shared(slot + lane_g * V);
        vc.load_shared(slot + (gs + lane_g) * V);
        float e[V];
        if constexpr (FUSE_EDGE) {
          load_f32<V>(wsm + static_cast<size_t>(f) * hd + c0, e);
#pragma unroll
          for (int t = 0; t < FMAX; ++t) {
            if (t < f) {
              float wr[V];
              load_f32<V>(wsm + static_cast<size_t>(t) * hd + c0, wr);
#pragma unroll
              for (int x = 0; x < V; ++x) e[x] += a[t] * wr[x];
            }
          }
        } else {
          Vec<T, V> ec;
          ec.load_shared(slot + (2 * gs + lane_g) * V);
#pragma unroll
          for (int x = 0; x < V; ++x) e[x] = ec.get(x);
        }
        float dot[1] = {0.f};
#pragma unroll
        for (int x = 0; x < V; ++x) dot[0] += qf[x] * (kc.get(x) + e[x]);
        grp.head_sums(dot);
        const float logit = dot[0];
        const float m_new = fmaxf(m, logit);
        const float corr = exp2_approx(m - m_new);
        const float p = exp2_approx(logit - m_new);
        l = l * corr + p;
#pragma unroll
        for (int x = 0; x < V; ++x) acc[x] = acc[x] * corr + p * (vc.get(x) + e[x]);
        m = m_new;
      }
    }
    if (active) {
      float o[V];
#pragma unroll
      for (int x = 0; x < V; ++x) o[x] = l > 0.f ? acc[x] / l : 0.f;
      store_vec<T, V>(out + row, o);
      if (c0 % d == 0)
        lse[(static_cast<size_t>(b) * n_dst + i) * (hd / d) + c0 / d] =
            l > 0.f ? (m + log2f(l)) * kLn2 : -CUDART_INF_F;
    }
  }
}

template <typename T, int V, bool FUSE_EDGE, int FMAX>
struct FwdKernel {  // for gt::group_kernel
  static auto get() { return gt_attention_fwd_kernel<T, V, FUSE_EDGE, FMAX>; }
};

// The block's shared memory: the rings, K1's W and bias, and two exchange
// buffers of one float a lane for heads wider than `seg`.
size_t fwd_smem(const DstLayout& l, int hd, int d, int f, int elt, bool fuse_edge) {
  return ring_bytes(l.threads, l.v, elt, fuse_edge) +
         (fuse_edge ? (f + 1) * static_cast<size_t>(hd) * sizeof(float) : 0) +
         (l.seg < d / l.v ? 2 * static_cast<size_t>(l.threads) * sizeof(float) : 0);
}

template <typename T>
int fwd_blocks_per_sm(int hd, int d, int f, bool fuse_edge) {
  const DstLayout l = dst_layout(sizeof(T), hd, d);
  return gt::blocks_per_sm(gt::group_kernel<FwdKernel, T>(l, fuse_edge, f), l.threads,
                           fwd_smem(l, hd, d, f, sizeof(T), fuse_edge));
}

// Launches with at most `blocks` blocks a batch row (fewer when the groups
// of fewer cover every destination); each group strides over destinations.
template <typename T>
void launch(bool fuse_edge, const void* q, const void* k, const void* v, const int* src,
            const int* dst_ptr, const void* edge, const void* w, const void* bias, void* out,
            float* lse, int batch, int n_dst, int n_src, int hd, int d, int f, long long w_sf,
            long long w_sc, float scale, int blocks, cudaStream_t stream) {
  const DstLayout l = dst_layout(sizeof(T), hd, d);
  const auto kernel = gt::group_kernel<FwdKernel, T>(l, fuse_edge, f);
  const int groups = l.threads / l.gs;
  const int needed = (n_dst + groups - 1) / groups;
  const dim3 grid(needed < blocks ? needed : blocks, batch);
  const size_t smem = fwd_smem(l, hd, d, f, sizeof(T), fuse_edge);
  if (gt::prepare_smem(kernel, smem) != cudaSuccess) return;  // cudaGetLastError reports it
  kernel<<<grid, l.threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), src, dst_ptr,
      static_cast<const T*>(edge), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(out), lse, n_dst, n_src, hd, d, fuse_edge ? f : 0, w_sf, w_sc,
      scale * kLog2e, l.gs, l.seg);
}

}  // namespace

// Plain C entry points (bound with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// Shapes, types and alignment are validated by the Python wrapper.  Each
// returns the cudaError_t of its calls (0 on success).

// Blocks of K1/K2 that fit on the current card at once (SMs x occupancy):
// the grid's width.
extern "C" int gt_attention_fwd_blocks(int dtype, int fuse_edge, int hd, int num_heads, int f,
                                       int* blocks) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int d = hd / num_heads;
  int per_sm = 0;
  if (dtype == 0)
    per_sm = fwd_blocks_per_sm<float>(hd, d, f, fuse_edge != 0);
  else if (dtype == 1)
    per_sm = fwd_blocks_per_sm<__nv_bfloat16>(hd, d, f, fuse_edge != 0);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(cudaGetLastError());
}

// K1 (fuse_edge) or K2, with at most `blocks` blocks a batch row.
extern "C" int gt_attention_fwd(int dtype, int fuse_edge, const void* q, const void* k,
                                const void* v, const void* src, const void* dst_ptr,
                                const void* edge, const void* w, const void* bias, void* out,
                                void* lse, int batch, int n_dst, int n_src, int hd,
                                int num_heads, int f, long long w_sf, long long w_sc,
                                float scale, int blocks, void* stream) {
  const int d = hd / num_heads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* s = static_cast<const int*>(src);
  const int* p = static_cast<const int*>(dst_ptr);
  float* l = static_cast<float*>(lse);
  if (n_dst > 0 && batch > 0) {
    if (dtype == 0)
      launch<float>(fuse_edge != 0, q, k, v, s, p, edge, w, bias, out, l, batch, n_dst, n_src, hd,
                    d, f, w_sf, w_sc, scale, blocks, st);
    else if (dtype == 1)
      launch<__nv_bfloat16>(fuse_edge != 0, q, k, v, s, p, edge, w, bias, out, l, batch, n_dst,
                            n_src, hd, d, f, w_sf, w_sc, scale, blocks, st);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
