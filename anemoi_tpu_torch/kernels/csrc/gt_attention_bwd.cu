// Sparse graph-transformer attention, backward (kernels K3, K4 and K5).
//
// Replaces the TPU kernels of anemoi_tpu/ops/pallas/paged_gt.py:
//   K3  _bwd_kernel           -> gt_attention_bwd_dst_kernel (destination pass)
//   K4  _reduce_kernel        -> gt_attention_bwd_src_sum_kernel (source pass)
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
//     occupancy).
//   - K4 and K5 walk a source's edges through the source-ordered view
//     (src_ptr, src_perm: the edge ids sorted by source, stable by
//     destination), so each dk, dv row is written by one walk: no atomics,
//     deterministic; a source without edges writes dk = dv = 0 and reads no
//     dkv row.  Both take K3's groups of 16-byte lanes, one source a group,
//     the card's resident blocks striding over the sources (K4 from a mean
//     out-degree of 4 launches one group a source instead).  K4 is a pure
//     gather-sum, bound by the dkv rows it reads and the dk, dv rows it
//     writes: the batch row folds into its stride, the next source's edge
//     range and first 32 edge ids are in flight while this one is summed,
//     and the dkv rows of kSumEdges edges are loaded into registers before
//     the first of them is added (its own comment below).  K5's q and g rows
//     (and e rows) are in flight kStages edges at a time through a cp.async
//     ring, as in K1 (gt_attention_fwd.cu; K5's own comment below).
//   - The TPU kernels' slot/page tables and one-hot matmul gathers are
//     artefacts of Mosaic lacking a row gather and do not appear.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "gt_common.cuh"

namespace {

using gt::blocks_per_sm;
using gt::cp_async;
using gt::cp_async_commit;
using gt::cp_async_wait;
using gt::DstLayout;
using gt::dst_layout;
using gt::exp2_approx;
using gt::group_kernel;
using gt::prepare_smem;
using gt::kDstThreads;
using gt::load_f32;
using gt::store_vec;
using gt::to_float;
using gt::Vec;

constexpr int kFinalizeWarps = 8;

// ---- K3: the destination pass ---------------------------------------------

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
// warps (gt::dst_layout and gt::Group, shared with K1 and K5).  A head spans
// lh = d / V lanes; its dot products are V FMAs and gt::Group::head_sums: a
// butterfly over `seg` lanes (the largest power of two dividing lh, at most
// 32), plus, when a head is wider than that (lh > 32, or lh not a power of
// two), one barrier of the group's lanes and a sum of the segments' partials
// through the group's two exchange buffers in shared memory.  K3 takes the
// group with its mask in a register and the butterfly as a loop
// (Group<false>): at its register cap, the literal mask's second shuffle
// path spilled more and ran 1.5-3.5 % slower on an H100.  Two blocks an SM
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
  float* smem = reinterpret_cast<float*>(smem4);  // the groups' exchange buffers, then:
  const int threads = blockDim.x;
  float* wsm = smem + 4 * threads;  // K1 side: W as [F, HD] then bias, float32
  gt::Group<false> grp(V, gs, seg, hd, d, smem, 2);
  const int groups = threads / gs;
  const int group = grp.id;
  const int lane_g = grp.lane_g;
  const int base = grp.base;
  const int chunk = grp.chunk;
  const int cl = grp.cl;
  const bool active = grp.active;
  const int c0 = grp.c0;
  const int n_heads = hd / d;
  const int head = c0 / d;

  if (FUSE_EDGE) {
    for (int x = threadIdx.x; x < (f + 1) * hd; x += threads) {
      const int t = x / hd, c = x - t * hd;
      wsm[x] = to_float(t < f ? w[t * w_sf + c * w_sc] : bias[c]);
    }
    __syncthreads();
  }

  // part[0..f) summed over all lanes of the group, returned to every lane
  // (through the exchange buffers of grp.head_sums, in the same turns)
  auto group_sum = [&](float (&part)[FMAX]) {
    const int width = gs < 32 ? gs : 32;
#pragma unroll
    for (int t = 0; t < FMAX; ++t)
      if (t < f)
        for (int off = width >> 1; off > 0; off >>= 1) part[t] += grp.shfl_xor(part[t], off);
    if (gs > 32) {
      float* buf = grp.scratch + grp.parity * 2 * gs;
      grp.parity ^= 1;
      if ((lane_g & 31) == 0)
#pragma unroll
        for (int t = 0; t < FMAX; ++t)
          if (t < f) buf[(lane_g >> 5) * FMAX + t] = part[t];
      grp.sync();
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
        load_edge(beg, grp.shfl(s_chunk, base), kc, vc, ec, ac);
        for (int j = beg; j < end; ++j) {
          if (j + 1 < end) {
            const int o = (j + 1 - beg) & (chunk - 1);
            if (o == 0) s_chunk = j + 1 + cl < end ? src[j + 1 + cl] : 0;
            load_edge(j + 1, grp.shfl(s_chunk, base + o), kn, vn, en, an);
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
          float sums[2] = {0.f, 0.f};  // the head's logit and g . v_eff
#pragma unroll
          for (int x = 0; x < V; ++x) {
            kf[x] = kc.get(x) + e[x];
            sums[0] += qr.get(x) * kf[x];
            sums[1] += gr.get(x) * (vc.get(x) + e[x]);
          }
          grp.head_sums(sums);
          const float alpha = active ? expf(sums[0] * scale - lse_h) : 0.f;
          const float dl = active ? alpha * (sums[1] - delta_h) * scale : 0.f;
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

// ---- K4: the source pass ---------------------------------------------------

constexpr int kSumEdges = 4;  // K4: edges of a source whose dkv rows are loaded before any is added

// K4's group shape: K3's (gt::dst_layout) for one head of HD channels, with
// the head size taken as the largest power of two dividing HD, so that V (16
// bytes, else 4 or 1 channels) divides HD.
DstLayout src_sum_layout(int elt, int hd) { return dst_layout(elt, hd, hd & -hd); }

// K4.  Work item w is source s = w % Ns of batch row w / Ns; the grid's
// groups stride over the items (the resident blocks, or one group an item
// at a high mean out-degree: launch_src_sum).  A group of GS lanes sums one item:
// lane l owns channels [lV, lV + V) of the dk half and of the dv half of each
// dkv row [B, E, 2HD] (K3's per-edge dk_eff | dv_eff), and reads and writes
// each as one vector.  What would otherwise be a chain of dependent loads a
// source (src_ptr, then src_perm, then the rows) is pipelined over the
// group's items: while item w is summed, the edge range of item w + 2 step
// and the first chunk of edge ids of item w + step are in flight.  Edge ids
// come in chunks of up to 32, one a lane, spread to the group by shuffles
// (no barrier: a group of whole warps runs each warp on its own); the two
// row vectors of kSumEdges edges are loaded into registers before the first
// of them is added, so a lane has 2 kSumEdges 16-byte loads in flight.  The
// sums are float32 in src_perm order (stable by destination), each output
// rounded once at its store; an item without edges stores zeros and reads
// no dkv row.  No atomics: bitwise repeatable, and equal to a serial float32
// sum in src_perm order.  Lanes past HD / V take part in the shuffles only.
// Three blocks an SM (at most 85 registers a thread: at four, bf16 V = 8
// spilled 92 bytes at its 64-register cap and ran 1.26-1.38x slower on an
// H100, PERF.md section 6), except at V = 1 (HD not a multiple of 4), whose
// groups may span 1024 threads.
template <typename T, int V>
__global__ void __launch_bounds__(V == 1 ? 1024 : kDstThreads, V == 1 ? 1 : 3)
    gt_attention_bwd_src_sum_kernel(
        const T* __restrict__ dkv,         // [B, E, 2HD]
        const int* __restrict__ src_ptr,   // [Ns + 1]
        const int* __restrict__ src_perm,  // [E] edge ids sorted by source
        T* __restrict__ dk,                // [B, Ns, HD]
        T* __restrict__ dv,                // [B, Ns, HD]
        int n_src, int n_edges, int hd, int work, int gs) {
  gt::Group<true> grp(V, gs, 1, hd, V, nullptr, 0);
  const int groups = blockDim.x / gs;
  const int base = grp.base;
  const int chunk = grp.chunk;
  const int cl = grp.cl;
  const bool active = grp.active;
  const int c0 = grp.c0;
  const int step = gridDim.x * groups;

  // item w's edge range in src_perm (empty past the last item)
  auto range = [&](int w, int& beg, int& end) {
    beg = end = 0;
    if (w < work) {
      const int s = w % n_src;
      beg = src_ptr[s];
      end = src_ptr[s + 1];
    }
  };
  // the first chunk of a range's edge ids, one a lane
  auto first_ids = [&](int beg, int end) { return cl < end - beg ? src_perm[beg + cl] : 0; };

  int w = blockIdx.x * groups + grp.id;
  int beg, end, beg_n, end_n;
  range(w, beg, end);
  int j_c = first_ids(beg, end);
  range(w + step, beg_n, end_n);
  for (; w < work; w += step) {
    const int j_n = first_ids(beg_n, end_n);
    int beg_nn, end_nn;
    range(w + 2 * step, beg_nn, end_nn);
    const int b = w / n_src;
    const int s = w - b * n_src;
    const T* rows = dkv + static_cast<size_t>(b) * n_edges * 2 * hd + c0;
    float ak[V] = {};
    float av[V] = {};
    for (int c = beg; c < end; c += chunk) {
      const int n = end - c < chunk ? end - c : chunk;  // edges of this chunk
      if (c > beg) j_c = cl < n ? src_perm[c + cl] : 0;
      for (int o = 0; o < n; o += kSumEdges) {
        Vec<T, V> kr[kSumEdges], vr[kSumEdges];
#pragma unroll
        for (int u = 0; u < kSumEdges; ++u) {
          const int j = grp.shfl(j_c, base + (o + u < n ? o + u : 0));
          kr[u].zero();
          vr[u].zero();
          if (active && o + u < n) {
            const T* r = rows + static_cast<size_t>(j) * 2 * hd;
            kr[u].load(r);
            vr[u].load(r + hd);
          }
        }
#pragma unroll
        for (int u = 0; u < kSumEdges; ++u) {
          if (o + u < n) {
#pragma unroll
            for (int x = 0; x < V; ++x) {
              ak[x] += kr[u].get(x);
              av[x] += vr[u].get(x);
            }
          }
        }
      }
    }
    if (active) {
      const size_t o = (static_cast<size_t>(b) * n_src + s) * hd + c0;
      store_vec<T, V>(dk + o, ak);
      store_vec<T, V>(dv + o, av);
    }
    beg = beg_n;
    end = end_n;
    j_c = j_n;
    beg_n = beg_nn;
    end_n = end_nn;
  }
}

// ---- K5: the fused source pass ---------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 4;  // edges of a source group whose gathered rows are in flight at once

// K5.  A source is walked by a group of GS lanes laid out as K3's
// destination groups (gt::dst_layout, gt::Group): lane l owns channels
// [lV, lV + V) of k_s, v_s, dk_s and dv_s and of every gathered q_i, g_i (and
// e_ij) row, each moved as one vector.  The grid is the card's resident
// blocks a batch row (the grid's y), and each group strides over sources,
// loading the next source's edge range and k, v rows while it walks this
// one's edges.  A source's edges (src_perm order) come in chunks of up to
// 32: lane c reads the chunk's c-th edge id j, its destination i = dst[j]
// (and, K1 side, its F raw attributes), spread to the group by shuffles.
// The q_i and g_i rows (and K2 side's e_ij row) and the head's lse_i and
// delta_i of kStages edges are in flight at once: the group copies them with
// cp.async into its own ring in shared memory, and each lane reads back only
// what it copied, so the ring needs no barrier.  A head's two dot products
// are V FMAs each and gt::Group::head_sums.  alpha is formed in base 2
// (log2 e folded into the scale), dl without its factor 1/sqrt(d), which the
// store applies.  Each lane sums its channels of dk_s and dv_s in float32
// registers over the source's edges and stores them once; a source without
// edges writes zeros.  No atomics: bitwise repeatable.  K1 side's W and bias
// are staged once a block in shared memory as float32 (the kernel's only
// block barrier); the bias is folded into k_s and v_s.  Two blocks an SM (at
// most 128 registers a thread), except with room for 8 edge features and at
// V = 1, whose groups may span 1024 threads.  On the card (PERF.md §6),
// neither an 8-edge ring nor gathers through L1 moved it by more than 2 %,
// and lanes of 32 bytes ran 16-20 % slower.
template <typename T, int V, bool FUSE_EDGE, int FMAX>
__global__ void __launch_bounds__(V == 1 ? 1024 : kDstThreads, V == 1 || FMAX > 4 ? 1 : 2)
    gt_attention_bwd_src_fused_kernel(
        const T* __restrict__ q,           // [B, Nd, HD]
        const T* __restrict__ k,           // [B, Ns, HD]
        const T* __restrict__ v,           // [B, Ns, HD]
        const T* __restrict__ g,           // [B, Nd, HD]
        const float* __restrict__ lse,     // [B, Nd, H]
        const float* __restrict__ delta,   // [B, Nd, H]
        const int* __restrict__ dst,       // [E] destination of each dst-sorted edge
        const int* __restrict__ src_ptr,   // [Ns + 1]
        const int* __restrict__ src_perm,  // [E] edge ids sorted by source
        const T* __restrict__ edge,        // K2 side: e [E, HD]; K1 side: raw attributes [E, F]
        const T* __restrict__ w,           // K1 side: W, element (t, c) at t*w_sf + c*w_sc
        const T* __restrict__ bias,        // K1 side: [HD]
        T* __restrict__ dk,                // [B, Ns, HD]
        T* __restrict__ dv,                // [B, Ns, HD]
        int n_dst, int n_src, int hd, int d, int f, long long w_sf, long long w_sc, float scale,
        int gs, int seg) {
  extern __shared__ float4 smem4[];
  constexpr int kRows = FUSE_EDGE ? 2 : 3;  // rows a ring slot holds: q, g (and e)
  // shared memory: each group's ring, [kStages][kRows][gs] vectors of V
  // elements; each group's (lse, delta) slots, [kStages][gs]; each group's
  // exchange buffers, [2][2 * gs] floats used in turn (heads wider than seg
  // only); K1 side's W as [F, HD] then bias, float32
  float2* stats_all = reinterpret_cast<float2*>(
      reinterpret_cast<T*>(smem4) + static_cast<size_t>(kStages) * kRows * blockDim.x * V);
  float* scratch =
      reinterpret_cast<float*>(stats_all + static_cast<size_t>(kStages) * blockDim.x);
  float* wsm = scratch + (seg < d / V ? 4 * blockDim.x : 0);
  gt::Group<true> grp(V, gs, seg, hd, d, scratch, 2);
  const int groups = blockDim.x / gs;
  const int b = blockIdx.y;
  const int base = grp.base;
  const int chunk = grp.chunk;
  const int cl = grp.cl;
  const bool active = grp.active;
  const int c0 = grp.c0;
  const int n_heads = hd / d;
  T* ring = reinterpret_cast<T*>(smem4) + static_cast<size_t>(grp.id) * kStages * kRows * gs * V +
            grp.lane_g * V;
  float2* stats = stats_all + static_cast<size_t>(grp.id) * kStages * gs + grp.lane_g;

  if constexpr (FUSE_EDGE) {
    for (int x = threadIdx.x; x < (f + 1) * hd; x += blockDim.x) {
      const int t = x / hd, c = x - t * hd;
      wsm[x] = to_float(t < f ? w[t * w_sf + c * w_sc] : bias[c]);
    }
    __syncthreads();  // once, before any source
  }
  const float scale2 = scale * kLog2e;  // the logits come out in base 2
  const size_t kv_base = static_cast<size_t>(b) * n_src * hd + c0;
  const T* qb = q + static_cast<size_t>(b) * n_dst * hd + c0;
  const T* gb = g + static_cast<size_t>(b) * n_dst * hd + c0;
  const float* lb = lse + static_cast<size_t>(b) * n_dst * n_heads + c0 / d;
  const float* db = delta + static_cast<size_t>(b) * n_dst * n_heads + c0 / d;

  // the group's sources stride by `step`; the next one's edge range and k,
  // v rows are loaded while this one's edges are walked
  const int step = gridDim.x * groups;
  int beg_n = 0, end_n = 0;
  Vec<T, V> k_n, v_n;
  k_n.zero();
  v_n.zero();
  auto prefetch = [&](int s) {
    if (s < n_src) {
      beg_n = src_ptr[s];
      end_n = src_ptr[s + 1];
      if (active) {
        k_n.load(k + kv_base + static_cast<size_t>(s) * hd);
        v_n.load(v + kv_base + static_cast<size_t>(s) * hd);
      }
    }
  };
  prefetch(blockIdx.x * groups + grp.id);
  for (int s = blockIdx.x * groups + grp.id; s < n_src; s += step) {
    const int beg = beg_n;
    const int end = end_n;
    float kf[V], vf[V];  // k_s and v_s (K1 side: plus the bias)
    if constexpr (FUSE_EDGE) {
      load_f32<V>(wsm + static_cast<size_t>(f) * hd + c0, kf);
    } else {
#pragma unroll
      for (int x = 0; x < V; ++x) kf[x] = 0.f;
    }
#pragma unroll
    for (int x = 0; x < V; ++x) {
      vf[x] = kf[x] + v_n.get(x);
      kf[x] += k_n.get(x);
    }
    prefetch(s + step);

    float ak[V] = {};  // sum of dl q_i, without dl's factor 1/sqrt(d)
    float av[V] = {};  // sum of alpha g_i
    for (int c = beg; c < end; c += chunk) {
      const int n = end - c < chunk ? end - c : chunk;  // edges of this chunk
      // lane cl's edge of the chunk: its id, its destination (and K1 side's
      // raw attributes)
      int j_c = 0, i_c = 0;
      float a_c[FMAX] = {};
      if (cl < n) {
        j_c = src_perm[c + cl];
        i_c = dst[j_c];
        if constexpr (FUSE_EDGE) {
#pragma unroll
          for (int t = 0; t < FMAX; ++t)
            if (t < f) a_c[t] = to_float(edge[static_cast<size_t>(j_c) * f + t]);
        }
      }
      int lead = 0;  // the next edge of the chunk to copy
      auto issue = [&]() {  // copies of edge `lead` (if any) into its slot, as one group
        if (lead < n) {
          const int i = grp.shfl(i_c, base + lead);
          int j = 0;
          if constexpr (!FUSE_EDGE) j = grp.shfl(j_c, base + lead);
          if (active) {
            const int slot = lead & (kStages - 1);
            T* r = ring + static_cast<size_t>(slot) * kRows * gs * V;
            const size_t row = static_cast<size_t>(i) * hd;
            cp_async<T, V>(r, qb + row);
            cp_async<T, V>(r + gs * V, gb + row);
            if constexpr (!FUSE_EDGE)
              cp_async<T, V>(r + 2 * gs * V, edge + static_cast<size_t>(j) * hd + c0);
            float* st = reinterpret_cast<float*>(stats + slot * gs);
            const size_t hrow = static_cast<size_t>(i) * n_heads;
            cp_async<float, 1>(st, lb + hrow);
            cp_async<float, 1>(st + 1, db + hrow);
          }
        }
        cp_async_commit();
        ++lead;
      };
#pragma unroll
      for (int t = 0; t < kStages - 1; ++t) issue();
      for (int o = 0; o < n; ++o) {
        issue();  // edge o + kStages - 1
        float a[FMAX];  // K1 side: edge o's raw attributes
        if constexpr (FUSE_EDGE) {
#pragma unroll
          for (int t = 0; t < FMAX; ++t) a[t] = grp.shfl(a_c[t], base + o);
        }
        cp_async_wait<kStages - 1>();  // edge o's rows have landed (this lane's copies)
        const int slot = o & (kStages - 1);
        const T* r = ring + static_cast<size_t>(slot) * kRows * gs * V;
        Vec<T, V> qc, gc;
        qc.load_shared(r);
        gc.load_shared(r + gs * V);
        const float2 st = stats[slot * gs];  // (lse_i, delta_i) of the lane's head
        float e[V];
        if constexpr (FUSE_EDGE) {
#pragma unroll
          for (int x = 0; x < V; ++x) e[x] = 0.f;
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
          ec.load_shared(r + 2 * gs * V);
#pragma unroll
          for (int x = 0; x < V; ++x) e[x] = ec.get(x);
        }
        float sums[2] = {0.f, 0.f};  // the head's logit and g . v_eff
#pragma unroll
        for (int x = 0; x < V; ++x) {
          sums[0] += qc.get(x) * (kf[x] + e[x]);
          sums[1] += gc.get(x) * (vf[x] + e[x]);
        }
        grp.head_sums(sums);
        const float alpha = exp2_approx(sums[0] * scale2 - st.x * kLog2e);
        const float dl = alpha * (sums[1] - st.y);
#pragma unroll
        for (int x = 0; x < V; ++x) {
          ak[x] += dl * qc.get(x);
          av[x] += alpha * gc.get(x);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int x = 0; x < V; ++x) ak[x] *= scale;
      store_vec<T, V>(dk + kv_base + static_cast<size_t>(s) * hd, ak);
      store_vec<T, V>(dv + kv_base + static_cast<size_t>(s) * hd, av);
    }
  }
}

// K3's shared memory: two exchange buffers of float2 per group, plus W and
// bias as float32 on the K1 side, reused for the block's dW sum.
size_t dst_smem(const DstLayout& l, int hd, int f, bool fuse_edge) {
  const size_t w_floats = fuse_edge ? (f + 1) * static_cast<size_t>(hd) : 0;
  return (4 * static_cast<size_t>(l.threads) + w_floats) * sizeof(float);
}

// K3's and K5's instantiations, for gt::group_kernel
template <typename T, int V, bool FUSE_EDGE, int FMAX>
struct DstKernel {
  static auto get() { return gt_attention_bwd_dst_kernel<T, V, FUSE_EDGE, FMAX>; }
};
template <typename T, int V, bool FUSE_EDGE, int FMAX>
struct SrcFusedKernel {
  static auto get() { return gt_attention_bwd_src_fused_kernel<T, V, FUSE_EDGE, FMAX>; }
};

template <typename T>
int dst_blocks_per_sm(int hd, int d, int f, bool fuse_edge) {
  const DstLayout l = dst_layout(sizeof(T), hd, d);
  return blocks_per_sm(group_kernel<DstKernel, T>(l, fuse_edge, f), l.threads,
                       dst_smem(l, hd, f, fuse_edge));
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
  const DstLayout l = dst_layout(sizeof(T), hd, d);
  const auto kernel = group_kernel<DstKernel, T>(l, fuse_edge, f);
  const size_t smem = dst_smem(l, hd, f, fuse_edge);
  const int groups = l.threads / l.gs;
  const int needed = (n_dst + groups - 1) / groups;
  const int grid = needed < blocks ? needed : blocks;
  if (prepare_smem(kernel, smem) != cudaSuccess) return grid;  // cudaGetLastError reports it
  kernel<<<grid, l.threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, delta, src, dst_ptr, static_cast<const T*>(edge),
      static_cast<const T*>(w), static_cast<const T*>(bias), static_cast<T*>(dq),
      static_cast<T*>(dkv), d_edge, fuse_edge ? dw_part : nullptr, batch, n_dst, n_src, n_edges,
      hd, d, fuse_edge ? f : 0, w_sf, w_sc, scale, l.gs, l.seg);
  return grid;
}

// K5's shared memory: per group a ring of kStages slots, each the q and g
// rows (and K2 side's e row) of one edge, V elements a lane, then the slots'
// (lse, delta) pairs, one a lane; two exchange buffers of float2 a lane for
// heads wider than `seg`; K1 side's W and bias as float32.
size_t src_fused_smem(const DstLayout& l, int hd, int d, int f, int elt, bool fuse_edge) {
  const size_t lanes = static_cast<size_t>(l.threads);
  return kStages * (fuse_edge ? 2 : 3) * lanes * l.v * elt + kStages * lanes * sizeof(float2) +
         (l.seg < d / l.v ? 2 * lanes * sizeof(float2) : 0) +
         (fuse_edge ? (f + 1) * static_cast<size_t>(hd) * sizeof(float) : 0);
}

template <typename T>
int src_fused_blocks_per_sm(int hd, int d, int f, bool fuse_edge) {
  const DstLayout l = dst_layout(sizeof(T), hd, d);
  return blocks_per_sm(group_kernel<SrcFusedKernel, T>(l, fuse_edge, f), l.threads,
                       src_fused_smem(l, hd, d, f, sizeof(T), fuse_edge));
}

// Launches K5 with at most `blocks` blocks a batch row (fewer when the
// groups of fewer cover every source); each group strides over sources.
template <typename T>
void launch_src_fused(bool fuse_edge, const void* q, const void* k, const void* v, const void* g,
                      const float* lse, const float* delta, const int* dst, const int* src_ptr,
                      const int* src_perm, const void* edge, const void* w, const void* bias,
                      void* dk, void* dv, int batch, int n_dst, int n_src, int hd, int d, int f,
                      long long w_sf, long long w_sc, float scale, int blocks,
                      cudaStream_t stream) {
  const DstLayout l = dst_layout(sizeof(T), hd, d);
  const auto kernel = group_kernel<SrcFusedKernel, T>(l, fuse_edge, f);
  const size_t smem = src_fused_smem(l, hd, d, f, sizeof(T), fuse_edge);
  const int groups = l.threads / l.gs;
  const int needed = (n_src + groups - 1) / groups;
  const dim3 grid(needed < blocks ? needed : blocks, batch);
  if (prepare_smem(kernel, smem) != cudaSuccess) return;  // cudaGetLastError reports it
  kernel<<<grid, l.threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), lse, delta, dst, src_ptr, src_perm, static_cast<const T*>(edge),
      static_cast<const T*>(w), static_cast<const T*>(bias), static_cast<T*>(dk),
      static_cast<T*>(dv), n_dst, n_src, hd, d, fuse_edge ? f : 0, w_sf, w_sc, scale, l.gs,
      l.seg);
}

template <typename T>
auto src_sum_kernel(const DstLayout& l) {
  constexpr int kVmax = 16 / static_cast<int>(sizeof(T));
  if (l.v == kVmax) return gt_attention_bwd_src_sum_kernel<T, kVmax>;
  if (l.v == 4) return gt_attention_bwd_src_sum_kernel<T, 4>;
  return gt_attention_bwd_src_sum_kernel<T, 1>;
}

template <typename T>
int src_sum_blocks_per_sm(int hd) {
  const DstLayout l = src_sum_layout(sizeof(T), hd);
  return blocks_per_sm(src_sum_kernel<T>(l), l.threads, 0);
}

// The mean out-degree (E / Ns) from which K4's grid holds one group an item,
// the card handing out blocks as earlier ones end, in place of the resident
// blocks striding over the items.  At the flagship's processor and decoder
// sets (8 and 11.8 edges a source) a float32 group's stride runs about 13
// items and the slowest group sets the end: one item a group was 1.8 and
// 2.6 % faster there on an H100, bf16 equal; at its encoder, hex and ICON
// sets (about 1.5 edges a source) the stride's pipelining across items made
// it 4-22 % faster (PERF.md section 6).
constexpr long long kSumFullGridDegree = 4;

// Launches K4: each group strides over the B * Ns items, with at most
// `blocks` blocks (fewer when the groups of fewer cover every item), or one
// group an item from a mean out-degree of kSumFullGridDegree.
template <typename T>
void launch_src_sum(const void* dkv, const int* src_ptr, const int* src_perm, void* dk, void* dv,
                    int batch, int n_src, int n_edges, int hd, int blocks, cudaStream_t stream) {
  const DstLayout l = src_sum_layout(sizeof(T), hd);
  const int groups = l.threads / l.gs;
  const int work = batch * n_src;
  const int needed = (work + groups - 1) / groups;
  const auto kernel = src_sum_kernel<T>(l);
  const bool full = n_edges >= kSumFullGridDegree * n_src;
  kernel<<<full || needed < blocks ? needed : blocks, l.threads, 0, stream>>>(
      static_cast<const T*>(dkv), src_ptr, src_perm, static_cast<T*>(dk), static_cast<T*>(dv),
      n_src, n_edges, hd, work, l.gs);
}

}  // namespace

// Plain C entry points (bound with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// Shapes and types are validated by the Python wrappers.  Each returns the
// cudaError_t of its launches (0 on success).

// Blocks of K3 (kernel = 0), K5 (1) or K4 (2) that fit on the current card
// at once (SMs x occupancy): the grid of K3, the row count of its dW
// partials, K5's grid a batch row and K4's striding grid.  K4 reads only dtype and hd.
extern "C" int gt_attention_bwd_blocks(int kernel, int dtype, int fuse_edge, int hd,
                                       int num_heads, int f, int* blocks) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int d = hd / num_heads;
  const bool fe = fuse_edge != 0;
  int per_sm = 0;
  if (dtype == 0)
    per_sm = kernel == 2   ? src_sum_blocks_per_sm<float>(hd)
             : kernel == 1 ? src_fused_blocks_per_sm<float>(hd, d, f, fe)
                           : dst_blocks_per_sm<float>(hd, d, f, fe);
  else if (dtype == 1)
    per_sm = kernel == 2   ? src_sum_blocks_per_sm<__nv_bfloat16>(hd)
             : kernel == 1 ? src_fused_blocks_per_sm<__nv_bfloat16>(hd, d, f, fe)
                           : dst_blocks_per_sm<__nv_bfloat16>(hd, d, f, fe);
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

// K4, with at most `blocks` blocks below a mean out-degree of
// kSumFullGridDegree.
extern "C" int gt_attention_bwd_src(int dtype, const void* dkv, const void* src_ptr,
                                    const void* src_perm, void* dk, void* dv, int batch,
                                    int n_src, int n_edges, int hd, int blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(src_ptr);
  const int* perm = static_cast<const int*>(src_perm);
  if (n_src > 0 && batch > 0) {
    if (dtype == 0)
      launch_src_sum<float>(dkv, p, perm, dk, dv, batch, n_src, n_edges, hd, blocks, st);
    else if (dtype == 1)
      launch_src_sum<__nv_bfloat16>(dkv, p, perm, dk, dv, batch, n_src, n_edges, hd, blocks, st);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5, with at most `blocks` blocks a batch row.
extern "C" int gt_attention_bwd_src_fused(int dtype, int fuse_edge, const void* q, const void* k,
                                          const void* v, const void* g, const void* lse,
                                          const void* delta, const void* dst, const void* src_ptr,
                                          const void* src_perm, const void* edge, const void* w,
                                          const void* bias, void* dk, void* dv, int batch,
                                          int n_dst, int n_src, int hd, int num_heads, int f,
                                          long long w_sf, long long w_sc, float scale,
                                          int blocks, void* stream) {
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
                              dv, batch, n_dst, n_src, hd, d, f, w_sf, w_sc, scale, blocks, st);
    else if (dtype == 1)
      launch_src_fused<__nv_bfloat16>(fuse_edge != 0, q, k, v, g, l, dl, di, p, perm, edge, w,
                                      bias, dk, dv, batch, n_dst, n_src, hd, d, f, w_sf, w_sc,
                                      scale, blocks, st);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
