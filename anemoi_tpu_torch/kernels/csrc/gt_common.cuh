// Helpers shared by the graph-transformer attention kernels
// (gt_attention_fwd.cu, gt_attention_bwd.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace gt {

constexpr int kMaxEdgeFeatures = 8;  // the fused edge projection's raw width F, at most
// One thread per channel (K4, K5): HD = 1024 (the Transformer preset's
// mappers) gives 1024-thread blocks, which launch only if a thread uses at
// most 64 registers.  The bound makes ptxas keep to that for both.  K1, K2
// and K3 walk destinations in groups of lanes instead (DstLayout below).
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 2^x by the special-function unit (ex2.approx.ftz: relative error below
// 2^-22; results below 2^-126 flush to 0, 2^-inf is 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- destination groups (K1, K2, K3) ---------------------------------------

constexpr int kDstThreads = 256;  // a block: 256 / GS destination groups of GS lanes

// The launch shape of a destination-group kernel for HD, head size d and
// the type's element size: V channels a lane (16 bytes, or 4 or 1 when the
// head is smaller), GS lanes a destination group (HD / V rounded up to a
// power of two at most 32, or to a multiple of 32, so a group is a slice of
// one warp or whole warps), the head butterfly's width `seg` (the largest
// power of two dividing d / V, at most 32; a head wider than that exchanges
// partial sums through the group's shared memory) and the block's threads.
// Each kernel sizes its own shared memory.
struct DstLayout {
  int v, gs, seg, threads;
};

inline DstLayout dst_layout(int elt, int hd, int d) {
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
  return l;
}

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
  // from device memory, through the read-only cache
  __device__ __forceinline__ void load(const T* p) { read<true>(p); }
  // from shared memory
  __device__ __forceinline__ void load_shared(const T* p) { read<false>(p); }
  template <bool kGlobal, typename P>
  __device__ static __forceinline__ P rd(const P* q) {
    if constexpr (kGlobal)
      return __ldg(q);
    else
      return *q;
  }
  template <bool kGlobal>
  __device__ __forceinline__ void read(const T* p) {
    if constexpr (kBytes == 16) {
      const uint4 r = rd<kGlobal>(reinterpret_cast<const uint4*>(p));
      w[0] = r.x, w[1] = r.y, w[2] = r.z, w[3] = r.w;
    } else if constexpr (kBytes == 8) {
      const uint2 r = rd<kGlobal>(reinterpret_cast<const uint2*>(p));
      w[0] = r.x, w[1] = r.y;
    } else if constexpr (kBytes == 4) {
      w[0] = rd<kGlobal>(reinterpret_cast<const unsigned*>(p));
    } else {
      w[0] = rd<kGlobal>(reinterpret_cast<const unsigned short*>(p));
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

// V consecutive elements of T from device to shared memory, asynchronously
// (cp.async; 16, 8 or 4 bytes, both addresses aligned to that).  Two bytes
// (bf16 at V = 1) are below cp.async's smallest size and are copied in
// place.  The copying thread sees the data after cp_async_wait.
template <typename T, int V>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  constexpr int kBytes = V * static_cast<int>(sizeof(T));
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else if constexpr (kBytes >= 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(kBytes)
                 : "memory");
  else
    *dst = *src;
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// ---- one thread per channel (K5) -------------------------------------------

// Sum of x over the d channels of the calling thread's head, returned to
// every thread of the head.  Every thread of the block must call it.
// `partial` holds one float per warp (used only when d > 32).
__device__ __forceinline__ float head_sum(float x, int d, float* partial) {
  if (d <= 32) {
    for (int off = d >> 1; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
  }
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the previous call's reads of `partial` are done
  if ((threadIdx.x & 31) == 0) partial[warp] = x;
  __syncthreads();
  const int warps_per_head = d >> 5;
  const int first = (warp / warps_per_head) * warps_per_head;
  float s = 0.f;
  for (int w = 0; w < warps_per_head; ++w) s += partial[first + w];
  return s;
}

// The thread's column of the edge projection: wc[t] = W[t, c], bc = bias[c]
// (W element (t, c) at t * w_sf + c * w_sc; zeros for inactive threads).
template <typename T>
__device__ __forceinline__ void load_edge_column(const T* w, const T* bias, int c, bool active,
                                                 int f, long long w_sf, long long w_sc,
                                                 float (&wc)[kMaxEdgeFeatures], float& bc) {
#pragma unroll
  for (int t = 0; t < kMaxEdgeFeatures; ++t)
    wc[t] = (active && t < f) ? to_float(w[t * w_sf + c * w_sc]) : 0.f;
  bc = active ? to_float(bias[c]) : 0.f;
}

// Channel c of edge j's feature: attr[j] . W[:, c] + bias[c] when FUSE_EDGE,
// else e[j, c] of the pre-projected [E, HD] edge tensor.
template <typename T, bool FUSE_EDGE>
__device__ __forceinline__ float edge_feature(const T* edge, int j, int c, bool active, int hd,
                                              int f, const float (&wc)[kMaxEdgeFeatures],
                                              float bc) {
  if (FUSE_EDGE) {
    float e = bc;
#pragma unroll
    for (int t = 0; t < kMaxEdgeFeatures; ++t)
      if (t < f) e += to_float(edge[static_cast<size_t>(j) * f + t]) * wc[t];
    return e;
  }
  return active ? to_float(edge[static_cast<size_t>(j) * hd + c]) : 0.f;
}

}  // namespace gt
